"""Host time per unit in the program's ``gpd.crop``: the GPD step's
per-sample crop of each sample's own cloud (traced window). Nothing where
the program has no such span."""

from benchmarks.metrics._span import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "gpd.crop")
