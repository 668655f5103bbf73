"""Host time per unit in the program's ``gpd.project``, all of its
intervals: the projection images, one interval per axis order (traced
window). Nothing where the program has no such span."""

from benchmarks.metrics._span import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "gpd.project")
