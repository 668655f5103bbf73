"""Host time per unit in the program's ``gpd.normals``: the exact k-NN
normals within each crop (traced window). Nothing where the program has no
such span."""

from benchmarks.metrics._span import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "gpd.normals")
