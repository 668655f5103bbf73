"""Host time per unit in the program's ``pn2.fps``: every farthest-point
sample of the PointNet++ forward, SA1's and SA2's (traced window). Nothing
where the program has no such span."""

from benchmarks.metrics._span import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "pn2.fps")
