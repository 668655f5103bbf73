"""Host time per unit in the program's ``pn2.group``: every ball query with
its gathers and centring in the PointNet++ forward, SA1's and SA2's (traced
window). Nothing where the program has no such span."""

from benchmarks.metrics._span import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "pn2.group")
