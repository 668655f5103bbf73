"""K7 launches per step: intervals of the program's ``pn2.kernel`` span (a
farthest-point sample or a ball query on the card's kernel) per unit
(traced window; 4.0 on the card). Nothing where sampling took its plain
route, or the program has no such span."""

from benchmarks.metrics._span_count import per_unit


def read(ctx):
    return per_unit(ctx, "pn2.kernel")
