"""K5 launches per step: intervals of the program's ``normals.kernel`` span
(the GPD features' k-NN normals on the card's kernel) per unit (traced
window). Nothing where the normals took their plain route, or the program
has no such span."""

from benchmarks.metrics._span_count import per_unit


def read(ctx):
    return per_unit(ctx, "normals.kernel")
