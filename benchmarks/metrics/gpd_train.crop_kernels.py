"""K6 crops per unit: intervals of the keyed crop's ``crop.keyed`` span (the
GPD step's per-sample crop on the card's kernel) per unit (traced window).
Nothing where the crop took its plain route, or the program has no such
span."""

from benchmarks.metrics._span_count import per_unit


def read(ctx):
    return per_unit(ctx, "crop.keyed")
