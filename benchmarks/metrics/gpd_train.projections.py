"""Projection orders per unit: intervals of the program's ``gpd.project``
per unit (traced window; 3 at 12 channels). Nothing where the program has
no such span."""

from benchmarks.metrics._span_count import per_unit


def read(ctx):
    return per_unit(ctx, "gpd.project")
