"""Device-to-host copies per frame: intervals of the scorer's
``score.fetch`` per unit (traced window)."""

from benchmarks.metrics._span_count import per_unit


def read(ctx):
    return per_unit(ctx, "score.fetch")
