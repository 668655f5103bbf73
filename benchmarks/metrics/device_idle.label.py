"""Share of the traced window in which no kernel, copy or fill ran on the
card, in %."""

from benchmarks.metrics._share import idle


def read(ctx):
    return idle(ctx)
