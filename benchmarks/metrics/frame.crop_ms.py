"""Host time per unit in the program's ``score.crop``: the scorer's crop
(traced window)."""

from benchmarks.metrics._span import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "score.crop")
