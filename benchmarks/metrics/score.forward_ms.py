"""Host time per unit in the program's ``score.forward``: the scorer's
resample, model, softmax and vote (traced window)."""

from benchmarks.metrics._span import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "score.forward")
