"""Host time per unit in the program's ``train.forward``: the train step's
forward and loss (traced window)."""

from benchmarks.metrics._span import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "train.forward")
