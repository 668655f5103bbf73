"""Host time per unit in the program's ``train.backward``: the train step's
backward (traced window)."""

from benchmarks.metrics._span import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "train.backward")
