"""Host time per unit in the program's ``train.adam``: the train step's Adam
update (traced window)."""

from benchmarks.metrics._span import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "train.adam")
