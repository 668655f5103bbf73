"""Self time per frame of the program's ``frame.process``: its length less
the union of the stage ranges inside it (traced window). Host time that
no stage range names."""

from benchmarks.metrics._self import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "frame.process")
