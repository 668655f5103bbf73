"""The whole unit's counted PointNet operations over the traced window and
the TF32 peak (495 TFLOP/s), in %."""

from benchmarks.metrics._share import mfu


def read(ctx):
    return mfu(ctx)
