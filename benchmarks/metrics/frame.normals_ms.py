"""Host time per unit in the program's ``frame.normals`` range (traced
window)."""

from benchmarks.metrics._span import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "frame.normals")
