"""Host time per unit in the program's ``cloud.window_normals``: the lazy seed-
window normals (traced window)."""

from benchmarks.metrics._span import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "cloud.window_normals")
