"""Host time per unit in the program's ``score.fetch``: the device-to-host
copies of the frame's results, with the host's wait for them (traced
window)."""

from benchmarks.metrics._span import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "score.fetch")
