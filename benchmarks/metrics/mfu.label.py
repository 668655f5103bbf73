"""The labeling rounds' counted operations (``counts/label.py``: per
attempt a surface normal, four contact searches' lookups and the ladder's
closure tests) over the traced window and the card's float32 peak (67
TFLOP/s), in %: the path runs on the CUDA cores, in float32 and float64."""

from benchmarks.counts import peaks


def read(ctx):
    if ctx.trace is None or not ctx.units:
        return None
    return 100.0 * ctx.cell.flops_done(ctx.units) / ctx.trace.window_s \
        / peaks.FP32_FLOPS
