"""The PointNet++ train steps' counted operations (``counts/pointnet2.py``:
3 x 1,675,035,648 a sample at the published widths) over the traced window
and the card's float32 peak (67 TFLOP/s), in %. The float32 peak, not the
TF32 one: the benchmark turns TF32 off."""

from benchmarks.counts import peaks


def read(ctx):
    if ctx.trace is None or not ctx.units:
        return None
    return 100.0 * ctx.cell.flops_done(ctx.units) / ctx.trace.window_s \
        / peaks.FP32_FLOPS
