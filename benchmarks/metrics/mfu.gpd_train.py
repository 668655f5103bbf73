"""The GPD train steps' counted CNN operations (``counts/gpd.py``: 3 x
73,634,000 a 12-channel sample) over the traced window and the card's
float32 peak (67 TFLOP/s), in %. The float32 peak, not the TF32 one: the
convolutions run with TF32 off, on the CUDA cores."""

from benchmarks.counts import peaks


def read(ctx):
    if ctx.trace is None or not ctx.units:
        return None
    return 100.0 * ctx.cell.flops_done(ctx.units) / ctx.trace.window_s \
        / peaks.FP32_FLOPS
