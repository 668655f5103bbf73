"""Shares of the chip's published peaks over the traced window."""

from benchmarks.counts import peaks


def mfu(ctx):
    """Counted model operations of the window's units over the window's
    length and the TF32 peak, in %."""
    if ctx.trace is None or not ctx.units:
        return None
    flops = ctx.cell.flops_done(ctx.units)
    return 100.0 * flops / ctx.trace.window_s / peaks.TF32_FLOPS


def idle(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
