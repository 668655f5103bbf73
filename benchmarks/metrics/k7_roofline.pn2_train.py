"""K7 (PointNet++ sampling and grouping) against its roofline in the
PointNet++ train cell: its least time for the traced window's batches
(``counts/pointnet2.py`` ``k7_bound_s``: FPS by float32 instructions, the
ball query by bytes) over the device time of its two kernels, in %."""

from benchmarks.counts.pointnet2 import k7_bound_s

KERNELS = ("pn2_fps_kernel", "pn2_ball_query_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.units:
        return None
    busy = ctx.trace.device_s(*KERNELS)
    if busy <= 0:
        return None
    bound = k7_bound_s(ctx.config, ctx.traffic["batch"]) * ctx.units
    return 100.0 * bound / busy
