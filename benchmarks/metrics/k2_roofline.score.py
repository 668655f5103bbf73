"""K2 (the fused PointNet trunk) against its roofline in the scoring cell:
the two trunks' counted operations for every candidate point of the traced
window over K2's device time and the TF32 peak, in %. K2 splits each
product into three TF32 products, so it can reach a third of this at most.
"""

from benchmarks.counts import peaks
from benchmarks.counts.pointnet import trunk_flops_per_point

KERNELS = ("pointnet_trunk_kernel", "fill_neg_inf")


def read(ctx):
    if ctx.trace is None or not ctx.units:
        return None
    busy = ctx.trace.device_s(*KERNELS)
    if busy <= 0:
        return None
    t = ctx.traffic
    flops = (2 * trunk_flops_per_point() * t["num_points"] * t["candidates"]
             * ctx.units)
    return 100.0 * flops / peaks.TF32_FLOPS / busy
