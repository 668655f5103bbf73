"""K1 (the GPG panel-count scan) against its roofline in the frame cell:
the bytes its three scans of a frame have to move (counts/gpg.py, from the
real voxel count and the sampler's frames and shifts) over K1's device time
and the HBM bandwidth, in %."""

from benchmarks.counts import peaks
from benchmarks.counts.gpg import frame_bytes

KERNELS = ("gpg_counts_kernel",)


def read(ctx):
    if ctx.trace is None or not ctx.units:
        return None
    busy = ctx.trace.device_s(*KERNELS)
    if busy <= 0:
        return None
    det, g = ctx.traffic["detector"], ctx.traffic["gpg"]
    n_frames = det["max_num_samples"] * (
        2 * g["theta_range_deg"] // g["theta_step_deg"] + 1)
    total = sum(frame_bytes(n, n_frames, 2 * g["num_dy"] + 1,
                            g["approach_steps"])
                for n in ctx.cell.voxel_counts[:ctx.units])
    return 100.0 * total / peaks.HBM_BYTES_PER_S / busy
