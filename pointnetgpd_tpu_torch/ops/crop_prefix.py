"""The prefix rank-select crop in two launches (kernel K4).

``ops/crop.py`` routes every prefix crop on a CUDA device here
(``_crop_batch_prefix``, a shared cloud or one cloud per grasp; ``takes``);
on the CPU it takes ``_prefix_plain``, the kernel's plain version. Nothing
here waits on the device: sizes come from shapes.

``crop`` launches ``csrc/crop_prefix.cu``'s count kernel (in-box bits, their
block prefix and the counts), asks ``draws.crop_windows`` for the
count-dependent ranks, then launches the select kernel (the rank-selected
points in the grasp frames). Its points and counts equal ``_prefix_plain``'s
bit for bit.
"""

from __future__ import annotations

import torch

from .. import _build

launches = 0             # kernel launches (two per crop)

BLK = 128                # positions per prefix block (csrc/crop_prefix.cu BLK)
PAD = 1e9                # coordinates of the padding rows past the cloud


def padded(p: int) -> int:
    """The shuffled cloud's length padded to whole prefix blocks."""
    return -(-p // BLK) * BLK


def takes(pc) -> bool:
    """Whether the prefix crop of ``pc`` runs on K4: on a CUDA device."""
    return pc.is_cuda


def crop(pc, perm, centers, rot_rows, box_lo, box_hi, num_out: int, draws):
    """K4: pc (P, 3) shared or (G, P, 3) per grasp, perm (P,) int64 the
    shuffle, centers (G, 3), rot_rows (G, 3, 3), box_lo, box_hi (G, 3) (or
    shapes that broadcast to these, as in the plain version).
    Returns (points (G, num_out, 3) in the grasp frames, counts (G,) int64).
    Raises on inputs that are not float32 on ``pc``'s device, and on an
    empty cloud, as the plain version fails on one."""
    global launches
    g, p = centers.shape[0], pc.shape[-2]
    for t in (pc, centers, rot_rows, box_lo, box_hi):
        if t.dtype != torch.float32 or t.device != pc.device:
            raise ValueError(f"K4 takes float32 inputs on {pc.device}, got "
                             f"{t.dtype} on {t.device}")
    if p == 0:
        raise ValueError("K4 has no point to select from an empty cloud")
    if pc.dim() == 3 and pc.shape[0] not in (1, g):
        raise ValueError(f"{pc.shape[0]} clouds for {g} grasps")
    if tuple(perm.shape) != (p,) or perm.dtype != torch.int64:
        raise ValueError(f"perm must be ({p},) int64, got "
                         f"{tuple(perm.shape)} {perm.dtype}")
    dev = pc.device
    p_pad = padded(p)
    if g == 0:     # no launch; the windows are drawn as the plain version does
        count = torch.zeros((0,), dtype=torch.int64, device=dev)
        draws.crop_windows(count, num_out)
        return torch.empty((0, num_out, 3), dtype=torch.float32,
                           device=dev), count
    pc, perm = pc.contiguous(), perm.contiguous()
    # the plain version broadcasts these against the grasp axis
    centers = centers.expand(g, 3).contiguous()
    rot_rows = rot_rows.expand(g, 3, 3).contiguous()
    box_lo = box_lo.expand(g, 3).contiguous()
    box_hi = box_hi.expand(g, 3).contiguous()
    stride = p * 3 if pc.dim() == 3 and pc.shape[0] == g > 1 else 0
    bits = torch.empty((g, p_pad // 32), dtype=torch.int32, device=dev)
    incl = torch.empty((g, p_pad // BLK), dtype=torch.int32, device=dev)
    count = torch.empty((g,), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.library()
    _build.check(lib.crop_count_launch(
        pc.data_ptr(), stride, perm.data_ptr(), p, p_pad, g,
        centers.data_ptr(), rot_rows.data_ptr(), box_lo.data_ptr(),
        box_hi.data_ptr(), bits.data_ptr(), incl.data_ptr(),
        count.data_ptr(), stream), "crop_count_launch")
    launches += 1
    r, start = draws.crop_windows(count, num_out)
    r = r.to(dev).long().expand(g, num_out).contiguous()
    start = start.to(dev).long().expand(g, 1).contiguous()
    out = torch.empty((g, num_out, 3), dtype=torch.float32, device=dev)
    _build.check(lib.crop_select_launch(
        pc.data_ptr(), stride, perm.data_ptr(), p, p_pad, g,
        centers.data_ptr(), rot_rows.data_ptr(), bits.data_ptr(),
        incl.data_ptr(), count.data_ptr(), r.data_ptr(), start.data_ptr(),
        num_out, out.data_ptr(), stream), "crop_select_launch")
    launches += 1
    return out, count
