"""The keyed top-k crop in two launches (kernel K6).

``ops/crop.py`` routes every crop that does not take the prefix route
(``_crop_batch``: fewer than 32 grasps on a shared cloud, every per-grasp
cloud, every cloud of at most 4,096 points) here on a CUDA device
(``takes``); on the CPU it takes ``_keyed_plain``, the kernel's plain
version. Nothing here waits on the device: sizes come from shapes, and the
keyed layout (the strided interleave of clouds above ``DIRECT_MAX`` points)
is enumerated inside the kernel, so nothing is built on the host or
uploaded.

``crop`` launches ``csrc/crop_keyed.cu``'s select kernel (in-box bits, the
counts, an exact radix select of the highest keys in the box, sorted as the
plain version's stable sort orders them), asks ``draws.crop_ranks`` for the
count-dependent ranks, then launches the gather kernel (the selected points
in the grasp frames). Its points and counts equal ``_keyed_plain``'s bit for
bit.
"""

from __future__ import annotations

import torch

from .. import _build

launches = 0             # kernel launches (two per crop)

SEG = 16                 # segments of the strided interleave (csrc/crop_keyed.cu SEG)
DIRECT_MAX = 4096        # clouds up to this many points are keyed directly
SMEM_BYTES = 200 * 1024  # a grasp's row storage kept in shared memory up to
#                          this (csrc/crop_keyed.cu SMEM_BYTES)


def seg_len(p: int) -> int:
    """Positions per segment of the interleave of a p-point cloud; 0 where
    the cloud is keyed directly."""
    return 0 if p <= DIRECT_MAX else -(-p // SEG)


def key_len(p: int) -> int:
    """Positions of the keyed layout of a p-point cloud: one key each."""
    return SEG * seg_len(p) or p


def row_words(p_len: int, kk: int) -> int:
    """32-bit words of one grasp's row storage in the select launch: the
    in-box bits (an even count) and the sort buffer of 64-bit entries
    (csrc/crop_keyed.cu ``row_words``)."""
    n_words = -(-p_len // 32)
    return n_words + (n_words & 1) + 2 * (1 << (max(kk, 1) - 1).bit_length())


def takes(pc) -> bool:
    """Whether the keyed crop of ``pc`` runs on K6: on a CUDA device."""
    return pc.is_cuda


def crop(pc, keys, centers, rot_rows, box_lo, box_hi, num_out: int, draws):
    """K6: pc (P, 3) shared or (G, P, 3) per grasp, keys (G, key_len(P))
    float32 the selection keys, centers (G, 3), rot_rows (G, 3, 3), box_lo,
    box_hi (G, 3) (or shapes that broadcast to these, as in the plain
    version). Returns (points (G, num_out, 3) in the grasp frames, counts
    (G,) int64). Raises on inputs that are not float32 on ``pc``'s device,
    and on an empty cloud, as the plain version fails on one."""
    global launches
    g, p = centers.shape[0], pc.shape[-2]
    for t in (pc, keys, centers, rot_rows, box_lo, box_hi):
        if t.dtype != torch.float32 or t.device != pc.device:
            raise ValueError(f"K6 takes float32 inputs on {pc.device}, got "
                             f"{t.dtype} on {t.device}")
    if p == 0:
        raise ValueError("K6 has no point to select from an empty cloud")
    if pc.dim() == 3 and pc.shape[0] not in (1, g):
        raise ValueError(f"{pc.shape[0]} clouds for {g} grasps")
    p_len = key_len(p)
    if tuple(keys.shape) != (g, p_len):
        raise ValueError(f"keys must be ({g}, {p_len}), got "
                         f"{tuple(keys.shape)}")
    dev = pc.device
    if g == 0:     # no launch; the ranks are drawn as the plain version does
        count = torch.zeros((0,), dtype=torch.int64, device=dev)
        draws.crop_ranks(count, num_out)
        return torch.empty((0, num_out, 3), dtype=torch.float32,
                           device=dev), count
    pc, keys = pc.contiguous(), keys.contiguous()
    # the plain version broadcasts these against the grasp axis
    centers = centers.expand(g, 3).contiguous()
    rot_rows = rot_rows.expand(g, 3, 3).contiguous()
    box_lo = box_lo.expand(g, 3).contiguous()
    box_hi = box_hi.expand(g, 3).contiguous()
    stride = p * 3 if pc.dim() == 3 and pc.shape[0] == g > 1 else 0
    kk = min(num_out, p)
    words = row_words(p_len, kk)
    scratch = (torch.empty((g, words), dtype=torch.int32, device=dev)
               if 4 * words > SMEM_BYTES else None)
    perm = torch.empty((g, kk), dtype=torch.int32, device=dev)
    count = torch.empty((g,), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.library()
    _build.check(lib.crop_keyed_select_launch(
        pc.data_ptr(), stride, p, seg_len(p), g, centers.data_ptr(),
        rot_rows.data_ptr(), box_lo.data_ptr(), box_hi.data_ptr(),
        keys.data_ptr(), kk, None if scratch is None else scratch.data_ptr(),
        perm.data_ptr(), count.data_ptr(), stream),
        "crop_keyed_select_launch")
    launches += 1
    r = draws.crop_ranks(count, num_out).to(dev).long()
    r = r.expand(g, num_out).contiguous()
    out = torch.empty((g, num_out, 3), dtype=torch.float32, device=dev)
    _build.check(lib.crop_keyed_gather_launch(
        pc.data_ptr(), stride, p, seg_len(p), g, centers.data_ptr(),
        rot_rows.data_ptr(), perm.data_ptr(), kk, count.data_ptr(),
        r.data_ptr(), num_out, out.data_ptr(), stream),
        "crop_keyed_gather_launch")
    launches += 1
    return out, count
