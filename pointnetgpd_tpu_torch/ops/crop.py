"""Closing-region crop of the online path, batched over candidates.

Port of the online-path half of ``pointnetgpd_tpu/ops/crop.py``:
``collect_candidate_clouds`` (kinect2grasp.py:216-233 box, with the
``recenter`` training-frame option) over the three exact selection
strategies of ``_crop_batch``:

- prefix rank-select (G >= 32 candidates, P > 4096 points): one scene
  shuffle, then the t-th in-region point by rank;
- two-stage top-k (G < 32, P > 4096): the cloud strided-interleaved into 16
  segments; the JAX package's per-segment top-L followed by a top-k over the
  survivors selects what one stable top-k over the interleaved layout does,
  which is what the port computes;
- direct top-k (P <= 4096).

Random numbers come from a ``draws.Draws``-like object (``crop_perm``,
``crop_windows``, ``crop_keys``, ``crop_ranks``). Frame coordinates round as
the JAX package does on the CPU (``ops/fp.py``), so box membership and
counts agree exactly. The training-crop variants (``collect_grasp_clouds*``)
come in a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from .fp import dot3, fma, lin3, sumsq3

_SEG = 16
_DIRECT_TOPK_MAX = 4096
_PREFIX_MIN_G = 32
_BLK = 128


def _to_frames(pts, centers, rot_rows):
    """(..., P, 3) points -> per-grasp frame coords; pts broadcasts against
    the leading grasp axis of centers (G, 3) / rot_rows (G, 3, 3)."""
    dx = pts[..., 0] - centers[:, 0, None]
    dy = pts[..., 1] - centers[:, 1, None]
    dz = pts[..., 2] - centers[:, 2, None]
    return torch.stack([lin3(dx, rot_rows[:, i, 0, None], dy,
                             rot_rows[:, i, 1, None], dz,
                             rot_rows[:, i, 2, None]) for i in range(3)],
                       dim=-1)


def _in_box(frame, box_lo, box_hi):
    return torch.all((frame > box_lo[:, None]) & (frame < box_hi[:, None]),
                     dim=-1)


def _rank_select_indices(mask, count, num_out: int, draws):
    """(G, P') in-region mask -> (G, num_out) indices of the selected points:
    a random cyclic window of ranks without replacement (count > num_out),
    uniform ranks with replacement otherwise."""
    g, p_pad = mask.shape
    nb = p_pad // _BLK
    dev = mask.device
    prefix = torch.cumsum(mask.to(torch.int32), dim=1)
    pref_blocks = prefix.reshape(g, nb, _BLK)
    incl = pref_blocks[..., -1]
    r, start = draws.crop_windows(count, num_out)
    r, start = r.to(dev).long(), start.to(dev).long()
    cmax = torch.clamp(count, min=1)[:, None]
    window = (start + torch.arange(num_out, device=dev)[None, :]) % cmax
    t = torch.where((count > num_out)[:, None], window + 1, r + 1)
    blk = torch.sum(incl[:, None, :] < t[:, :, None], dim=-1)
    blk = torch.clamp(blk, max=nb - 1)
    sel = pref_blocks[torch.arange(g, device=dev)[:, None], blk]  # (G, N, BLK)
    off = torch.sum(sel < t[..., None], dim=-1)
    idx = torch.clamp(blk * _BLK + off, max=p_pad - 1)
    return torch.where((count > 0)[:, None], idx, 0)


def _crop_batch_prefix(pc, centers, rot_rows, box_lo, box_hi, num_out, draws):
    """Shuffle + prefix-sum rank-select over one shared cloud."""
    p_total = pc.shape[0]
    perm = draws.crop_perm(p_total).to(pc.device).long()
    pcs = pc[perm]
    p_pad = -(-p_total // _BLK) * _BLK
    if p_pad > p_total:
        pcs = torch.cat([pcs, torch.full((p_pad - p_total, 3), 1e9,
                                         dtype=pc.dtype, device=pc.device)])
    mask = _in_box(_to_frames(pcs[None], centers, rot_rows), box_lo, box_hi)
    count = mask.sum(dim=-1)
    idx = _rank_select_indices(mask, count, num_out, draws)
    return _to_frames(pcs[idx], centers, rot_rows), count


def _crop_batch(pc, centers, rot_rows, box_lo, box_hi, num_out: int, draws):
    """Crop + resample for all grasps. pc (P, 3) shared scene cloud; centers
    (G, 3); rot_rows (G, 3, 3) rows [approach, binormal, minor]; box_lo /
    box_hi (G, 3). Returns (points (G, num_out, 3) in grasp frames,
    counts (G,))."""
    g, p_total = centers.shape[0], pc.shape[0]
    if g >= _PREFIX_MIN_G and p_total > _DIRECT_TOPK_MAX:
        return _crop_batch_prefix(pc, centers, rot_rows, box_lo, box_hi,
                                  num_out, draws)
    slot_real = None
    if p_total > _DIRECT_TOPK_MAX:
        # strided interleave (segment s = points s, s+SEG, ...), the layout
        # the selection keys are drawn in
        seg_len = -(-p_total // _SEG)
        perm_np = np.full((_SEG, seg_len), p_total, np.int64)
        for s in range(_SEG):
            run = np.arange(s, p_total, _SEG)
            perm_np[s, :len(run)] = run
        slot_real = torch.as_tensor((perm_np < p_total).reshape(-1),
                                    device=pc.device)
        pc = pc[torch.as_tensor(np.minimum(perm_np.reshape(-1), p_total - 1),
                                device=pc.device)]
    p_len = pc.shape[0]
    mask = _in_box(_to_frames(pc[None], centers, rot_rows), box_lo, box_hi)
    if slot_real is not None:
        mask = mask & slot_real
    count = mask.sum(dim=-1)
    z = draws.crop_keys(g, p_len).to(pc.device)
    z = torch.where(mask, z, -torch.inf)
    kk = min(num_out, p_total)
    perm = torch.sort(z, dim=1, descending=True, stable=True)[1][:, :kk]
    if kk < num_out:
        perm = torch.cat([perm, perm[:, -1:].expand(-1, num_out - kk)], dim=1)
    r = draws.crop_ranks(count, num_out).to(pc.device).long()
    idx = torch.where((count > num_out)[:, None], perm[:, :num_out],
                      torch.gather(perm, 1, torch.clamp(r, max=kk - 1)))
    return _to_frames(pc[idx], centers, rot_rows), count


def _normalize(v):
    return v / torch.sqrt(sumsq3(v))[..., None]


def collect_candidate_clouds(bottom_centers, approaches, binormals,
                             minor_normals, pc, hand_depth, width, draws, *,
                             num_out: int = 500, min_point_limit: int = 10,
                             recenter: bool = False):
    """Online-path crop == batched kinect2grasp.py collect_pc: box x in
    (0, hand_depth), y in +-width/2, z in +-width/4 from the hand bottom
    center. ``recenter=True``: estimate the grasp-center depth as the mean x
    of the in-box points and crop the TRAINING box (x, z in +-width/4, y in
    +-width/2) around it. Returns (points (G, num_out, 3), counts (G,),
    valid (G,))."""
    g = bottom_centers.shape[0]
    dev = pc.device
    if pc.shape[0] == 0:
        return (torch.zeros((g, num_out, 3), dtype=pc.dtype, device=dev),
                torch.zeros((g,), dtype=torch.long, device=dev),
                torch.zeros((g,), dtype=torch.bool, device=dev))
    hd = torch.as_tensor(hand_depth, dtype=torch.float32, device=dev)
    w = torch.as_tensor(width, dtype=torch.float32, device=dev)
    rot_rows = torch.stack([_normalize(approaches), _normalize(binormals),
                            _normalize(minor_normals)], dim=1)   # (G, 3, 3)
    if recenter:
        rel = pc[None, :, :] - bottom_centers[:, None, :]         # (G, P, 3)
        loc = [dot3(rel[..., 0], rot_rows[:, i, 0, None], rel[..., 1],
                    rot_rows[:, i, 1, None], rel[..., 2],
                    rot_rows[:, i, 2, None]) for i in range(3)]
        inref = ((loc[0] > 0) & (loc[0] < hd) & (torch.abs(loc[1]) < w / 2.0)
                 & (torch.abs(loc[2]) < w / 4.0))
        n_in = torch.clamp(inref.sum(dim=1), min=1)
        xbar = torch.where(inref, loc[0], 0.0).sum(dim=1) / n_in
        centers = fma(approaches, xbar[:, None], bottom_centers)
        box_hi = torch.stack([w / 4.0, w / 2.0, w / 4.0]).expand(g, 3)
        box_lo = -box_hi
    else:
        centers = bottom_centers
        box_lo = torch.stack([torch.zeros_like(w), -w / 2.0,
                              -w / 4.0]).expand(g, 3)
        box_hi = torch.stack([hd, w / 2.0, w / 4.0]).expand(g, 3)
    points, counts = _crop_batch(pc, centers, rot_rows, box_lo, box_hi,
                                 num_out, draws)
    valid = counts >= min_point_limit
    points = torch.where(valid[:, None, None], points, 0.0)
    return points, counts, valid
