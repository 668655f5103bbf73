"""Closing-region crops, batched: the online path's and the training path's.

Port of ``pointnetgpd_tpu/ops/crop.py``:

- online: ``collect_candidate_clouds`` (kinect2grasp.py:216-233 box, with
  the ``recenter`` training-frame option);
- training: ``grasp_frame_from_config`` and ``apply_transform_to_frame``
  (the gripper frame of a 10-dim grasp row, dataset.py:16-49),
  ``collect_grasp_clouds`` (G grasps on one shared cloud) and
  ``collect_grasp_clouds_batched`` (sample i crops its own cloud: one
  shuffle shared by the batch, per-sample rank windows), and the
  single-grasp reference path ``crop_closing_region`` /
  ``_masked_resample``.

The shared-cloud crops take one of the three exact selection strategies of
``_crop_batch``:

- prefix rank-select (G >= 32 candidates, P > 4096 points): one scene
  shuffle, then the t-th in-region point by rank; on the card the two
  launches of kernel K4 (``ops/crop_prefix.py``), ``_prefix_plain``
  elsewhere (the per-sample training crop of
  ``collect_grasp_clouds_batched`` takes this route at any G and P);
- two-stage top-k (P > 4096: G < 32 on a shared cloud, or one cloud per
  grasp in ``_crop_batch``): the cloud strided-interleaved into 16
  segments; the JAX package's per-segment top-L followed by a top-k over
  the survivors selects what one stable top-k over the interleaved layout
  does, which is what the port computes;
- direct top-k (P <= 4096).

The last two are the keyed route: on the card the two launches of kernel K6
(``ops/crop_keyed.py``), ``_keyed_plain`` elsewhere.

Random numbers come from a ``draws.Draws``-like object (``crop_perm``,
``crop_windows``, ``crop_keys``, ``crop_ranks``). Frame coordinates round as
the JAX package does on the CPU (``ops/fp.py``), so box membership and
counts agree exactly.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from . import crop_keyed, crop_prefix
from .fp import dot3, fma, lin3, norm3

_DIRECT_TOPK_MAX = crop_keyed.DIRECT_MAX
_PREFIX_MIN_G = 32
_BLK = crop_prefix.BLK


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


def _prefix_plain(pc, perm, centers, rot_rows, box_lo, box_hi,
                  num_out: int, draws):
    """The prefix crop in plain PyTorch: K4's plain version and the CPU
    route. pc (P, 3) shared or (G, P, 3) per grasp, taken in the order of
    the shuffle ``perm`` (P,) and padded to whole blocks with rows far
    away, outside every box."""
    shared = pc.dim() == 2
    p_total = pc.shape[-2]
    pcs = pc[..., perm, :]
    p_pad = crop_prefix.padded(p_total)
    if p_pad > p_total:
        pcs = torch.cat([pcs, torch.full(
            (*pcs.shape[:-2], p_pad - p_total, 3), crop_prefix.PAD,
            dtype=pc.dtype, device=pc.device)], dim=-2)
    mask = _in_box(_to_frames(pcs[None] if shared else pcs, centers,
                              rot_rows), box_lo, box_hi)
    count = mask.sum(dim=-1)
    idx = _rank_select_indices(mask, count, num_out, draws)
    sel = pcs[idx] if shared else pcs[
        torch.arange(pc.shape[0], device=pc.device)[:, None], idx]
    return _to_frames(sel, centers, rot_rows), count


def _crop_batch_prefix(pc, centers, rot_rows, box_lo, box_hi, num_out: int,
                       draws):
    """Shuffle + prefix-sum rank-select over one shared cloud pc (P, 3), or
    grasp g over its own cloud pc[g] (G, P, 3) with one index shuffle shared
    by the batch: K4 on a CUDA device (``crop_prefix.takes``), else the
    plain version."""
    perm = draws.crop_perm(pc.shape[-2]).to(pc.device).long()
    if crop_prefix.takes(pc):
        with span("crop.kernel"):
            return crop_prefix.crop(pc, perm, centers, rot_rows, box_lo,
                                    box_hi, num_out, draws)
    return _prefix_plain(pc, perm, centers, rot_rows, box_lo, box_hi,
                         num_out, draws)


def _keyed_plain(pc, keys, centers, rot_rows, box_lo, box_hi, num_out: int,
                 draws):
    """The keyed top-k crop in plain PyTorch: K6's plain version and the CPU
    route. pc (P, 3) shared or (G, P, 3) per grasp; keys (G,
    crop_keyed.key_len(P)), one per position of the keyed layout: the
    strided interleave (position s * seg_len + i holds point s + SEG i, a
    padding slot past the cloud) above ``DIRECT_MAX`` points, the cloud's
    own order up to it. One stable top-k over that layout selects what the
    JAX package's per-segment top-L and top-k over the survivors select."""
    g, p_total = centers.shape[0], pc.shape[-2]
    shared = pc.dim() == 2
    slot_real = None
    seg_len = crop_keyed.seg_len(p_total)
    if seg_len:
        slot = (torch.arange(crop_keyed.SEG, device=pc.device)[:, None]
                + crop_keyed.SEG * torch.arange(seg_len, device=pc.device)
                ).reshape(-1)
        slot_real = slot < p_total
        pc = pc[..., torch.clamp(slot, max=p_total - 1), :]
    mask = _in_box(_to_frames(pc[None] if shared else pc, centers, rot_rows),
                   box_lo, box_hi)
    if slot_real is not None:
        mask = mask & slot_real
    count = mask.sum(dim=-1)
    z = torch.where(mask, keys, -torch.inf)
    kk = min(num_out, p_total)
    perm = torch.sort(z, dim=1, descending=True, stable=True)[1][:, :kk]
    if kk < num_out:
        perm = torch.cat([perm, perm[:, -1:].expand(-1, num_out - kk)], dim=1)
    r = draws.crop_ranks(count, num_out).to(pc.device).long()
    idx = torch.where((count > num_out)[:, None], perm[:, :num_out],
                      torch.gather(perm, 1, torch.clamp(r, max=kk - 1)))
    sel = pc[idx] if shared else pc[torch.arange(g, device=pc.device)[:, None],
                                    idx]
    return _to_frames(sel, centers, rot_rows), count


def _crop_batch(pc, centers, rot_rows, box_lo, box_hi, num_out: int, draws,
                batch: int | None = None):
    """Crop + resample for all grasps. pc (P, 3) shared scene cloud, or
    (G, P, 3) one cloud per grasp (the per-sample crops of the GPD
    baseline, each the JAX package's G = 1 call, so never the prefix
    branch); centers (G, 3); rot_rows (G, 3, 3) rows [approach, binormal,
    minor]; box_lo / box_hi (G, 3). ``batch``: the grasp count that picks
    the strategy (default G; a shard of a mesh passes the whole batch's).
    The keyed crops run on K6 on a CUDA device (``crop_keyed.takes``), else
    on the plain version. Returns (points (G, num_out, 3) in grasp frames,
    counts (G,))."""
    g, p_total = centers.shape[0], pc.shape[-2]
    if pc.dim() == 2 and (g if batch is None else batch) >= _PREFIX_MIN_G \
            and p_total > _DIRECT_TOPK_MAX:
        return _crop_batch_prefix(pc, centers, rot_rows, box_lo, box_hi,
                                  num_out, draws)
    keys = draws.crop_keys(g, crop_keyed.key_len(p_total)).to(pc.device)
    if crop_keyed.takes(pc):
        with span("crop.keyed"):
            return crop_keyed.crop(pc, keys, centers, rot_rows, box_lo,
                                   box_hi, num_out, draws)
    return _keyed_plain(pc, keys, centers, rot_rows, box_lo, box_hi, num_out,
                        draws)


def _normalize(v):
    return v / norm3(v)[..., None]


# peak bytes of the recenter pre-pass's (chunk, P) temporaries
RECENTER_BYTES = 64 << 20
# (chunk, P) float32 / bool temporaries of one pre-pass chunk: rel (3),
# loc (3), the dot products' float64 intermediates (4 x 2), the masks
_RECENTER_BYTES_PER_PAIR = 4 * (3 + 3 + 8) + 4


def _recenter_depth(pc, bottom_centers, rot_rows, hd, w):
    """The ``recenter`` pre-pass: each candidate's grasp-center depth, the
    mean x of its points inside the reference box, (G,). Streamed over
    chunks of candidates so that its temporaries stay within
    ``RECENTER_BYTES`` (the dense (G, P, 3) form grows with both); each
    candidate's row is reduced whole, so the chunking changes no bit. The
    last chunk is padded to the chunk's size, so every chunk reduces the
    same shape."""
    g, p = bottom_centers.shape[0], pc.shape[0]
    if g == 0:
        return torch.zeros((0,), dtype=pc.dtype, device=pc.device)
    chunk = max(1, min(g, RECENTER_BYTES // (_RECENTER_BYTES_PER_PAIR * p)))
    out = []
    for c0 in range(0, g, chunk):
        sl = torch.arange(c0, c0 + chunk, device=pc.device).clamp(max=g - 1)
        bc, rr = bottom_centers[sl], rot_rows[sl]
        rel = pc[None, :, :] - bc[:, None, :]                  # (chunk, P, 3)
        loc = [dot3(rel[..., 0], rr[:, i, 0, None], rel[..., 1],
                    rr[:, i, 1, None], rel[..., 2], rr[:, i, 2, None])
               for i in range(3)]
        del rel
        inref = ((loc[0] > 0) & (loc[0] < hd) & (torch.abs(loc[1]) < w / 2.0)
                 & (torch.abs(loc[2]) < w / 4.0))
        n_in = torch.clamp(inref.sum(dim=1), min=1)
        xbar = torch.where(inref, loc[0], 0.0).sum(dim=1) / n_in
        out.append(xbar[:min(chunk, g - c0)])
    return torch.cat(out)


def collect_candidate_clouds(bottom_centers, approaches, binormals,
                             minor_normals, pc, hand_depth, width, draws, *,
                             num_out: int = 500, min_point_limit: int = 10,
                             recenter: bool = False, batch: int | None = None):
    """Online-path crop == batched kinect2grasp.py collect_pc: box x in
    (0, hand_depth), y in +-width/2, z in +-width/4 from the hand bottom
    center. ``recenter=True``: estimate the grasp-center depth as the mean x
    of the in-box points and crop the TRAINING box (x, z in +-width/4, y in
    +-width/2) around it. ``batch``: the candidate count that picks the
    selection strategy (default G; see ``_crop_batch``). Returns (points
    (G, num_out, 3), counts (G,), valid (G,))."""
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
        xbar = _recenter_depth(pc, bottom_centers, rot_rows, hd, w)
        centers = fma(approaches, xbar[:, None], bottom_centers)
        box_hi = torch.stack([w / 4.0, w / 2.0, w / 4.0]).expand(g, 3)
        box_lo = -box_hi
    else:
        centers = bottom_centers
        box_lo = torch.stack([torch.zeros_like(w), -w / 2.0,
                              -w / 4.0]).expand(g, 3)
        box_hi = torch.stack([hd, w / 2.0, w / 4.0]).expand(g, 3)
    points, counts = _crop_batch(pc, centers, rot_rows, box_lo, box_hi,
                                 num_out, draws, batch)
    valid = counts >= min_point_limit
    points = torch.where(valid[:, None, None], points, 0.0)
    return points, counts, valid


# --- training crops ----------------------------------------------------------

def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def grasp_frame_from_config(grasps):
    """(G, >=8) grasp rows (10-dim configuration, score columns allowed) ->
    (center, approach, binormal, minor_normal, width), each (G, 3) or (G,).

    The frame math of dataset.py:16-37: binormal = config[3:6] normalized,
    approach = first column of R2 @ R1, R1 rotating by the approach angle
    about the binormal and R2 aligning y with the binormal (x-hat where the
    binormal is +-z)."""
    center, axis = grasps[:, 0:3], grasps[:, 3:6]
    width, angle = grasps[:, 6], grasps[:, 7]
    axis = axis / norm3(axis)[:, None]
    cos_t, sin_t = torch.cos(angle), torch.sin(angle)
    zero = torch.zeros_like(axis[:, 0])
    axis_x = torch.stack([axis[:, 1], -axis[:, 0], zero], dim=1)
    n_x = norm3(axis_x)
    axis_x = torch.where((n_x == 0)[:, None],
                         torch.tensor([1.0, 0.0, 0.0], dtype=grasps.dtype,
                                      device=grasps.device), axis_x)
    axis_x = axis_x / norm3(axis_x)[:, None]
    axis_z = _cross(axis_x, axis)
    # (R2 @ R1)[:, 0] = axis_x cos + axis_y 0 + axis_z sin
    approach = fma(axis_z, sin_t[:, None], axis_x * cos_t[:, None])
    approach = approach / norm3(approach)[:, None]
    minor = _cross(axis, approach)
    return center, approach, axis, minor, width


def apply_transform_to_frame(transforms, center, approach, binormal,
                             minor_normal):
    """(G, 4, 4) homogeneous transforms: the point to the center, the
    rotation to the axes (dataset.py:42-49)."""
    rot = transforms[:, :3, :3]

    def rotate(v):
        return torch.stack([lin3(rot[:, i, 0], v[:, 0], rot[:, i, 1], v[:, 1],
                                 rot[:, i, 2], v[:, 2]) for i in range(3)],
                           dim=1)

    return (rotate(center) + transforms[:, :3, 3], rotate(approach),
            rotate(binormal), rotate(minor_normal))


def _training_frames(grasps, transforms):
    """Per grasp (centers (G, 3), rot_rows (G, 3, 3), box (G, 3)) of the
    training crop: the box x, z in +-width/4, y in +-width/2 around the
    grasp center (dataset.py:50-69)."""
    center, approach, binormal, minor, width = grasp_frame_from_config(
        grasps)
    center, approach, binormal, minor = apply_transform_to_frame(
        transforms, center, approach, binormal, minor)
    rot_rows = torch.stack([approach, binormal, minor], dim=1)
    box = torch.stack([width / 4.0, width / 2.0, width / 4.0], dim=1)
    return center, rot_rows, box


def _masked_resample(points_g, mask, num_out: int, draws):
    """Fixed-size resample of the masked subset of ``points_g`` (P, 3):
    ``num_out`` of the in-region points without replacement when there are
    more, with replacement otherwise (dataset.py:263-268). Returns
    (points (num_out, 3), count)."""
    p_total = points_g.shape[0]
    count = mask.sum()
    z = draws.crop_keys(1, p_total)[0].to(points_g.device)
    z = torch.where(mask, z, -torch.inf)
    kk = min(num_out, p_total)
    perm = torch.sort(z, descending=True, stable=True)[1][:kk]
    if kk < num_out:
        perm = torch.cat([perm, perm[-1:].expand(num_out - kk)])
    r = draws.crop_ranks(count[None], num_out)[0].to(points_g.device).long()
    idx = torch.where(count > num_out, perm[:num_out],
                      perm[torch.clamp(r, max=kk - 1)])
    return points_g[idx], count


def crop_closing_region(grasp_center, rot_rows, box_lo, box_hi, pc,
                        num_out: int, draws):
    """One grasp: ``pc`` (P, 3) into the grasp frame (rows of ``rot_rows``
    [approach, binormal, minor]), the points strictly inside (box_lo,
    box_hi) resampled to ``num_out``. Returns (points, count). The batched
    ``collect_*`` entry points use ``_crop_batch`` instead."""
    pc_t = _to_frames(pc[None], grasp_center[None], rot_rows[None])[0]
    mask = torch.all((pc_t > box_lo) & (pc_t < box_hi), dim=-1)
    return _masked_resample(pc_t, mask, num_out, draws)


def collect_grasp_clouds(grasps, pc, transform, draws, *, num_out: int = 750,
                         min_point_limit: int = 50):
    """Training crop of G grasps (G, >=8) on one cloud pc (P, 3) under one
    (4, 4) transform. Returns (points (G, num_out, 3) in the gripper frames,
    counts (G,), valid (G,) = counts >= min_point_limit)."""
    g = grasps.shape[0]
    centers, rot_rows, box = _training_frames(
        grasps, transform[None].expand(g, 4, 4))
    points, counts = _crop_batch(pc, centers, rot_rows, -box, box, num_out,
                                 draws)
    valid = counts >= min_point_limit
    return torch.where(valid[:, None, None], points, 0.0), counts, valid


def collect_grasp_clouds_percloud(grasps, clouds, transforms, draws, *,
                                  num_out: int = 750,
                                  min_point_limit: int = 50):
    """``collect_grasp_clouds`` of each sample on its own cloud: grasp i
    (B, >=8) on clouds[i] (B, P, 3) under transforms[i], drawn by
    ``draws.per_sample(B)`` (the JAX package's per-sample calls under
    ``split(key, B)``). Returns (points (B, num_out, 3), counts, valid)."""
    centers, rot_rows, box = _training_frames(grasps, transforms)
    points, counts = _crop_batch(clouds, centers, rot_rows, -box, box,
                                 num_out, draws.per_sample(grasps.shape[0]))
    valid = counts >= min_point_limit
    return torch.where(valid[:, None, None], points, 0.0), counts, valid


def collect_grasp_clouds_batched(grasps, clouds, transforms, draws, *,
                                 num_out: int = 750,
                                 min_point_limit: int = 50):
    """Per-sample training crop, batched: sample i crops its own cloud.
    grasps (B, >=8), clouds (B, P, 3), transforms (B, 4, 4). Returns
    (points (B, num_out, 3) in the gripper frames, counts (B,), valid (B,)
    = counts >= min_point_limit)."""
    centers, rot_rows, box = _training_frames(grasps, transforms)
    points, counts = _crop_batch_prefix(
        clouds, centers, rot_rows, -box, box, num_out, draws)
    valid = counts >= min_point_limit
    return torch.where(valid[:, None, None], points, 0.0), counts, valid
