"""GPG shifted-box panel counts: the online sampler's hot loop (kernel K1).

Port of ``pointnetgpd_tpu/ops/gpg_counts_pallas.py``. For every grasp frame
and every shift of a one-axis scan, count the cloud points strictly inside
each of the 4 gripper panel boxes [open, bottom, left, right]
(grasp_sampler.py:1539-1614). Point ``p`` has frame coordinates
``r_a . p - (r_a . seed + fixed_a)``; the scan shifts one axis.

- ``gpg_scan_counts_torch``: the plain PyTorch version, the counterpart of
  ``gpg_scan_counts_jnp``. It rounds as the JAX oracle does on the CPU
  (``ops/fp.py``), so counts agree exactly.
- ``GpgScanContext``: shared per-(cloud, frames) preparation for the three
  scans of one sampler call: the cloud sorted once by Morton code, in tiles
  of ``TILE_POINTS`` with a bounding box each. ``counts`` takes the plain
  version for CPU tensors and launches ``csrc/gpg_counts.cu`` for CUDA
  tensors (or raises).
- The kernel's two decisions, in plain PyTorch for the tests:
  ``tile_slab_mask`` (which tiles a frame visits) and
  ``gpg_scan_counts_ranges`` (counts from sorted-shift runs and a prefix
  sum). ``slab_pair_mask`` marks the (frame, point) pairs that can count at
  all, the work K1's bound is counted over.

Contract (as the JAX context, gpg_counts_pallas.py:182-191): frames outside
``active`` may return 0 instead of their real counts.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .cloud import morton_codes
from .fp import dot3, lin3

TILE_POINTS = 64         # csrc/gpg_counts.cu TILE
MAX_SHIFTS = 32          # csrc/gpg_counts.cu NS_MAX
_FAR = -1.0e6            # cloud padding sentinel (outside every panel box)

launches = 0             # kernel launches (CUDA path only)


def _frame_offsets(seeds, rot_rows, fixed_shift, fixed_axis):
    """(F, 3) ``r_a . seed`` with the fixed shift added on ``fixed_axis``."""
    s = seeds[:, None, :]
    off = dot3(rot_rows[..., 0], s[..., 0], rot_rows[..., 1], s[..., 1],
               rot_rows[..., 2], s[..., 2])
    off = off.clone()
    off[:, fixed_axis] = off[:, fixed_axis] + fixed_shift
    return off


def _frame_coords(points, seeds, rot_rows, fixed_shift, scan_is_y):
    """(C, P) frame coordinates (px, py, pz) of every point, rounded as the
    oracle and the kernel round them."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    off = _frame_offsets(seeds, rot_rows, fixed_shift, 0 if scan_is_y else 1)
    return [lin3(rot_rows[:, i, 0, None], x[None], rot_rows[:, i, 1, None],
                 y[None], rot_rows[:, i, 2, None], z[None]) - off[:, i, None]
            for i in range(3)]


def _as_f32(dev, *tensors):
    return [t.to(dev, torch.float32) for t in tensors]


def gpg_scan_counts_torch(points, seeds, rot_rows, fixed_shift, scan_shifts,
                          boxes, *, scan_is_y: bool, frame_chunk: int = 128):
    """Plain version. points (P, 3); seeds (F, 3); rot_rows (F, 3, 3) rows
    [normal, major, minor]; fixed_shift (F,) on the non-scanned in-frame
    axis (x when scan_is_y, else y); scan_shifts (F, Ns); boxes (4, 2, 3).
    Returns (F, Ns, 4) int32 counts, panel order [open, bottom, left, right].
    Chunked over frames so the (chunk, P) masks bound peak memory."""
    points = points.float()
    dev = points.device
    seeds, rot_rows, fixed_shift, scan_shifts = _as_f32(
        dev, seeds, rot_rows, fixed_shift, scan_shifts)
    bx = torch.as_tensor(np.asarray(boxes, np.float32), device=dev)
    f, ns = seeds.shape[0], scan_shifts.shape[1]
    out = torch.zeros((f, ns, 4), dtype=torch.int32, device=dev)
    for c0 in range(0, f, max(1, frame_chunk)):
        sl = slice(c0, min(c0 + frame_chunk, f))
        px, py, pz = _frame_coords(points, seeds[sl], rot_rows[sl],
                                   fixed_shift[sl], scan_is_y)   # (C, P)
        scanned = py if scan_is_y else px
        sc = scan_shifts[sl]
        for k in range(4):
            lo, hi = bx[k, 0], bx[k, 1]
            base = (pz > lo[2]) & (pz < hi[2])
            if scan_is_y:
                base &= (px > lo[0]) & (px < hi[0])
                lo_s, hi_s = lo[1], hi[1]
            else:
                base &= (py > lo[1]) & (py < hi[1])
                lo_s, hi_s = lo[0], hi[0]
            for n in range(ns):
                c = scanned - sc[:, n, None]
                out[sl, n, k] = torch.sum(base & (c > lo_s) & (c < hi_s),
                                          dim=1).to(torch.int32)
    return out


def gpg_scan_counts_ranges(points, seeds, rot_rows, fixed_shift, scan_shifts,
                           boxes, *, scan_is_y: bool, frame_chunk: int = 16):
    """The kernel's counting scheme in plain PyTorch: per frame, the shifts
    sorted (stable); for each point inside a box's two fixed slabs, the run
    of sorted shifts that counts it, from the first shift with ``d < hi``
    to the first with ``not d > lo`` (``d = scanned - shift`` falls as the
    shift grows, so each predicate holds on one side of its end); +1 / -1
    at the run's ends of a difference array; a prefix sum; the counts
    scattered back to the shift order. Same arguments and result as
    ``gpg_scan_counts_torch``."""
    points = points.float()
    dev = points.device
    seeds, rot_rows, fixed_shift, scan_shifts = _as_f32(
        dev, seeds, rot_rows, fixed_shift, scan_shifts)
    bx = np.asarray(boxes, np.float32)
    f, ns = seeds.shape[0], scan_shifts.shape[1]
    oa, sa = (0, 1) if scan_is_y else (1, 0)
    out = torch.zeros((f, ns, 4), dtype=torch.int32, device=dev)
    for c0 in range(0, f, max(1, frame_chunk)):
        sl = slice(c0, min(c0 + frame_chunk, f))
        c = _frame_coords(points, seeds[sl], rot_rows[sl], fixed_shift[sl],
                          scan_is_y)
        order = torch.argsort(scan_shifts[sl], dim=1, stable=True)
        s_sorted = torch.gather(scan_shifts[sl], 1, order)
        d = c[sa][:, :, None] - s_sorted[:, None, :]           # (C, P, Ns)
        for k in range(4):
            inside = ((c[2] > float(bx[k, 0, 2])) & (c[2] < float(bx[k, 1, 2]))
                      & (c[oa] > float(bx[k, 0, oa]))
                      & (c[oa] < float(bx[k, 1, oa])))
            first = (~(d < float(bx[k, 1, sa]))).sum(-1)
            last = (d > float(bx[k, 0, sa])).sum(-1)
            run = (inside & (first < last)).to(torch.int32)
            diff = torch.zeros((c[2].shape[0], ns + 1), dtype=torch.int32,
                               device=dev)
            diff.scatter_add_(1, first, run)
            diff.scatter_add_(1, last, -run)
            cum = torch.cumsum(diff[:, :ns], dim=1).to(torch.int32)
            out[sl, :, k] = torch.zeros_like(cum).scatter_(1, order, cum)
    return out


def _slab_union(boxes, axis):
    bx = np.asarray(boxes, np.float32)
    return float(bx[:, 0, axis].min()), float(bx[:, 1, axis].max())


def slab_pair_mask(points, seeds, rot_rows, fixed_shift, boxes, *,
                   scan_is_y: bool):
    """(F, P) bool: the point lies strictly inside the union of the 4 boxes
    on both fixed axes (the minor axis and the non-scanned in-plane axis),
    in the plain version's arithmetic. Only these pairs can be counted in
    any box at any shift."""
    points = points.float()
    seeds, rot_rows, fixed_shift = _as_f32(points.device, seeds, rot_rows,
                                           fixed_shift)
    c = _frame_coords(points, seeds, rot_rows, fixed_shift, scan_is_y)
    oa = 0 if scan_is_y else 1
    (lo2, hi2), (loo, hio) = _slab_union(boxes, 2), _slab_union(boxes, oa)
    return (c[2] > lo2) & (c[2] < hi2) & (c[oa] > loo) & (c[oa] < hio)


def tile_slab_mask(tile_box, seeds, rot_rows, fixed_shift, boxes, *,
                   scan_is_y: bool):
    """(F, T) bool: the tiles each frame visits in the kernel. A tile with
    box ``(lo, hi)`` (``tile_box`` (T, 6)) is visited when its range of
    frame coordinates on the minor axis and on the fixed in-plane axis,
    widened by 2^-16 times a bound of every partial sum, meets the union of
    the boxes on that axis (csrc/gpg_counts.cu ``axis_reaches``, in the same
    float32 operations)."""
    tb = tile_box.float()
    seeds, rot_rows, fixed_shift = _as_f32(tb.device, seeds, rot_rows,
                                           fixed_shift)
    oa = 0 if scan_is_y else 1
    off = _frame_offsets(seeds, rot_rows, fixed_shift, oa)       # (F, 3)
    lo, hi = tb[None, :, :3], tb[None, :, 3:]                     # (1, T, 3)
    keep = (tb[:, 0] <= tb[:, 3])[None]                            # (1, T)
    for a in (2, oa):
        r = rot_rows[:, a, None, :]                                # (F, 1, 3)
        pos = r >= 0
        lo_t = torch.where(pos, r * lo, r * hi)
        hi_t = torch.where(pos, r * hi, r * lo)
        size = torch.abs(r) * torch.maximum(torch.abs(lo), torch.abs(hi))
        o = off[:, a, None]
        emin = (lo_t[..., 0] + lo_t[..., 1]) + lo_t[..., 2]
        emax = (hi_t[..., 0] + hi_t[..., 1]) + hi_t[..., 2]
        mag = ((torch.abs(o) + size[..., 0]) + size[..., 1]) + size[..., 2]
        margin = mag * 2.0 ** -16 + 1e-30
        ulo, uhi = _slab_union(boxes, a)
        keep = keep & ((emax - o) + margin > ulo) & ((emin - o) - margin < uhi)
    return keep


def morton_tiles(points):
    """The cloud sorted by Morton code over the real points' box, sentinel
    points last, and the (T, 6) ``[lo, hi]`` box of the real points of each
    tile of ``TILE_POINTS`` (lo > hi for a tile of sentinels only). Counts
    do not depend on point order."""
    dev = points.device
    p = points.shape[0]
    if p == 0:
        return points.contiguous(), torch.empty((0, 6), device=dev)
    inf = float("inf")
    real = points[:, 0] > _FAR * 0.5
    lo = torch.where(real[:, None], points, inf).amin(dim=0)
    hi = torch.where(real[:, None], points, -inf).amax(dim=0)
    some = lo <= hi
    lo, hi = torch.where(some, lo, 0.0), torch.where(some, hi, 0.0)
    code = torch.where(real, morton_codes(points, bbox=(lo, hi)),
                       torch.iinfo(torch.int64).max)
    pts = points[torch.argsort(code, stable=True)].contiguous()
    n_tiles = -(-p // TILE_POINTS)
    pad = torch.full((n_tiles * TILE_POINTS - p, 3), _FAR, device=dev)
    tiles = torch.cat([pts, pad]).reshape(n_tiles, TILE_POINTS, 3)
    real_t = (tiles[..., 0] > _FAR * 0.5)[..., None]
    box = torch.cat([torch.where(real_t, tiles, inf).amin(dim=1),
                     torch.where(real_t, tiles, -inf).amax(dim=1)], dim=1)
    return pts, box.contiguous()


class GpgScanContext:
    """Shared preparation for the three scans (dy, approach, final) of one
    sampler call over the same cloud and frames: ``points`` is the cloud
    sorted by Morton code and ``tile_box`` its per-tile boxes
    (``morton_tiles``), built once for the three scans.

    ``active``: optional (F,) bool — frames whose counts the caller will
    ignore get none computed on the card (their rows are 0). On the CPU the
    plain version counts every frame.
    """

    def __init__(self, points, seeds, rot_rows, boxes, active=None):
        self.points, self.tile_box = morton_tiles(points.to(torch.float32))
        dev = self.points.device
        self.seeds = seeds.to(dev, torch.float32).contiguous()
        self.rot_rows = rot_rows.to(dev, torch.float32).contiguous()
        self.boxes = np.ascontiguousarray(np.asarray(boxes, np.float32))
        self.f = self.seeds.shape[0]
        if active is None:
            active = torch.ones((self.f,), dtype=torch.bool, device=dev)
        self.active = active.to(dev, torch.bool)
        self.active_u8 = self.active.to(torch.uint8).contiguous()
        self.boxes_c = ctypes.cast(
            (ctypes.c_float * 24)(*self.boxes.reshape(-1).tolist()),
            ctypes.c_void_p)

    def counts(self, fixed_shift, scan_shifts, *, scan_is_y: bool):
        """(F, Ns, 4) int32 panel counts for every (frame, shift)."""
        if not self.points.is_cuda:
            return gpg_scan_counts_torch(
                self.points, self.seeds, self.rot_rows, fixed_shift,
                scan_shifts, self.boxes, scan_is_y=scan_is_y)
        return self._launch(fixed_shift, scan_shifts, scan_is_y)

    def kernel_args(self, fixed_shift, scan_shifts, scan_is_y):
        """Check the shifts and prepare one kernel launch. Returns the
        (F, Ns, 4) output (uninitialised: the kernel writes every row), the
        argument tuple of ``gpg_counts_launch`` (None when there is no
        frame) and the tensors that must outlive the launch. No device work
        besides the output's allocation: shift rows may be broadcast
        (stride 0), as the dy and approach scans pass them."""
        dev = self.points.device
        fx, sc = _as_f32(dev, fixed_shift, scan_shifts)
        f, ns = sc.shape
        if f != self.f or fx.shape != (f,):
            raise ValueError(f"shift shapes {tuple(fx.shape)}, "
                             f"{tuple(sc.shape)} do not match {self.f} frames")
        if not 1 <= ns <= MAX_SHIFTS:
            raise ValueError(f"the kernel takes 1..{MAX_SHIFTS} shifts, "
                             f"got {ns}")
        fx = fx.contiguous()
        if ns > 1 and sc.stride(1) != 1:
            sc = sc.contiguous()
        out = torch.empty((f, ns, 4), dtype=torch.int32, device=dev)
        if f == 0:
            return out, None, ()
        args = (self.points.data_ptr(), self.points.shape[0],
                self.tile_box.data_ptr(), self.tile_box.shape[0],
                self.seeds.data_ptr(), self.rot_rows.data_ptr(),
                fx.data_ptr(), sc.data_ptr(), sc.stride(0), f, ns,
                self.active_u8.data_ptr(), self.boxes_c,
                int(bool(scan_is_y)), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        return out, args, (fx, sc)

    def _launch(self, fixed_shift, scan_shifts, scan_is_y):
        global launches
        out, args, _keep = self.kernel_args(fixed_shift, scan_shifts,
                                            scan_is_y)
        if args is None:
            return out
        err = _build.library().gpg_counts_launch(*args)
        _build.check(err, "gpg_counts_launch")
        launches += 1
        return out
