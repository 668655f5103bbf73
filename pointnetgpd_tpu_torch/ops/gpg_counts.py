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
  scans of one sampler call. ``counts`` takes the plain version for CPU
  tensors and launches ``csrc/gpg_counts.cu`` for CUDA tensors (or raises).

Contract (as the JAX context, gpg_counts_pallas.py:182-191): frames outside
``active`` may return 0 instead of their real counts.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .fp import dot3, lin3

FRAMES_PER_BLOCK = 16    # csrc/gpg_counts.cu FB
POINTS_PER_TILE = 1024   # csrc/gpg_counts.cu TILE
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


def gpg_scan_counts_torch(points, seeds, rot_rows, fixed_shift, scan_shifts,
                          boxes, *, scan_is_y: bool, frame_chunk: int = 128):
    """Plain version. points (P, 3); seeds (F, 3); rot_rows (F, 3, 3) rows
    [normal, major, minor]; fixed_shift (F,) on the non-scanned in-frame
    axis (x when scan_is_y, else y); scan_shifts (F, Ns); boxes (4, 2, 3).
    Returns (F, Ns, 4) int32 counts, panel order [open, bottom, left, right].
    Chunked over frames so the (chunk, P) masks bound peak memory."""
    points = points.float()
    dev = points.device
    seeds = seeds.to(dev, torch.float32)
    rot_rows = rot_rows.to(dev, torch.float32)
    fixed_shift = fixed_shift.to(dev, torch.float32)
    scan_shifts = scan_shifts.to(dev, torch.float32)
    bx = torch.as_tensor(np.asarray(boxes, np.float32), device=dev)
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    f, ns = seeds.shape[0], scan_shifts.shape[1]
    fixed_axis = 0 if scan_is_y else 1
    out = torch.zeros((f, ns, 4), dtype=torch.int32, device=dev)
    for c0 in range(0, f, max(1, frame_chunk)):
        sl = slice(c0, min(c0 + frame_chunk, f))
        rr = rot_rows[sl]
        off = _frame_offsets(seeds[sl], rr, fixed_shift[sl], fixed_axis)

        def axis_coord(i):
            return lin3(rr[:, i, 0, None], x[None], rr[:, i, 1, None],
                        y[None], rr[:, i, 2, None], z[None]) - off[:, i, None]

        px, py, pz = axis_coord(0), axis_coord(1), axis_coord(2)   # (C, P)
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


class GpgScanContext:
    """Shared preparation for the three scans (dy, approach, final) of one
    sampler call over the same cloud and frames.

    ``active``: optional (F,) bool — frames whose counts the caller will
    ignore get none computed on the card: a frame block with no active frame
    skips every point tile, and the per-block pruning sphere covers active
    seeds only. On the CPU the plain version counts every frame.
    """

    def __init__(self, points, seeds, rot_rows, boxes, active=None):
        self.points = points.to(torch.float32).contiguous()
        dev = self.points.device
        self.seeds = seeds.to(dev, torch.float32).contiguous()
        self.rot_rows = rot_rows.to(dev, torch.float32).contiguous()
        self.boxes = np.ascontiguousarray(np.asarray(boxes, np.float32))
        self.f = self.seeds.shape[0]
        if active is None:
            active = torch.ones((self.f,), dtype=torch.bool, device=dev)
        self.active = active.to(dev, torch.bool)
        if self.points.is_cuda:
            self._prepare_device()

    def _prepare_device(self):
        dev = self.points.device
        p = self.points.shape[0]
        tp = POINTS_PER_TILE
        n_tiles = max(-(-p // tp), 1)
        pad = torch.full((n_tiles * tp - p, 3), _FAR, device=dev)
        tiles = torch.cat([self.points, pad]).reshape(n_tiles, tp, 3)
        real = (tiles[..., 0] > _FAR * 0.5)[..., None]
        big = torch.tensor(-_FAR, device=dev)
        lo = torch.where(real, tiles, big).amin(dim=1)
        hi = torch.where(real, tiles, -big).amax(dim=1)
        self.tile_box = torch.cat([lo, hi], dim=1).contiguous()  # (T, 6)

        fb = FRAMES_PER_BLOCK
        nfb = max(-(-self.f // fb), 1)
        f_pad = nfb * fb
        sd = torch.zeros((f_pad, 3), device=dev)
        sd[:self.f] = self.seeds
        act = torch.zeros((f_pad,), dtype=torch.bool, device=dev)
        act[:self.f] = self.active
        sdg, actg = sd.reshape(nfb, fb, 3), act.reshape(nfb, fb)
        lo = torch.where(actg[..., None], sdg, 1e9).amin(dim=1)
        hi = torch.where(actg[..., None], sdg, -1e9).amax(dim=1)
        self.any_active = actg.any(dim=1)
        self.ctr = torch.where(self.any_active[:, None], 0.5 * (lo + hi), 0.0)
        dist = torch.linalg.norm(sdg - self.ctr[:, None, :], dim=-1)
        self.seed_r = torch.where(actg, dist, 0.0).amax(dim=1)
        self.active_u8 = act[:self.f].to(torch.uint8).contiguous()
        self.boxes_c = ctypes.cast(
            (ctypes.c_float * 24)(*self.boxes.reshape(-1).tolist()),
            ctypes.c_void_p)
        self.corner = float(np.max(np.linalg.norm(
            np.abs(self.boxes).reshape(-1, 3), axis=-1)))

    def counts(self, fixed_shift, scan_shifts, *, scan_is_y: bool):
        """(F, Ns, 4) int32 panel counts for every (frame, shift)."""
        if not self.points.is_cuda:
            return gpg_scan_counts_torch(
                self.points, self.seeds, self.rot_rows, fixed_shift,
                scan_shifts, self.boxes, scan_is_y=scan_is_y)
        return self._launch(fixed_shift, scan_shifts, scan_is_y)

    def kernel_args(self, fixed_shift, scan_shifts, scan_is_y):
        """Check the shifts and prepare one kernel launch. Returns the
        zeroed (F, Ns, 4) output, the argument tuple of
        ``gpg_counts_launch`` (None when there is nothing to count) and the
        tensors that must outlive the launch."""
        dev = self.points.device
        fx = fixed_shift.to(dev, torch.float32).contiguous()
        sc = scan_shifts.to(dev, torch.float32).contiguous()
        f, ns = sc.shape
        if f != self.f or fx.shape != (f,):
            raise ValueError(f"shift shapes {tuple(fx.shape)}, "
                             f"{tuple(sc.shape)} do not match {self.f} frames")
        if not 1 <= ns <= MAX_SHIFTS:
            raise ValueError(f"the kernel takes 1..{MAX_SHIFTS} shifts, "
                             f"got {ns}")
        out = torch.zeros((f, ns, 4), dtype=torch.int32, device=dev)
        if f == 0 or self.points.shape[0] == 0:
            return out, None, ()
        # per-block pruning sphere: seed sphere + the scan's reach; blocks
        # without an active frame get radius -1 (always skipped)
        reach = (fx.abs().max() + sc.abs().max() + self.corner)
        rad = torch.where(self.any_active, self.seed_r + reach, -1.0)
        spheres = torch.cat([self.ctr, rad[:, None]], dim=1).contiguous()
        args = (self.points.data_ptr(), self.points.shape[0],
                self.seeds.data_ptr(), self.rot_rows.data_ptr(),
                fx.data_ptr(), sc.data_ptr(), f, ns,
                self.active_u8.data_ptr(), spheres.data_ptr(),
                self.tile_box.data_ptr(), self.boxes_c, int(bool(scan_is_y)),
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        return out, args, (fx, sc, spheres)

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
