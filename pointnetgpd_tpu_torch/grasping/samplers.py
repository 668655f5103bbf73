"""GPG candidate sampling on a raw point cloud (the online path).

Port of ``pointnetgpd_tpu/grasping/samplers.py`` ``gpg_sample_candidates``
(:222-668; the reference's GpgGraspSamplerPcl.sample_grasps,
grasp_sampler.py:1389-1656), single device. Every dy offset, approach step
and the final check is a shifted-box count against one rotation of the
cloud per (seed, theta) frame, computed by ``ops.gpg_counts`` (kernel K1 on
the card, its plain version on the CPU).

Kept from the JAX version: ``seed_bias``, the ``debug`` funnel, the active
frame compaction (frames that cannot be valid are moved behind the others
and get no counts on the card) and the Morton seed order. Seed selection
takes its uniforms from ``draws.seed_uniform``. Neighbor selection is always
exact. The SDF-based samplers come in a later slice.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..draws import Draws
from ..ops.cloud import (extreme_eigvecs_sym3x3, min_k, morton_codes,
                         pairwise_d2, seed_window_normals)
from ..ops.fp import dot3, fma, sumsq3
from ..ops.gpg_counts import GpgScanContext
from .gripper import Gripper, hand_points, panel_box_array


class GpgCandidates(NamedTuple):
    """Packed candidates: rows [bottom_center, approach, binormal(major),
    minor, bottom_center_modified] (grasp_sampler.py:1616-1618)."""

    frames: torch.Tensor  # (N, 5, 3)
    valid: torch.Tensor   # (N,) bool


FUNNEL_STAGES = (
    "frames", "seed_above_table", "frame_estimate", "dy_window",
    "downward_guard", "approach_hit", "open_region", "no_collision")


def _norm(v):
    return torch.sqrt(sumsq3(v))


def _matvec(rot, v):
    """(..., 3, 3) @ (..., 3) as three dot products."""
    return torch.stack([dot3(rot[..., i, 0], v[..., 0], rot[..., i, 1],
                             v[..., 1], rot[..., i, 2], v[..., 2])
                        for i in range(3)], dim=-1)


def _axis_rotations(axis, angles):
    """Rodrigues rotations about unit ``axis`` (S, 3) by ``angles`` (T,) ->
    (S, T, 3, 3): c I + s [axis]x + (1 - c) axis axis^T."""
    c = torch.cos(angles)[None, :, None, None]
    s = torch.sin(angles)[None, :, None, None]
    a0, a1, a2 = axis[:, 0], axis[:, 1], axis[:, 2]
    zero = torch.zeros_like(a0)
    kx = torch.stack([torch.stack([zero, -a2, a1], -1),
                      torch.stack([a2, zero, -a0], -1),
                      torch.stack([-a1, a0, zero], -1)], -2)[:, None]
    outer = (axis[:, :, None] * axis[:, None, :])[:, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return fma(1 - c, outer, fma(c, eye, s * kx))


def gpg_sample_candidates(
    points,
    normals,
    gripper: Gripper = Gripper(),
    *,
    num_seeds: int = 32,
    max_neighbors: int = 100,
    num_dy: int = 10,
    dtheta_deg: int = 10,
    range_dtheta: int = 90,
    approach_step: float = 0.005,
    approach_steps: int = 25,
    safety_dis_above_table: float = 0.01,
    min_points_above_table: float = 0.010,
    min_open_points: int = 10,
    r_ball: float | None = None,
    camera_pos=None,
    bbox=None,
    normal_k: int = 30,
    normal_window: int = 2048,
    seed_bias: str = "none",
    debug: bool = False,
    draws=None,
    seed: int = 0,
):
    """GPG candidate generation, batched over (seed, theta) frames.

    points: (P, 3) scene cloud tensor (table frame, z up, table at z=0); the
        device of ``points`` is where everything runs.
    normals: (P, 3) camera-consistent normals, or None to estimate them
        lazily in the seed windows (``ops.cloud.seed_window_normals``;
        needs ``camera_pos`` and ``normal_window > 0``).
    draws: the source of the seed uniforms (default ``Draws(seed)``).
    Returns ``GpgCandidates`` of num_seeds * n_theta frames in the random
    seed-selection order; with ``debug=True`` also a funnel dict keyed by
    ``FUNNEL_STAGES`` (+ ``seed_heights``).
    """
    dev, dtype = points.device, points.dtype
    p_total = points.shape[0]
    if draws is None:
        draws = Draws(seed, dev)
    hand_pts_local = torch.as_tensor(hand_points(gripper)[1:], dtype=dtype,
                                     device=dev)                  # (20, 3)
    if r_ball is None:
        r_ball = max(gripper.hand_outer_diameter - gripper.finger_width,
                     gripper.hand_depth, gripper.hand_height / 2.0)

    # seeds above the table (kinect2grasp.py:145-147)
    above = points[:, 2] > min_points_above_table
    if seed_bias == "height":
        # Gaussian-over-height Gumbel-top-k (grasp_sampler.py:1040-1046)
        zs = points[:, 2]
        z_lo = torch.where(above, zs, 1e9).amin()
        z_hi = torch.where(above, zs, -1e9).amax()
        ok = z_hi > z_lo
        mid = torch.where(ok, 0.5 * (z_lo + z_hi), 0.0)
        sigma = torch.where(ok, torch.clamp((z_hi - z_lo) / 4.0, min=1e-6),
                            1.0)
        logw = -0.5 * torch.square((zs - mid) / sigma)
        u = draws.seed_uniform(p_total, 1e-12, 1.0 - 1e-7).to(dev)
        z = logw - torch.log(-torch.log(u))
    elif seed_bias == "none":
        z = draws.seed_uniform(p_total).to(dev)
    else:
        raise ValueError(f"unknown seed_bias {seed_bias!r}")
    z = torch.where(above, z, -torch.inf)
    seed_idx = torch.sort(z, descending=True, stable=True)[1][
        :min(num_seeds, p_total)]
    if seed_idx.shape[0] < num_seeds:
        seed_idx = torch.cat([seed_idx, seed_idx[-1:].expand(
            num_seeds - seed_idx.shape[0])])
    seed_ok = above[seed_idx] & (torch.arange(num_seeds, device=dev)
                                 < p_total)

    # Morton-order the seeds so frame blocks are spatially tight (tile
    # pruning); outputs are permuted back to the random order at the end
    morton_perm = torch.argsort(morton_codes(points[seed_idx]), stable=True)
    unsort = torch.argsort(morton_perm, stable=True)
    seed_idx = seed_idx[morton_perm]
    seed_ok = seed_ok[morton_perm]

    thetas = torch.arange(-range_dtheta, range_dtheta + 1, dtheta_deg,
                          dtype=dtype, device=dev) / 180.0 * math.pi
    n_theta = thetas.shape[0]
    dys = torch.arange(-num_dy, num_dy + 1, dtype=dtype,
                       device=dev) * gripper.finger_width
    n_dy = dys.shape[0]

    # r-ball normal covariance -> local frame (grasp_sampler.py:1467-1506)
    seeds_xyz = points[seed_idx]                                  # (S, 3)
    knn = min(max_neighbors, p_total)
    if normals is None:
        if camera_pos is None:
            raise ValueError(
                "gpg_sample_candidates(normals=None) needs camera_pos")
        if normal_window <= 0:
            raise ValueError(
                "gpg_sample_candidates(normals=None) estimates normals "
                "inside seed windows and needs normal_window > 0")
        pd2, nn, seed_normals = seed_window_normals(
            points, seed_idx, camera_pos, k=normal_k, knn=knn,
            window=normal_window, bbox=bbox)
    else:
        pd2, nbr = min_k(pairwise_d2(seeds_xyz, points), knn)
        nn = normals[nbr]
        seed_normals = normals[seed_idx]
    # self-exclusion threshold 1e-8 m^2: the matmul-form d2 carries ~1e-9
    # fp32 cancellation noise at 0.2 m scale
    w = ((pd2 <= r_ball * r_ball) & (pd2 > 1e-8)).to(dtype)
    nn = nn / torch.clamp(_norm(nn), min=1e-12)[..., None]
    m = torch.einsum("sp,spi,spj->sij", w, nn, nn)
    seed_m_ok = torch.sum(torch.abs(m), dim=(1, 2)) > 0
    minor, normal = extreme_eigvecs_sym3x3(m)
    major = torch.linalg.cross(minor, normal)
    major = major / torch.clamp(_norm(major), min=1e-12)[..., None]
    flip = torch.sum(seed_normals * normal, dim=-1) < 0
    normal = torch.where(flip[:, None], -normal, normal)
    minor = torch.where(flip[:, None], -minor, minor)

    # (seed, theta) -> F frames, seed-major; rows [t_normal, t_major, minor]
    rot = _axis_rotations(minor, thetas)                          # (S,T,3,3)
    t_major = _matvec(rot, major[:, None].expand(-1, n_theta, -1))
    t_normal = _matvec(rot, normal[:, None].expand(-1, n_theta, -1))
    rr = torch.stack([t_normal, t_major,
                      minor[:, None].expand(-1, n_theta, -1)], dim=2)
    n_frames = num_seeds * n_theta
    rr = rr.reshape(n_frames, 3, 3)
    seeds_rep = seeds_xyz.repeat_interleave(n_theta, dim=0)       # (F, 3)
    bite = float(gripper.init_bite)
    boxes_np = panel_box_array(gripper)
    m_ok_rep = seed_m_ok.repeat_interleave(n_theta)
    above_rep = seed_ok.repeat_interleave(n_theta)

    # hoist the scan-independent validity (the downward guard reduces to
    # t_normal.z < -0.5) and compact the frame axis: frames that cannot be
    # valid move behind the others and get no counts on the card
    pre_ok = m_ok_rep & above_rep & (rr[:, 0, 2] < -0.5 + 1e-3)
    cperm = torch.argsort((~pre_ok).to(torch.int8), stable=True)
    cunsort = torch.argsort(cperm, stable=True)
    seeds_rep = seeds_rep[cperm]
    rr = rr[cperm]
    m_ok_rep = m_ok_rep[cperm]
    above_rep = above_rep[cperm]
    pre_ok = pre_ok[cperm]

    t_normal, t_major, minor_rep = rr[:, 0], rr[:, 1], rr[:, 2]
    # debug needs real counts for every frame (funnel attribution)
    ctx = GpgScanContext(points, seeds_rep, rr, boxes_np,
                         active=torch.ones_like(pre_ok) if debug else pre_ok)

    # dy scan (grasp_sampler.py:1539-1563): middle valid dy
    c1 = ctx.counts(torch.full((n_frames,), -bite, dtype=dtype, device=dev),
                    dys.expand(n_frames, n_dy), scan_is_y=True)  # (F, dy, 4)
    oks = ((c1[..., 0] > 0) & (c1[..., 1] == 0) & (c1[..., 2] == 0)
           & (c1[..., 3] == 0))
    n_ok = oks.sum(dim=1)
    target = torch.ceil(n_ok / 2.0).to(torch.int32)
    cum = torch.cumsum(oks.to(torch.int32), dim=1)
    pick = torch.argmax(((cum == target[:, None]) & oks).to(torch.int8),
                        dim=1)
    dy_pick = dys[pick]
    base = fma(t_major, dy_pick[:, None], seeds_rep)
    bc = fma(t_normal, -bite, base)

    # downward-grasp guard (grasp_sampler.py:1564-1569)
    finger_top = fma(t_normal, gripper.hand_depth, bc)
    downward = finger_top[:, 2] < bc[:, 2] - gripper.hand_depth * 0.5
    theta_ok = (n_ok > 0) & downward

    # approach along +normal until collision (grasp_sampler.py:1574-1585)
    steps = torch.arange(approach_steps, dtype=dtype,
                         device=dev) * approach_step
    c2 = ctx.counts(dy_pick,
                    (-bite + steps).expand(n_frames, approach_steps),
                    scan_is_y=False)
    collides = (c2[..., 1] > 0) | (c2[..., 2] > 0) | (c2[..., 3] > 0)
    hit = collides.any(dim=1)
    s_hit = steps[torch.argmax(collides.to(torch.int8), dim=1)]
    x_bc2 = (-bite + s_hit) - approach_step * 3.0                 # (F,)
    bc2 = fma(x_bc2[:, None], t_normal, base)

    # table clearance (grasp_sampler.py:1588-1605); world hand points
    hp = hand_pts_local[None, :, :, None]                         # (1,20,3,1)
    r3 = rr[:, None]                                              # (F,1,3,3)
    hp_local = dot3(hp[:, :, 0], r3[..., 0, :], hp[:, :, 1], r3[..., 1, :],
                    hp[:, :, 2], r3[..., 2, :])                   # (F, 20, 3)
    hp_world = bc2[:, None, :] + hp_local
    min_i = torch.argmin(hp_world[..., 2], dim=1)
    min_pos = hp_world[torch.arange(n_frames, device=dev), min_i]  # (F, 3)
    nz_safe = torch.where(torch.abs(t_normal[:, 2]) < 1e-9, 1e-9,
                          t_normal[:, 2])
    tx = -min_pos[:, 2] * t_normal[:, 0] / nz_safe + min_pos[:, 0]
    ty = -min_pos[:, 2] * t_normal[:, 1] / nz_safe + min_pos[:, 1]
    p_table = torch.stack([tx, ty, torch.zeros_like(tx)], dim=1)
    dis_go_back = _norm(min_pos - p_table) + safety_dis_above_table
    need_adjust = min_pos[:, 2] < safety_dis_above_table
    bc_mod = torch.where(need_adjust[:, None],
                         fma(t_normal, -dis_go_back[:, None], bc2), bc2)
    x_mod = x_bc2 - torch.where(need_adjust, dis_go_back, 0.0)

    # final checks (grasp_sampler.py:1607-1614)
    c3 = ctx.counts(dy_pick, x_mod[:, None], scan_is_y=False)[:, 0]
    final_ok = ((c3[:, 0] > min_open_points) & (c3[:, 1] == 0)
                & (c3[:, 2] == 0) & (c3[:, 3] == 0))
    valid = m_ok_rep & theta_ok & hit & final_ok & above_rep & pre_ok
    frames = torch.stack([bc2, t_normal, t_major, minor_rep, bc_mod], dim=1)

    # compaction order -> Morton order -> random seed order
    frames = frames[cunsort].reshape(num_seeds, n_theta, 5, 3)[unsort]
    valid = valid[cunsort].reshape(num_seeds, n_theta)[unsort]
    cands = GpgCandidates(frames.reshape(-1, 5, 3), valid.reshape(-1))
    if not debug:
        return cands
    # per-guard funnel, cumulative in the reference's guard order
    m1 = above_rep
    m2 = m1 & m_ok_rep
    m3 = m2 & (n_ok > 0)
    m4 = m3 & downward
    m5 = m4 & hit
    m6 = m5 & (c3[:, 0] > min_open_points)
    m7 = m6 & (c3[:, 1] == 0) & (c3[:, 2] == 0) & (c3[:, 3] == 0) & pre_ok
    sums = torch.stack([m1, m2, m3, m4, m5, m6, m7], dim=1).sum(dim=0)
    funnel = {"frames": torch.tensor(n_frames, dtype=torch.int32)}
    for i, name in enumerate(FUNNEL_STAGES[1:]):
        funnel[name] = sums[i].to(torch.int32)
    funnel["seed_heights"] = points[seed_idx][unsort][:, 2]
    return cands, funnel
