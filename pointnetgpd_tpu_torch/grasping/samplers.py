"""Grasp candidate samplers: fixed-budget batched rejection sampling.

Port of ``pointnetgpd_tpu/grasping/samplers.py`` (reference:
dex-net/src/dexnet/grasping/grasp_sampler.py), single device. Each sampler
evaluates a fixed budget of attempts as one batched call and returns the
attempts with a validity mask; retries are a host loop (``sample_until``).

- ``antipodal_sample_grasps``: the dataset sampler (AntipodalGraspSampler,
  grasp_sampler.py:621-803).
- ``uniform_sample_grasps`` / ``gaussian_sample_grasps``: random surface
  pairs / Gaussian centers (grasp_sampler.py:459-618).
- ``gpg_sample_candidates``: GPG on a raw point cloud, the online path
  (GpgGraspSamplerPcl.sample_grasps, grasp_sampler.py:1389-1656). Every dy
  offset, approach step and the final check is a shifted-box count against
  one rotation of the cloud per (seed, theta) frame, computed by
  ``ops.gpg_counts`` (kernel K1 on the card, its plain version on the CPU).
  Kept from the JAX version: ``seed_bias``, the ``debug`` funnel, the
  active frame compaction and the Morton seed order; neighbor selection is
  always exact. Its stages carry ``utils.profiling.span`` ranges:
  ``gpg.seeds``, ``gpg.local_frames`` (holding ``cloud.window_normals``),
  ``gpg.compact``, ``gpg.tiles``, ``gpg.dy``, ``gpg.approach``,
  ``gpg.final`` and ``gpg.unsort``.
- ``gpg_sample_grasps_sdf`` / ``point_sample_grasps_sdf``: the same GPG loop
  on an SDF's surface (grasp_sampler.py:806-1170), so they launch K1 too.

Every draw comes from a ``draws.Draws`` method. Reference quirk kept: the
approach angles are drawn from {-90..90 step 30} and used as radians
(grasp_sampler.py:757-761).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..draws import Draws
from ..geometry import sdf as sdf_lib
from ..ops.cloud import (extreme_eigvecs_sym3x3, min_k, morton_codes,
                         pairwise_d2, seed_window_normals)
from ..ops.fp import dot3, f64, fma, norm3
from ..ops.gpg_counts import GpgScanContext
from ..utils.profiling import span
from . import quality
from .grasp import (approach_collision_free, close_fingers,
                    grasp_from_contact_and_axis, perpendicular_table)
from .gripper import Gripper, hand_points, panel_box_array

APPROACH_ANGLE_CANDIDATES = np.arange(-90, 120, 30).astype(np.float32)


class SampledGrasps(NamedTuple):
    configs: torch.Tensor   # (N, 10) grasp configurations
    contacts: torch.Tensor  # (N, 2, 3) contact points
    normals: torch.Tensor   # (N, 2, 3) outward contact normals
    valid: torch.Tensor     # (N,) bool


class GpgCandidates(NamedTuple):
    """Packed candidates: rows [bottom_center, approach, binormal(major),
    minor, bottom_center_modified] (grasp_sampler.py:1616-1618)."""

    frames: torch.Tensor  # (N, 5, 3)
    valid: torch.Tensor   # (N,) bool


FUNNEL_STAGES = (
    "frames", "seed_above_table", "frame_estimate", "dy_window",
    "downward_guard", "approach_hit", "open_region", "no_collision")


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


def _covariance_frames(points, normals, seed_idx, seeds_xyz, knn, r_ball,
                       camera_pos, normal_k, normal_window, bbox):
    """r-ball normal covariance -> per-seed local frame
    (grasp_sampler.py:1467-1506): (frame ok, normal, major, minor)."""
    if normals is None:
        if camera_pos is None:
            raise ValueError(
                "gpg_sample_candidates(normals=None) needs camera_pos")
        if normal_window <= 0:
            raise ValueError(
                "gpg_sample_candidates(normals=None) estimates normals "
                "inside seed windows and needs normal_window > 0")
        with span("cloud.window_normals"):
            pd2, nn, seed_normals = seed_window_normals(
                points, seed_idx, camera_pos, k=normal_k, knn=knn,
                window=normal_window, bbox=bbox)
    else:
        pd2, nbr = min_k(pairwise_d2(seeds_xyz, points), knn)
        nn = normals[nbr]
        seed_normals = normals[seed_idx]
    # self-exclusion threshold 1e-8 m^2: the matmul-form d2 carries ~1e-9
    # fp32 cancellation noise at 0.2 m scale
    w = ((pd2 <= r_ball * r_ball) & (pd2 > 1e-8)).to(points.dtype)
    nn = nn / torch.clamp(norm3(nn), min=1e-12)[..., None]
    m = torch.einsum("sp,spi,spj->sij", w, nn, nn)
    m_ok = torch.sum(torch.abs(m), dim=(1, 2)) > 0
    minor, normal = extreme_eigvecs_sym3x3(m)
    major = torch.linalg.cross(minor, normal)
    major = major / torch.clamp(norm3(major), min=1e-12)[..., None]
    flip = torch.sum(seed_normals * normal, dim=-1) < 0
    normal = torch.where(flip[:, None], -normal, normal)
    minor = torch.where(flip[:, None], -minor, minor)
    return m_ok, normal, major, minor


def _frames_block(points, seeds_rep, rr, m_ok_rep, above_rep, pre_ok, *,
                  gripper, boxes_np, hand_pts_local, dys, bite, approach_step,
                  approach_steps, safety_dis_above_table, min_open_points,
                  debug):
    """The three scans and the per-frame glue for a block of frames (each
    frame independent given the cloud): (frames (F, 5, 3), valid (F,),
    stages (F, 7): with ``debug`` the per-guard funnel masks, cumulative in
    the reference's guard order).""" 
    dev, dtype = points.device, points.dtype
    n_frames, n_dy = seeds_rep.shape[0], dys.shape[0]
    t_normal, t_major, minor_rep = rr[:, 0], rr[:, 1], rr[:, 2]
    # debug needs real counts for every frame (funnel attribution)
    with span("gpg.tiles"):
        ctx = GpgScanContext(points, seeds_rep, rr, boxes_np,
                             active=torch.ones_like(pre_ok) if debug
                             else pre_ok)
    # dy scan (grasp_sampler.py:1539-1563): middle valid dy
    with span("gpg.dy"):
        c1 = ctx.counts(torch.full((n_frames,), -bite, dtype=dtype,
                                   device=dev),
                        dys.expand(n_frames, n_dy), scan_is_y=True)  # (F,dy,4)
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
    with span("gpg.approach"):
        steps = torch.arange(approach_steps, dtype=dtype,
                             device=dev) * approach_step
        c2 = ctx.counts(dy_pick,
                        (-bite + steps).expand(n_frames, approach_steps),
                        scan_is_y=False)
        collides = (c2[..., 1] > 0) | (c2[..., 2] > 0) | (c2[..., 3] > 0)
        hit = collides.any(dim=1)
        s_hit = steps[torch.argmax(collides.to(torch.int8), dim=1)]
        x_bc2 = (-bite + s_hit) - approach_step * 3.0             # (F,)
        bc2 = fma(x_bc2[:, None], t_normal, base)

        # table clearance (grasp_sampler.py:1588-1605); world hand points
        hp = hand_pts_local[None, :, :, None]                     # (1,20,3,1)
        r3 = rr[:, None]                                          # (F,1,3,3)
        hp_local = dot3(hp[:, :, 0], r3[..., 0, :], hp[:, :, 1],
                        r3[..., 1, :], hp[:, :, 2], r3[..., 2, :])  # (F,20,3)
        hp_world = bc2[:, None, :] + hp_local
        min_i = torch.argmin(hp_world[..., 2], dim=1)
        min_pos = hp_world[torch.arange(n_frames, device=dev), min_i]  # (F,3)
        nz_safe = torch.where(torch.abs(t_normal[:, 2]) < 1e-9, 1e-9,
                              t_normal[:, 2])
        tx = -min_pos[:, 2] * t_normal[:, 0] / nz_safe + min_pos[:, 0]
        ty = -min_pos[:, 2] * t_normal[:, 1] / nz_safe + min_pos[:, 1]
        p_table = torch.stack([tx, ty, torch.zeros_like(tx)], dim=1)
        dis_go_back = norm3(min_pos - p_table) + safety_dis_above_table
        need_adjust = min_pos[:, 2] < safety_dis_above_table
        bc_mod = torch.where(need_adjust[:, None],
                             fma(t_normal, -dis_go_back[:, None], bc2), bc2)
        x_mod = x_bc2 - torch.where(need_adjust, dis_go_back, 0.0)

    # final checks (grasp_sampler.py:1607-1614)
    with span("gpg.final"):
        c3 = ctx.counts(dy_pick, x_mod[:, None], scan_is_y=False)[:, 0]
        final_ok = ((c3[:, 0] > min_open_points) & (c3[:, 1] == 0)
                    & (c3[:, 2] == 0) & (c3[:, 3] == 0))
        valid = m_ok_rep & theta_ok & hit & final_ok & above_rep & pre_ok
        frames = torch.stack([bc2, t_normal, t_major, minor_rep, bc_mod],
                             dim=1)
        if not debug:
            return frames, valid, valid[:, None]
        m1 = above_rep
        m2 = m1 & m_ok_rep
        m3 = m2 & (n_ok > 0)
        m4 = m3 & downward
        m5 = m4 & hit
        m6 = m5 & (c3[:, 0] > min_open_points)
        m7 = (m6 & (c3[:, 1] == 0) & (c3[:, 2] == 0) & (c3[:, 3] == 0)
              & pre_ok)
        return frames, valid, torch.stack([m1, m2, m3, m4, m5, m6, m7],
                                          dim=1)


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
    point_frames=None,
    seed_chunk: int = 8,
    mesh=None,
    exact: bool = False,
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
    point_frames: optional (P, 3, 3) per-point [normal, major, minor] frames
        (e.g. SDF curvature frames) that replace the r-ball covariance
        estimate.
    draws: the source of the seed uniforms (default ``Draws(seed)``).
    mesh: a ``parallel.mesh.Mesh`` (JAX ``:258``, ``:630-670``): the frame
        axis is split over its shards after every draw, each shard's three
        scans run on its device (K1 launches 3 times per shard), and the
        frames are gathered once.
    seed_chunk, exact: the JAX package's keywords, accepted and no-ops.
        JAX's ``seed_chunk`` bounds the peak memory of its CPU fallback
        scan and ``exact`` forces exact top-k in its seed windows; here the
        frames are counted by K1 (or its plain version) in one batch and
        neighbor selection is always exact (``ops.cloud.min_k``).
    Returns ``GpgCandidates`` of num_seeds * n_theta frames in the random
    seed-selection order; with ``debug=True`` also a funnel dict keyed by
    ``FUNNEL_STAGES`` (+ ``seed_heights``).
    """
    dev, dtype = points.device, points.dtype
    p_total = points.shape[0]
    if draws is None:
        draws = Draws(seed, dev)
    with span("gpg.seeds"):
        hand_pts_local = torch.as_tensor(hand_points(gripper)[1:],
                                         dtype=dtype, device=dev)  # (20, 3)
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
            sigma = torch.where(ok, torch.clamp((z_hi - z_lo) / 4.0,
                                                min=1e-6), 1.0)
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
        # pruning); outputs are permuted back to the random order at the
        # end
        morton_perm = torch.argsort(morton_codes(points[seed_idx]),
                                    stable=True)
        unsort = torch.argsort(morton_perm, stable=True)
        seed_idx = seed_idx[morton_perm]
        seed_ok = seed_ok[morton_perm]

        thetas = torch.arange(-range_dtheta, range_dtheta + 1, dtheta_deg,
                              dtype=dtype, device=dev) / 180.0 * math.pi
        n_theta = thetas.shape[0]
        dys = torch.arange(-num_dy, num_dy + 1, dtype=dtype,
                           device=dev) * gripper.finger_width
        n_dy = dys.shape[0]

    with span("gpg.local_frames"):
        seeds_xyz = points[seed_idx]                              # (S, 3)
        if point_frames is not None:
            seed_frames = point_frames[seed_idx]                  # (S, 3, 3)
            seed_m_ok = norm3(seed_frames[:, 0]) > 0.5
            normal, major, minor = seed_frames.unbind(dim=1)
        else:
            seed_m_ok, normal, major, minor = _covariance_frames(
                points, normals, seed_idx, seeds_xyz,
                min(max_neighbors, p_total), r_ball, camera_pos, normal_k,
                normal_window, bbox)

    with span("gpg.compact"):
        # (seed, theta) -> F frames, seed-major; rows [t_normal, t_major,
        # minor]
        rot = _axis_rotations(minor, thetas)                      # (S,T,3,3)
        t_major = _matvec(rot, major[:, None].expand(-1, n_theta, -1))
        t_normal = _matvec(rot, normal[:, None].expand(-1, n_theta, -1))
        rr = torch.stack([t_normal, t_major,
                          minor[:, None].expand(-1, n_theta, -1)], dim=2)
        n_frames = num_seeds * n_theta
        rr = rr.reshape(n_frames, 3, 3)
        seeds_rep = seeds_xyz.repeat_interleave(n_theta, dim=0)   # (F, 3)
        bite = float(gripper.init_bite)
        m_ok_rep = seed_m_ok.repeat_interleave(n_theta)
        above_rep = seed_ok.repeat_interleave(n_theta)

        # hoist the scan-independent validity (the downward guard reduces
        # to t_normal.z < -0.5) and compact the frame axis: frames that
        # cannot be valid move behind the others and get no counts on the
        # card. With a mesh, the active frames go round-robin over the
        # shards (JAX's two-key sort), so each shard keeps an equal share of
        # the scan work
        ndev = 1 if mesh is None else mesh.size
        pre_ok = m_ok_rep & above_rep & (rr[:, 0, 2] < -0.5 + 1e-3)
        key = (~pre_ok).to(torch.int64)
        if ndev > 1:
            ri = torch.where(pre_ok, torch.cumsum(pre_ok, 0) - 1,
                             torch.cumsum(~pre_ok, 0) - 1)
            key = (ri % ndev) * 2 + key
        cperm = torch.argsort(key, stable=True)
        cunsort = torch.argsort(cperm, stable=True)
        seeds_rep = seeds_rep[cperm]
        rr = rr[cperm]
        m_ok_rep = m_ok_rep[cperm]
        above_rep = above_rep[cperm]
        pre_ok = pre_ok[cperm]

        block = dict(gripper=gripper, boxes_np=panel_box_array(gripper),
                     hand_pts_local=hand_pts_local, dys=dys, bite=bite,
                     approach_step=approach_step,
                     approach_steps=approach_steps,
                     safety_dis_above_table=safety_dis_above_table,
                     min_open_points=min_open_points, debug=debug)

    if mesh is None:
        frames, valid, stages = _frames_block(
            points, seeds_rep, rr, m_ok_rep, above_rep, pre_ok, **block)
    else:
        # frames are independent given the replicated cloud: split the
        # frame axis after every draw; pad frames carry above_rep = False
        # and identity rotations (JAX :646-663)
        from ..parallel import mesh as pmesh

        f_pad = pmesh.pad_to_multiple(n_frames, ndev)
        eye = torch.eye(3, dtype=dtype, device=dev).expand(
            f_pad - n_frames, 3, 3)
        parts = [pmesh.shard_batch(t, mesh) for t in
                 (seeds_rep, torch.cat([rr, eye]), m_ok_rep, above_rep,
                  pre_ok)]
        frames, valid, stages = pmesh.gather(pmesh.run_shards(
            mesh, lambda s, pts, *a: _frames_block(pts, *a, **block),
            pmesh.replicate(points, mesh), *parts), dev)
        frames, valid, stages = (frames[:n_frames], valid[:n_frames],
                                 stages[:n_frames])

    with span("gpg.unsort"):
        # compaction order -> Morton order -> random seed order
        frames = frames[cunsort].reshape(num_seeds, n_theta, 5, 3)[unsort]
        valid = valid[cunsort].reshape(num_seeds, n_theta)[unsort]
        cands = GpgCandidates(frames.reshape(-1, 5, 3), valid.reshape(-1))
        if not debug:
            return cands
        sums = stages.sum(dim=0)
        funnel = {"frames": torch.tensor(n_frames, dtype=torch.int32)}
        for i, name in enumerate(FUNNEL_STAGES[1:]):
            funnel[name] = sums[i].to(torch.int32)
        funnel["seed_heights"] = points[seed_idx][unsort][:, 2]
        return cands, funnel


# ---------------------------------------------------------------------------
# Antipodal / uniform / Gaussian samplers on an SDF (dataset generation)
# ---------------------------------------------------------------------------

def _empty_sampled(n, dev):
    z3 = torch.zeros((n, 2, 3), device=dev)
    return SampledGrasps(torch.zeros((n, 10), device=dev), z3, z3,
                         torch.zeros((n,), dtype=torch.bool, device=dev))


def antipodal_sample_grasps(
    sdf: sdf_lib.SdfGrid,
    draws=None,
    *,
    max_width: float,
    min_width: float = 0.0,
    friction_coef: float = 2.0,
    min_contact_dist: float = 0.0025,
    num_attempts: int = 256,
    num_samples_loa: int = 40,
    random_approach_angle: bool = True,
    seed: int = 0,
) -> SampledGrasps:
    """One fixed-budget batch of antipodal rejection sampling
    (grasp_sampler.py:689-803) on the SDF's device: a random surface point,
    an axis drawn in its friction cone, both fingers closed along it, and
    the first collision-free approach angle of a shuffled candidate list;
    valid where the pair is force closure at ``friction_coef``. ``draws``:
    the source of the draws (default ``Draws(seed)``)."""
    dev = sdf.data.device
    if draws is None:
        draws = Draws(seed, dev)
    surface = sdf_lib.grid_to_world(sdf, sdf.surface_points)
    n_surface = surface.shape[0]
    if n_surface == 0:     # no surface cells: nothing to sample
        return _empty_sampled(num_attempts, dev)
    n = num_attempts
    idx = draws.surface_index(n_surface, n).to(dev)
    # perturb_point: x + (res / 2) (U[0,1)^3 - 0.5) (grasp_sampler.py:684-687)
    x1 = fma(sdf.resolution / 2.0, draws.antipodal_perturb(n).to(dev) - 0.5,
             surface[idx])

    # contact normal and tangents at x1 (contacts.py:95-185)
    n_out, n_valid = sdf_lib.surface_normal(sdf, sdf_lib.world_to_grid(sdf, x1))
    up = torch.tensor([0.0, 0.0, 1.0], dtype=x1.dtype, device=dev)
    _, t1, t2 = quality.tangents_from_direction(
        torch.where(n_valid[:, None], -n_out, up))

    # axis from the friction cone (grasp_sampler.py:629-655):
    # v = -(n_out + r cos(th) t1 + r sin(th) t2), th ~ U(0, 2pi), r ~ U(0, mu)
    u_theta, u_r = (u.to(dev) for u in draws.antipodal_cone(n))
    theta = 2.0 * math.pi * u_theta
    r = friction_coef * u_r
    v = fma((r * f64(torch.sin, theta))[:, None], t2,
            fma((r * f64(torch.cos, theta))[:, None], t1, n_out))
    v = -v / norm3(v)[:, None]
    # random axis flip (grasp_sampler.py:746-748)
    v = torch.where((draws.antipodal_flip(n).to(dev) > 0.5)[:, None], -v, v)

    config, _, c_valid = grasp_from_contact_and_axis(
        sdf, x1, v, max_width, num_samples=num_samples_loa,
        min_width_world=min_width)

    # approach angle: the first collision-free one of the shuffled
    # candidates (grasp_sampler.py:757-768); only the approach test depends
    # on the angle, so the fingers close once
    if random_approach_angle:
        cands = torch.as_tensor(APPROACH_ANGLE_CANDIDATES, device=dev)
        angles = cands[draws.approach_perm(n, len(cands)).to(dev)]
    else:
        angles = torch.zeros((n, 1), dtype=x1.dtype, device=dev)
    ok = approach_collision_free(sdf, config, angles,
                                 num_samples=num_samples_loa)
    contacts = close_fingers(sdf, config, num_samples=num_samples_loa,
                             check_approach=False)
    first = torch.argmax(ok.to(torch.int8), dim=1)
    any_ok = ok.any(dim=1) & contacts.found
    config = config.clone()
    config[:, 7] = angles[torch.arange(n, device=dev), first]
    pts, nrm = contacts.points, contacts.normals
    wide_enough = norm3(x1 - pts[:, 1]) >= min_contact_dist
    fc = quality.force_closure(pts[:, 0], nrm[:, 0], pts[:, 1], nrm[:, 1],
                               friction_coef)
    valid = n_valid & c_valid & any_ok & wide_enough & (fc == 1)
    return SampledGrasps(config, pts, nrm, valid)


def _configs(centers, axes, max_width, angles=None):
    n = centers.shape[0]
    angle = (torch.zeros_like(centers[:, :1]) if angles is None
             else angles[:, None].to(centers.dtype))
    return torch.cat([centers, axes,
                      torch.full_like(centers[:, :1], max_width), angle,
                      torch.zeros((n, 2), dtype=centers.dtype,
                                  device=centers.device)], dim=1)


def uniform_sample_grasps(sdf: sdf_lib.SdfGrid, draws=None, *,
                          max_width: float, min_width: float = 0.0,
                          num_attempts: int = 256, num_samples_loa: int = 40,
                          seed: int = 0) -> SampledGrasps:
    """Random surface point pairs within the jaw range and a random approach
    angle (UniformGraspSampler, grasp_sampler.py:459-522)."""
    dev = sdf.data.device
    if draws is None:
        draws = Draws(seed, dev)
    surface = sdf_lib.grid_to_world(sdf, sdf.surface_points)
    i1, i2 = (i.to(dev) for i in draws.uniform_pairs(surface.shape[0],
                                                     num_attempts))
    p1, p2 = surface[i1], surface[i2]
    width = norm3(p2 - p1)
    in_range = (width > min_width) & (width < max_width) & (width > 0)
    cands = torch.as_tensor(APPROACH_ANGLE_CANDIDATES, device=dev)
    angles = cands[draws.approach_choice(num_attempts, len(cands)).to(dev)]
    configs = _configs(0.5 * (p1 + p2),
                       (p2 - p1) / torch.clamp(width[:, None], min=1e-12),
                       max_width, angles)
    contacts = close_fingers(sdf, configs, num_samples=num_samples_loa,
                             check_approach=False)
    return SampledGrasps(configs, contacts.points, contacts.normals,
                         in_range & contacts.found)


def gaussian_sample_grasps(sdf: sdf_lib.SdfGrid, draws=None, *,
                           max_width: float, center_of_mass, principal_dims,
                           sigma_scale: float = 2.5,
                           num_attempts: int = 256,
                           num_samples_loa: int = 40,
                           seed: int = 0) -> SampledGrasps:
    """Centers ~ N(COM, (principal_dims / (2 sigma))^2), axes uniform on the
    sphere (GaussianGraspSampler, grasp_sampler.py:525-618)."""
    dev = sdf.data.device
    if draws is None:
        draws = Draws(seed, dev)
    z_c, z_a = (z.to(dev) for z in draws.gaussian_normals(num_attempts))
    f32 = dict(dtype=torch.float32, device=dev)
    sigma = torch.as_tensor(principal_dims, **f32) / (2.0 * sigma_scale)
    centers = fma(sigma, z_c, torch.as_tensor(center_of_mass, **f32))
    axes = z_a / norm3(z_a)[:, None]
    configs = _configs(centers, axes, max_width)
    contacts = close_fingers(sdf, configs, num_samples=num_samples_loa,
                             check_approach=False)
    return SampledGrasps(configs, contacts.points, contacts.normals,
                         contacts.found)


def sample_grasps_stable_poses(sdf: sdf_lib.SdfGrid, stable_poses, draws=None,
                               *, max_width: float, num_wanted: int = 25,
                               max_rounds: int = 8, seed: int = 0,
                               **antipodal_kwargs):
    """Antipodal grasps aligned to each stable pose
    (generate_grasps_stable_poses, grasp_sampler.py:114-151): sample, then
    set each grasp's approach angle so the hand approaches perpendicular to
    that pose's table. Returns {pose_index: (N, 10) configs}."""
    dev = sdf.data.device
    if draws is None:
        draws = Draws(seed, dev)
    configs, _, _ = sample_until(
        lambda d: antipodal_sample_grasps(sdf, d, max_width=max_width,
                                          **antipodal_kwargs),
        draws, num_wanted, max_rounds=max_rounds)
    configs = torch.as_tensor(configs, dtype=torch.float32, device=dev)
    out = {}
    for i, pose in enumerate(stable_poses):
        r = torch.as_tensor(np.asarray(pose["r"] if isinstance(pose, dict)
                                       else pose.r), dtype=torch.float32,
                            device=dev)
        out[i] = perpendicular_table(configs, r).cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# GPG on an SDF's surface
# ---------------------------------------------------------------------------

def _empty_candidates(dev):
    return GpgCandidates(torch.zeros((0, 5, 3), device=dev),
                         torch.zeros((0,), dtype=torch.bool, device=dev))


def _sdf_surface_points_and_normals(sdf: sdf_lib.SdfGrid,
                                    max_points: int = 2048, draws=None):
    """Surface points (world), outward normals and grid coords of an SDF,
    a random subset of ``max_points`` where it has more. The normals are
    the normalized SDF gradient (the JAX package's documented deviation
    from the reference's plane fit, which blends normals across edges)."""
    pts_grid = sdf.surface_points
    n = pts_grid.shape[0]
    if draws is not None and n > max_points:
        pts_grid = pts_grid[draws.surface_subset(n, max_points).to(
            pts_grid.device)]
    grads = sdf_lib.gradient(sdf, pts_grid)
    norms = norm3(grads)[:, None]
    up = torch.tensor([0.0, 0.0, 1.0], dtype=grads.dtype, device=grads.device)
    normals = torch.where(norms > 1e-9,
                          grads / torch.clamp(norms, min=1e-12), up)
    # origin + res * grid, rounded twice: the JAX package computes these
    # outside jit, where nothing contracts it into an FMA
    return sdf.origin + sdf.resolution * pts_grid, normals, pts_grid


def _visible_filter(pts, normals, camera_pos):
    """Points whose outward normal faces the camera: GPG works on a viewed
    surface, so the SDF variants emulate the camera's partial view."""
    to_cam = torch.as_tensor(camera_pos, dtype=pts.dtype,
                             device=pts.device) - pts
    return torch.sum(to_cam * normals, dim=1) > 0


def _curvature_frames(sdf: sdf_lib.SdfGrid, pts_grid, normals):
    """Per-point [normal, major, minor] frames (P, 3, 3) from SDF principal
    curvature directions: in the tangent plane of the gradient normal, the
    eigendirection of the projected Hessian with the least |curvature| is
    the minor axis."""
    hess = sdf_lib.curvature(sdf, pts_grid, delta=0.5)          # (P, 3, 3)
    _, t1, t2 = quality.tangents_from_direction(-normals)
    ht1 = (hess @ t1[..., None])[..., 0]
    ht2 = (hess @ t2[..., None])[..., 0]
    s = torch.stack([torch.stack([quality._dot(t1, ht1),
                                  quality._dot(t1, ht2)], -1),
                     torch.stack([quality._dot(t2, ht1),
                                  quality._dot(t2, ht2)], -1)], -2)
    w, v = torch.linalg.eigh(s)
    pick = torch.argmin(torch.abs(w), dim=-1)
    vp = torch.gather(v, 2, pick[:, None, None].expand(-1, 2, 1))[..., 0]
    minor = vp[:, 0:1] * t1 + vp[:, 1:2] * t2
    minor = minor / torch.clamp(norm3(minor), min=1e-12)[:, None]
    major = torch.linalg.cross(minor, normals)
    major = major / torch.clamp(norm3(major), min=1e-12)[:, None]
    return torch.stack([normals, major, minor], dim=1)


def gpg_sample_grasps_sdf(sdf: sdf_lib.SdfGrid, gripper: Gripper = Gripper(),
                          *, max_surface_points: int = 2048,
                          camera_pos=(0.0, 0.0, 1.0),
                          curvature_frames: bool = False, draws=None,
                          seed: int = 0, **gpg_kwargs) -> GpgCandidates:
    """GPG on an SDF object (GpgGraspSampler, grasp_sampler.py:806-982):
    the cloud variant's loop on the SDF's camera-visible surface points and
    gradient normals; ``curvature_frames=True`` takes the seed frames from
    ``_curvature_frames`` instead of the covariance estimate."""
    dev = sdf.data.device
    if draws is None:
        draws = Draws(seed, dev)
    pts, normals, pts_grid = _sdf_surface_points_and_normals(
        sdf, max_surface_points, draws)
    vis = _visible_filter(pts, normals, camera_pos)
    pts, normals, pts_grid = pts[vis], normals[vis], pts_grid[vis]
    if pts.shape[0] == 0:     # nothing faces the camera
        return _empty_candidates(dev)
    gpg_kwargs.setdefault("r_ball", gripper.hand_height)
    if curvature_frames:
        gpg_kwargs["point_frames"] = _curvature_frames(sdf, pts_grid, normals)
    return gpg_sample_candidates(pts, normals, gripper, draws=draws,
                                 **gpg_kwargs)


def point_sample_grasps_sdf(sdf: sdf_lib.SdfGrid, gripper: Gripper = Gripper(),
                            *, height_sigma_frac: float = 3.0,
                            max_surface_points: int = 2048, draws=None,
                            seed: int = 0, **gpg_kwargs) -> GpgCandidates:
    """PointGraspSampler (grasp_sampler.py:985-1170): the GPG loop with a
    Gaussian-over-height bias on the seeds (:1040-1046): points near a
    height drawn below the top come first, and the uniform seed choice
    favors them."""
    dev = sdf.data.device
    if draws is None:
        draws = Draws(seed, dev)
    pts, normals, _ = _sdf_surface_points_and_normals(
        sdf, max_surface_points, draws)
    vis = _visible_filter(pts, normals,
                          gpg_kwargs.pop("camera_pos", (0.0, 0.0, 1.0)))
    pts, normals = pts[vis], normals[vis]
    if pts.shape[0] == 0:
        return _empty_candidates(dev)
    z = pts[:, 2]
    z_min, z_max = z.amin(), z.amax()
    sigma = torch.clamp((z_max - z_min) / height_sigma_frac, min=1e-6)
    selected = z_max - torch.abs(draws.height_bias().to(dev) * sigma)
    weight = torch.abs(z - selected) / torch.clamp(z_max - z_min, min=1e-6)
    order = torch.argsort(weight, stable=True)
    gpg_kwargs.setdefault("r_ball", gripper.hand_height)
    return gpg_sample_candidates(pts[order], normals[order], gripper,
                                 draws=draws, **gpg_kwargs)


# ---------------------------------------------------------------------------
# Host-side accumulation (the reference's while loop)
# ---------------------------------------------------------------------------

def dedupe_grasps(configs, min_dist: float = 0.0025, alpha: float = 0.05):
    """Coverage rejection: greedily drop grasps closer than ``min_dist`` to
    an already kept grasp under the center + axis distance (the pruning of
    generate_grasps, grasp_sampler.py:153-234, with grasp.py:212-232). The
    pairwise distances are computed on the configs' device; the greedy pass
    runs on the host. Returns the kept rows, as the input type."""
    is_tensor = isinstance(configs, torch.Tensor)
    cfg = configs if is_tensor else torch.as_tensor(np.asarray(configs))
    n = cfg.shape[0]
    if n == 0:
        return configs
    centers, axes = cfg[:, 0:3], cfg[:, 3:6]
    diff = centers[:, None, :] - centers[None, :, :]
    center_d = norm3(diff)
    dots = torch.clamp(torch.abs(axes @ axes.T), -1.0, 1.0)
    dist = fma(alpha, (2.0 / math.pi) * torch.arccos(dots), center_d)
    close = (~(dist >= min_dist)).cpu().numpy()
    keep = np.zeros(n, bool)
    for i in range(n):
        keep[i] = not close[i, keep].any()
    if is_tensor:
        return configs[torch.as_tensor(keep, device=configs.device)]
    return np.asarray(configs)[keep]


def sample_until(sample_fn, draws, num_wanted: int, max_rounds: int = 10):
    """Run a fixed-budget sampler until ``num_wanted`` valid samples are
    packed. ``sample_fn(round_draws)`` returns a NamedTuple whose last field
    is the validity mask; each round takes ``draws.next_round()``. Returns
    the packed fields as host numpy arrays."""
    collected = None
    for _ in range(max_rounds):
        out = sample_fn(draws.next_round())
        valid = out[-1].cpu().numpy()
        packed = [f.cpu().numpy()[valid] for f in out[:-1]]
        collected = packed if collected is None else [
            np.concatenate([c, p]) for c, p in zip(collected, packed)]
        if len(collected[0]) >= num_wanted:
            break
    return [c[:num_wanted] for c in collected]
