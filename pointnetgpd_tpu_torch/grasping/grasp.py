"""Parallel-jaw grasp configurations and batched contact finding on an SDF.

Port of ``pointnetgpd_tpu/grasping/grasp.py`` (reference:
dex-net/src/dexnet/grasping/grasp.py, ParallelJawPtGrasp3D). A grasp is its
10-dim configuration vector (center 0:3, axis 3:6, max width 6, approach
angle 7, jaw width 8, min width 9; grasp.py:234-276). Every function here is
batched over the leading dimensions of its tensors, where the JAX package
``vmap``s a single-grasp function: one call closes the fingers of G grasps
over S line samples each.

Kept from the JAX package (its documented deviations from the reference):
- the zero crossing takes the SMALLEST real root in [0, 10] (the first
  crossing along the closing direction) and falls back to the linear
  crossing where the quadratic degenerates (sdf.py:706-766);
- the finger-closing while loop is the first index of a per-sample
  acceptance mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import sdf as sdf_lib
from ..ops.fp import dot3, dot3v, f64, fma, norm3, sqrt

SAMPLES_PER_GRID = 2.0  # Grasp.samples_per_grid (grasp.py:86)


def adaptive_num_samples(sdf, width_world, minimum: int = 40,
                         multiple: int = 32, cap: int = 512) -> int:
    """Resolution-adaptive line-of-action sample count, the reference's
    ``samples_per_grid * grasp_width_grid / 2`` (grasp.py:464-466), rounded
    up to ``multiple`` and capped; coarse grids keep ``minimum``."""
    width_grid = float(width_world) / float(sdf.resolution)
    n = int(np.ceil(SAMPLES_PER_GRID * width_grid / 2.0))
    if n <= minimum:
        return minimum
    return min(-(-n // multiple) * multiple, cap)


# ---------------------------------------------------------------------------
# Configuration vector <-> parameters (grasp.py:234-276)
# ---------------------------------------------------------------------------

def _cols(*vals, like):
    return torch.stack([torch.as_tensor(v, dtype=like.dtype,
                                        device=like.device).expand(
                                            like.shape[:-1])
                        for v in vals], dim=-1)


def configuration_from_params(center, axis, width, angle=0.0, jaw_width=0.0,
                              min_width=0.0):
    axis = axis / norm3(axis)[..., None]
    return torch.cat([center, axis, _cols(width, angle, jaw_width, min_width,
                                          like=center)], dim=-1)


def params_from_configuration(config):
    """-> (center, axis, max_width, angle, jaw_width, min_width)."""
    min_width = (config[..., 9] if config.shape[-1] >= 10
                 else torch.zeros_like(config[..., 0]))
    return (config[..., 0:3], config[..., 3:6], config[..., 6],
            config[..., 7], config[..., 8], min_width)


def endpoints(config):
    """Jaw locations at max opening (grasp.py:202-210)."""
    center, axis = config[..., 0:3], config[..., 3:6]
    half = config[..., 6:7] / 2.0
    return center - half * axis, center + half * axis


def grasp_distance(config1, config2, alpha: float = 0.05):
    """Spatial + rotational grasp distance (grasp.py:212-232)."""
    center_dist = norm3(config1[..., 0:3] - config2[..., 0:3])
    dot = torch.clamp(torch.abs(dot3v(config1[..., 3:6], config2[..., 3:6])),
                      -1.0, 1.0)
    return center_dist + alpha * (2.0 / np.pi) * f64(torch.arccos, dot)


def unrotated_full_axis(axis):
    """Canonical grasp frame (..., 3, 3), columns: X out of the palm, Y
    between the jaws (grasp.py:322-340)."""
    y = axis
    x = torch.stack([y[..., 1], -y[..., 0], torch.zeros_like(y[..., 0])],
                    dim=-1)
    degenerate = norm3(x)[..., None] == 0
    x = torch.where(degenerate, torch.tensor([1.0, 0.0, 0.0], dtype=x.dtype,
                                             device=x.device), x)
    x = x / norm3(x)[..., None]
    z = torch.linalg.cross(x, y)
    return torch.stack([x, y, z], dim=-1)


def rotation_y(theta):
    """(..., 3, 3) == np.c_[[c,0,s],[0,1,0],[-s,0,c]] (grasp.py:370-375)."""
    c, s = f64(torch.cos, theta), f64(torch.sin, theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, -s], -1),
                        torch.stack([z, o, z], -1),
                        torch.stack([s, z, c], -1)], -2)


def rotated_full_axis(axis, angle):
    """(grasp.py:342-354)."""
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    return _matmul3(unrotated_full_axis(axis), rotation_y(angle))


def _matmul3(a, b):
    """(..., 3, 3) @ (..., 3, 3), each entry a ``dot3``: the same bits on
    the card and on the CPU."""
    return dot3(a[..., :, 0, None], b[..., None, 0, :],
                a[..., :, 1, None], b[..., None, 1, :],
                a[..., :, 2, None], b[..., None, 2, :])


def t_grasp_obj(config):
    """4x4 grasp->object transform (grasp.py:356-368)."""
    rot = rotated_full_axis(config[..., 3:6], config[..., 7])
    t = torch.eye(4, dtype=config.dtype, device=config.device).expand(
        *config.shape[:-1], 4, 4).clone()
    t[..., :3, :3] = rot
    t[..., :3, 3] = config[..., 0:3]
    return t


def center_from_endpoints(g1, g2):
    """(grasp.py:278-282)."""
    return 0.5 * (g1 + g2)


def axis_from_endpoints(g1, g2):
    """(grasp.py:284-290)."""
    axis = g2 - g1
    n = norm3(axis)[..., None]
    return torch.where(n > 0, axis / torch.clamp(n, min=1e-30), axis)


def grasp_from_endpoints(g1, g2, width=None, approach_angle=0.0,
                         close_width=0.0):
    """Configuration from jaw endpoints (grasp.py:298-320)."""
    if width is None:
        width = norm3(g2 - g1)
    return configuration_from_params(
        center_from_endpoints(g1, g2), axis_from_endpoints(g1, g2), width,
        angle=approach_angle, min_width=close_width)


def grasp_angles_from_stp_z(config, r_stp_obj):
    """Angles of the grasp frame against a stable pose's table normal
    (grasp.py:401-433): (axis angle psi, |approach| angle phi, nu)."""
    rot = rotated_full_axis(config[..., 3:6], config[..., 7])
    rot_stp = _matmul3(r_stp_obj.to(rot.dtype), rot)
    psi = f64(torch.arccos, torch.clamp(rot_stp[..., 2, 1], -1.0, 1.0))
    phi = f64(torch.arccos, torch.clamp(torch.abs(rot_stp[..., 2, 0]), -1.0,
                                        1.0))
    return psi, phi, rot_stp[..., 2, 2]


def _angle_aligned_with_table(axis, r_table_rows):
    """z-component of the approach axis over the approach angle t is
    a cos t + b sin t (grasp.py:715-836); returns (a, b)."""
    u = unrotated_full_axis(axis)
    table_z = r_table_rows[..., 2, :]
    return dot3v(table_z, u[..., :, 0]), dot3v(table_z, u[..., :, 2])


def parallel_table(config, r_table_rows):
    """Approach angle making the approach axis parallel to the table
    (grasp.py:765-782)."""
    a, b = _angle_aligned_with_table(config[..., 3:6], r_table_rows)
    out = config.clone()
    out[..., 7] = f64(torch.arctan2, -a, b)
    return out


def perpendicular_table(config, r_table_rows):
    """Approach angle pointing the approach axis into the table
    (grasp.py:815-836)."""
    a, b = _angle_aligned_with_table(config[..., 3:6], r_table_rows)
    out = config.clone()
    out[..., 7] = f64(torch.arctan2, -b, -a)
    return out


# ---------------------------------------------------------------------------
# Contact finding
# ---------------------------------------------------------------------------

class Contacts(NamedTuple):
    """Batched contact pairs from closing fingers on an SDF."""

    found: torch.Tensor          # (...,) both contacts found, normals valid
    points: torch.Tensor         # (..., 2, 3) world contact points
    normals: torch.Tensor        # (..., 2, 3) outward surface normals
    in_directions: torch.Tensor  # (..., 2, 3) finger closing directions


def line_of_action(start_grid, axis_grid, length_grid, num_samples: int,
                   min_width_grid=0.0):
    """(..., S, 3) grid points start + t * axis, t = linspace(0, length/2 -
    min/2, S) (grasp.py:583-613). ``t`` is rounded as ``jnp.linspace``
    rounds it: stop * (i / (S - 1)), the last sample exactly at stop."""
    dev, dt = start_grid.device, start_grid.dtype
    stop = (torch.as_tensor(length_grid, dtype=dt, device=dev) / 2.0
            - torch.as_tensor(min_width_grid, dtype=dt, device=dev) / 2.0)
    div = num_samples - 1
    # i / div on the host: the card divides a tensor by a host scalar as a
    # product with its reciprocal, which can round differently
    frac = torch.as_tensor(np.arange(div, dtype=np.float32)
                           / np.float32(div), dtype=dt, device=dev)
    stop = stop[..., None]
    t = torch.cat([stop * frac, stop], dim=-1)                 # (..., S)
    return fma(t[..., None], axis_grid[..., None, :], start_grid[..., None, :])


def _det3(m):
    """Cofactor expansion along the first row of (..., 3, 3)."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def _quadratic_zero_crossing(p0, y0, p1, y1, p2, y2, eps: float = 1.0):
    """Zero crossing of the quadratic through three collinear samples
    (sdf.py:721-766), batched. Returns (point (..., 3), valid (...))."""
    v = p1 - p0
    seg = norm3(v)
    v = v / torch.clamp(seg, min=1e-12)[..., None]
    t1 = torch.zeros_like(seg)
    t2 = seg
    t3 = norm3(p2 - p0)
    one = torch.ones_like(t1)
    x = torch.stack([torch.stack([t1 * t1, t1, one], -1),
                     torch.stack([t2 * t2, t2, one], -1),
                     torch.stack([t3 * t3, t3, one], -1)], -2)  # (..., 3, 3)
    y = torch.stack([y0, y1, y2], -1)
    d = _det3(x)
    singular = torch.abs(d) < 1e-12
    d_safe = torch.where(singular, 1.0, d)

    def with_col(j):
        m = x.clone()
        m[..., :, j] = y
        return _det3(m) / d_safe

    a, b, c = with_col(0), with_col(1), with_col(2)
    disc = b * b - 4.0 * a * c
    has_roots = disc >= 0
    sq = sqrt(torch.clamp(disc, min=0.0))
    a_safe = torch.where(torch.abs(a) < 1e-30, 1e-30, a)
    r1 = (-b - sq) / (2.0 * a_safe)
    r2 = (-b + sq) / (2.0 * a_safe)
    lo, hi = torch.minimum(r1, r2), torch.maximum(r1, r2)
    lo_ok = has_roots & (lo >= 0) & (lo <= 10.0)
    hi_ok = has_roots & (hi >= 0) & (hi <= 10.0)
    t_root = torch.where(lo_ok, lo, hi)       # first crossing along the line
    root_found = lo_ok | hi_ok
    t_vertex = -b / (2.0 * a_safe)
    t_quad = torch.where(root_found, t_root, t_vertex)

    # a quadratic that degenerates to a line falls back to the linear zero
    # crossing (the reference's find_zero_crossing_linear, sdf.py:706-719)
    degenerate_quad = torch.abs(a) < 1e-10
    b_safe = torch.where(torch.abs(b) < 1e-30, 1e-30, b)
    t_linear = -c / b_safe
    linear_ok = torch.abs(b) >= 1e-30
    t_zc = torch.where(degenerate_quad, t_linear, t_quad)
    ok = torch.where(degenerate_quad, linear_ok, True)
    valid = (~singular) & ok & (torch.abs(t_zc) <= eps)
    return fma(t_zc[..., None], v, p0), valid


def find_contact(sdf: sdf_lib.SdfGrid, loa):
    """First surface contact along lines of action (grasp.py:615-713).

    loa: (..., S, 3) grid points. Returns (found (...), point_grid (..., 3),
    strict_hit (...)); strict_hit is the reference's ``strict=True``
    semantics (any on-surface sample, the approach check,
    grasp.py:479-481)."""
    s = loa.shape[-2]
    dev = loa.device
    vals = sdf_lib.signed_distance_oob_big(sdf, loa)            # (..., S)
    on_surf = torch.abs(vals) < sdf.surface_thresh
    strict_hit = on_surf.any(dim=-1)

    # neighbor triples per index, edge-clamped like the reference's cases:
    # i == 0 uses (0, 1, 2), i == S-1 uses (S-3, S-2, S-1) (grasp.py:669-693)
    idx = torch.arange(s, device=dev)
    a_idx = torch.clamp(idx - 1, 0, s - 3)
    b_idx = a_idx + 1
    c_idx = a_idx + 2
    i_next = torch.clamp(idx + 1, max=s - 1)
    zc_pts, zc_valid = _quadratic_zero_crossing(
        loa[..., a_idx, :], vals[..., a_idx], loa[..., b_idx, :],
        vals[..., b_idx], loa[..., c_idx, :], vals[..., c_idx])

    # "contact not yet found if the next sdf value is smaller"
    # (grasp.py:679, 696)
    next_smaller = torch.abs(vals[..., i_next]) < torch.abs(vals)
    next_smaller[..., s - 1] = False
    accept = on_surf & zc_valid & ~next_smaller
    found = accept.any(dim=-1)
    first = torch.argmax(accept.to(torch.int8), dim=-1)
    point = torch.gather(zc_pts, -2, first[..., None, None].expand(
        *first.shape, 1, 3))[..., 0, :]
    return found, point, strict_hit


def _contact_with_normal(sdf: sdf_lib.SdfGrid, pt_grid, in_direction_grid):
    """Contact normal from the SDF, oriented outward against the closing
    direction (contacts.py:95-115). Returns (point_world, normal, valid)."""
    normal, n_valid = sdf_lib.surface_normal(sdf, pt_grid)
    flip = dot3v(in_direction_grid, normal) > 0
    normal = torch.where(flip[..., None], -normal, normal)
    return sdf_lib.grid_to_world(sdf, pt_grid), normal, n_valid


def _jaws_grid(sdf, config):
    """Unit axis and the two jaw positions (grid coords) of (..., 10)."""
    center, axis, width = config[..., 0:3], config[..., 3:6], config[..., 6]
    axis = axis / norm3(axis)[..., None]
    half = (width / 2.0)[..., None]
    g1 = sdf_lib.world_to_grid(sdf, fma(-half, axis, center))
    g2 = sdf_lib.world_to_grid(sdf, fma(half, axis, center))
    return axis, g1, g2


def _approach_hits(sdf, g1, g2, approach_axis, approach_dist, num_samples):
    """Strict-mode approach check (grasp.py:475-484): True where either jaw's
    retreat line touches the surface."""
    adist_grid = approach_dist / sdf.resolution
    hits = []
    for g in (g1, g2):
        loa = line_of_action(g, -approach_axis, adist_grid.expand(
            g.shape[:-1]), num_samples)
        hits.append(find_contact(sdf, loa)[2])
    return hits[0] | hits[1]


def close_fingers(sdf: sdf_lib.SdfGrid, configs, *, num_samples: int = 40,
                  check_approach: bool = True, approach_dist: float = 1.0,
                  num_approach_samples: int = 40) -> Contacts:
    """Batched finger closing on an SDF (grasp.py:435-511).

    configs: (..., 10) grasp configurations (object frame). The number of
    line samples is fixed per call (``adaptive_num_samples`` gives the
    reference's resolution-scaled count)."""
    axis, g1, g2 = _jaws_grid(sdf, configs)
    width_grid = configs[..., 6] / sdf.resolution
    min_width_grid = configs[..., 9] / sdf.resolution

    ok = torch.ones(configs.shape[:-1], dtype=torch.bool,
                    device=configs.device)
    if check_approach:
        approach_axis = rotated_full_axis(axis, configs[..., 7])[..., :, 0]
        ok = ~_approach_hits(sdf, g1, g2, approach_axis, approach_dist,
                             num_approach_samples)

    f1, p1, _ = find_contact(sdf, line_of_action(
        g1, axis, width_grid, num_samples, min_width_grid))
    f2, p2, _ = find_contact(sdf, line_of_action(
        g2, -axis, width_grid, num_samples, min_width_grid))
    pw1, n1, nv1 = _contact_with_normal(sdf, p1, axis)
    pw2, n2, nv2 = _contact_with_normal(sdf, p2, -axis)
    return Contacts(
        found=ok & f1 & f2 & nv1 & nv2,
        points=torch.stack([pw1, pw2], dim=-2),
        normals=torch.stack([n1, n2], dim=-2),
        in_directions=torch.stack([axis, -axis], dim=-2))


def approach_collision_free(sdf: sdf_lib.SdfGrid, config, angles, *,
                            num_samples: int = 40,
                            approach_dist: float = 1.0):
    """The approach half of ``close_fingers`` alone, per approach angle:
    config (..., 10), angles (..., A) -> (..., A) bool, True where the
    approach is collision free (strict mode). Only this test depends on the
    angle (grasp.py:475-484), so samplers that scan angle candidates close
    the fingers once and run this per angle."""
    axis, g1, g2 = _jaws_grid(sdf, config)
    a = angles.shape[-1]

    def rep(v):
        return v[..., None, :].expand(*v.shape[:-1], a, v.shape[-1])

    approach_axis = rotated_full_axis(rep(axis), angles)[..., :, 0]
    return ~_approach_hits(sdf, rep(g1), rep(g2), approach_axis,
                           approach_dist, num_samples)


def grasp_from_contact_and_axis(sdf: sdf_lib.SdfGrid, c1_world, axis_world,
                                width_world, *, num_samples: int = 40,
                                min_width_world=0.0, backup: float = 0.5):
    """Grasps from one contact (..., 3) and an axis (..., 3) by closing from
    both sides (grasp.py:872-947). Returns (config (..., 10), Contacts,
    valid (...))."""
    axis_world = axis_world / norm3(axis_world)[..., None]
    width_grid = torch.as_tensor(width_world, dtype=c1_world.dtype,
                                 device=c1_world.device) / sdf.resolution
    min_width_grid = min_width_world / sdf.resolution
    c1_grid = fma(-backup, axis_world, sdf_lib.world_to_grid(sdf, c1_world))
    g2 = fma(width_grid - backup, axis_world, c1_grid)
    lead = c1_world.shape[:-1]

    f1, p1, _ = find_contact(sdf, line_of_action(
        c1_grid, axis_world, width_grid.expand(lead), num_samples,
        min_width_grid))
    f2, p2, _ = find_contact(sdf, line_of_action(
        g2, -axis_world, (2.0 * width_grid).expand(lead), num_samples))
    pw1, n1, nv1 = _contact_with_normal(sdf, p1, axis_world)
    pw2, n2, nv2 = _contact_with_normal(sdf, p2, -axis_world)

    dist = norm3(pw1 - pw2)
    valid = f1 & f2 & nv1 & nv2 & (dist > min_width_world)
    center = 0.5 * (pw1 + pw2)
    new_axis = (pw2 - pw1) / torch.clamp(dist, min=1e-12)[..., None]
    config = torch.cat([center, new_axis, _cols(width_world, 0.0, 0.0, 0.0,
                                                like=center)], dim=-1)
    contacts = Contacts(found=valid,
                        points=torch.stack([pw1, pw2], dim=-2),
                        normals=torch.stack([n1, n2], dim=-2),
                        in_directions=torch.stack([axis_world, -axis_world],
                                                  dim=-2))
    return config, contacts, valid


# ---------------------------------------------------------------------------
# Vacuum grasps (reference: grasp.py:969-1020 VacuumPoint), host numpy
# ---------------------------------------------------------------------------

def vacuum_configuration_from_params(center, axis):
    """5-DOF vacuum target -> 6-vector [center, unit axis]
    (VacuumPoint.configuration_from_params, grasp.py:995-1003)."""
    center = np.asarray(center, dtype=float)
    axis = np.asarray(axis, dtype=float)
    if abs(np.linalg.norm(axis) - 1.0) > 1e-5:
        raise ValueError("vacuum axis must be unit-norm")
    return np.concatenate([center, axis])


def vacuum_params_from_configuration(configuration):
    """6-vector -> (center, axis) with the reference's unit-axis check
    (VacuumPoint.params_from_configuration, grasp.py:1005-1020)."""
    configuration = np.asarray(configuration, dtype=float)
    if configuration.shape[-1] != 6:
        raise ValueError("vacuum configuration must have 6 entries")
    axis = configuration[..., 3:6]
    if np.max(np.abs(np.linalg.norm(axis, axis=-1) - 1.0)) > 1e-5:
        raise ValueError("vacuum axis must be unit-norm")
    return configuration[..., 0:3], axis
