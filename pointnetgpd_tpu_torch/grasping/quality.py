"""Grasp quality metrics, batched on tensors.

Port of ``pointnetgpd_tpu/grasping/quality.py`` (reference:
dex-net/src/dexnet/grasping/quality.py). The reference calls cvxopt QPs and
qhull hulls once per grasp; here, as in the JAX package:

- ``force_closure``: the Nguyen antipodality test (quality.py:245-283).
- ``grasp_matrix``: the 6 x M wrench basis (quality.py:191-243).
- ``ferrari_canny_l1_force_only``: the dataset-label metric
  (quality.py:626-723) as an exact enumeration of the C(M, 3) supporting
  point triples, each facet's QP in closed form.
- ``min_norm_in_simplex`` / ``min_norm_in_simplex_batch``: accelerated
  projected gradient with a fixed iteration count, replacing
  min_norm_vector_in_facet (quality.py:786-822).
- ``ferrari_canny_l1``: the 6-D epsilon with the hull from scipy's qhull on
  the host (offline only), facet QPs batched.
- ``ferrari_canny_l1_device`` / ``_batch``: the same 6-D metric with no host
  library: every C(M, 6) row subset's plane, by batched 6 x 6 solves.

Every function is batched over leading dimensions where the JAX package
``vmap``s it. The batch 6-D metric computes only the grasps its hull guards
accept and scatters them back: what ``lax.cond`` over compacted groups does
in the JAX package.
"""

from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch

from ..ops.fp import dot3v, f64, norm3, sqrt
from ..ops.point_triangle import _closest_dist2

DEFAULT_WRENCH_NORM_THRESH = 1e-3
DEFAULT_WRENCH_REGULARIZER = 1e-10


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _vec(vals, like):
    return torch.tensor(vals, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Friction cones / contact wrenches
# ---------------------------------------------------------------------------

def tangents_from_direction(direction):
    """Right-handed tangent frame (d, t1, t2) of (inward) directions (..., 3)
    (contacts.py:117-185 with ``align_axes=True`` in closed form: t1 is the
    normalized projection of x-hat onto the tangent plane)."""
    d = direction / norm3(direction)[..., None]
    ref = torch.where((torch.abs(d[..., 0]) < 0.9)[..., None],
                      _vec([1.0, 0.0, 0.0], d), _vec([0.0, 1.0, 0.0], d))
    x = ref - dot3v(ref, d)[..., None] * d
    x = x / torch.clamp(norm3(x), min=1e-12)[..., None]
    y = torch.linalg.cross(d, x)
    cx, cy = x[..., 0], y[..., 0]
    norm = sqrt(cx * cx + cy * cy)
    v = torch.where((norm > 1e-8)[..., None],
                    (cx[..., None] * x + cy[..., None] * y)
                    / torch.clamp(norm, min=1e-12)[..., None], x)
    return d, v, torch.linalg.cross(d, v)


def friction_cone(inward_normal, friction_coef, num_cone_faces: int = 8):
    """(..., F, 3) cone edges ``normal + mu * tangent_j``, not normalized
    (contacts.py:268-280). ``friction_coef`` is a scalar or a (...) tensor."""
    d, t1, t2 = tangents_from_direction(inward_normal)
    j = torch.arange(num_cone_faces, dtype=inward_normal.dtype,
                     device=inward_normal.device)
    ang = 2.0 * math.pi * j / num_cone_faces
    tan = (f64(torch.cos, ang)[:, None] * t1[..., None, :]
           + f64(torch.sin, ang)[:, None] * t2[..., None, :])
    mu = torch.as_tensor(friction_coef, dtype=d.dtype, device=d.device)
    return d[..., None, :] + mu[..., None, None] * tan


def torques_from_forces(moment_arm, forces):
    """torque_i = moment_arm x force_i (contacts.py:282-310)."""
    return torch.linalg.cross(moment_arm.expand_as(forces), forces)


def normal_force_magnitude(inward_normal, in_direction):
    """max(dot(in_dir_hat, inward_normal), 0) (contacts.py:210-223)."""
    d = in_direction / norm3(in_direction)[..., None]
    return torch.clamp(dot3v(d, inward_normal), min=0.0)


def grasp_matrix(forces, torques, normals, *, torque_scaling=1.0,
                 soft_fingers: bool = False, friction_coef=0.5,
                 finger_radius=0.005):
    """6 x M wrench basis (quality.py:191-243); forces/torques (M, 3),
    normals (K, 3) inward-scaled (row-major, transposed from the
    reference's 3 x M)."""
    g = torch.cat([forces, torque_scaling * torques], dim=1).T
    if soft_fingers:
        torsion = (math.pi * finger_radius ** 2 * friction_coef * normals
                   * torque_scaling)
        zeros = torch.zeros_like(torsion)
        pos = torch.cat([zeros, torsion], dim=1).T
        neg = torch.cat([zeros, -torsion], dim=1).T
        g = torch.cat([g, pos, neg], dim=1)
    return g


# ---------------------------------------------------------------------------
# Force closure (Nguyen antipodality test)
# ---------------------------------------------------------------------------

def force_closure(p1, n1, p2, n2, friction_coef, use_abs_value: bool = True):
    """(...) int32, 1 where the two contacts are in force closure
    (quality.py:245-283). n1, n2 are OUTWARD normals."""
    in1, in2 = -n1, -n2
    diff21 = p2 - p1
    diff12 = p1 - p2
    dist = norm3(diff21)
    mu = torch.as_tensor(friction_coef, dtype=p1.dtype, device=p1.device)

    def check(normal, diff):
        proj = dot3v(normal, diff) / norm3(normal)
        if use_abs_value:
            proj = torch.abs(proj)
        in_cone = f64(torch.arccos, torch.clamp(
            proj / torch.clamp(dist, min=1e-16), -1.0, 1.0)) \
            <= f64(torch.arctan, mu)
        return (proj >= 0) & in_cone

    closed = (check(in1, diff21) & check(in2, diff12)).to(torch.int32)
    return torch.where(dist == 0, 0, closed)


# ---------------------------------------------------------------------------
# Min-norm point in a simplex / convex hull
# ---------------------------------------------------------------------------

def _project_simplex(v, dim: int = -1):
    """Euclidean projection onto the probability simplex along ``dim``
    (sorted algorithm)."""
    n = v.shape[dim]
    u = torch.sort(v, dim=dim, descending=True)[0]
    css = torch.cumsum(u, dim=dim) - 1.0
    shape = [1] * v.ndim
    shape[dim] = n
    idx = torch.arange(1, n + 1, dtype=v.dtype, device=v.device).reshape(shape)
    rho = torch.sum(u - css / idx > 0, dim=dim, keepdim=True)
    # rho is 0 only on NaN lanes; index -1 wraps to the last, as in JAX
    theta = torch.gather(css, dim, torch.remainder(rho - 1, n)) / rho.to(
        v.dtype)
    return torch.clamp(v - theta, min=0.0)


def _fista(gram, num_iters, dim):
    """FISTA for min x'Gx over the simplex: x along ``dim`` of gram's
    matvec; gram (..., n, n) with x (..., n) (dim -1) or gram (n, n, G)
    with x (n, G) (dim 0)."""
    if dim == -1:
        n = gram.shape[-1]
        lip = 2.0 * torch.clamp(torch.diagonal(gram, dim1=-2,
                                               dim2=-1).sum(-1), min=1e-12)
        step = (1.0 / lip)[..., None]

        def matvec(y):
            return (gram @ y[..., None])[..., 0]

        x0 = torch.full(gram.shape[:-1], 1.0 / n, dtype=gram.dtype,
                        device=gram.device)
    else:
        n = gram.shape[0]
        lip = 2.0 * torch.clamp(torch.diagonal(gram, dim1=0,
                                               dim2=1).sum(-1), min=1e-12)
        step = (1.0 / lip)[None, :]

        def matvec(y):
            return torch.sum(gram * y[None, :, :], dim=1)

        x0 = torch.full((n, gram.shape[2]), 1.0 / n, dtype=gram.dtype,
                        device=gram.device)
    x, y = x0, x0
    for mom in _momenta(num_iters):
        x_new = _project_simplex(y - step * (2.0 * matvec(y)), dim)
        y = x_new + mom * (x_new - x)
        x = x_new
    return x, matvec


def _momenta(num_iters):
    """FISTA's momentum (t_k - 1) / t_{k+1}, with t carried in float32 as
    the JAX loop carries it."""
    one, t = np.float32(1.0), np.float32(1.0)
    out = []
    for _ in range(num_iters):
        t_new = np.float32(0.5) * (one + np.sqrt(one + np.float32(4.0) * t * t))
        out.append(float((t - one) / t_new))
        t = t_new
    return out


def min_norm_in_simplex(vertices, num_iters: int = 200,
                        wrench_regularizer: float = DEFAULT_WRENCH_REGULARIZER):
    """min over the simplex of ||V^T x|| for vertex rows V (..., n, d):
    the QP min x'(VV' + eps I)x, x >= 0, sum x = 1 (quality.py:786-822) by
    accelerated projected gradient. Returns (min_norm (...), x (..., n))."""
    n = vertices.shape[-2]
    eye = torch.eye(n, dtype=vertices.dtype, device=vertices.device)
    gram = vertices @ vertices.transpose(-1, -2) + wrench_regularizer * eye
    x, matvec = _fista(gram, num_iters, -1)
    return sqrt(torch.clamp(_dot(x, matvec(x)), min=0.0)), x


def min_norm_in_simplex_batch(vertices, num_iters: int = 300,
                              wrench_regularizer: float = DEFAULT_WRENCH_REGULARIZER):
    """Batched ``min_norm_in_simplex`` over (G, n, d) vertex sets with the
    batch index last (iterates (n, G), Gram matrices (n, n, G)), as the JAX
    package lays it out. Returns (min_norms (G,), coefficients (G, n))."""
    n = vertices.shape[1]
    eye = torch.eye(n, dtype=vertices.dtype, device=vertices.device)
    gram = (torch.einsum("gnd,gmd->nmg", vertices, vertices)
            + wrench_regularizer * eye[:, :, None])
    x, matvec = _fista(gram, num_iters, 0)
    return (sqrt(torch.clamp(torch.sum(x * matvec(x), dim=0), min=0.0)),
            x.T)


def closest_point_on_triangle_to_origin(a, b, c):
    """Exact distance from the origin to triangles (a, b, c), each (..., 3):
    Ericson's closest point (Real-Time Collision Detection 5.1.5), the
    reference's per-facet QP for 3-vertex facets. Edge bc has the last word
    among the edges, as in the JAX package (``ops.point_triangle``)."""
    split = [tuple(v[..., i] for i in range(3)) for v in (a, b, c)]
    return sqrt(_closest_dist2(*split))


@functools.lru_cache(maxsize=16)
def _triples(m: int) -> np.ndarray:
    return np.asarray(list(itertools.combinations(range(m), 3)),
                      dtype=np.int64)


def ferrari_canny_l1_force_only(g3,
                                wrench_norm_thresh: float = DEFAULT_WRENCH_NORM_THRESH):
    """Epsilon metric on the 3-D force set (quality.py:626-723) of each
    (..., M, 3) row set: every supporting point triple is a hull facet, and
    epsilon is the least origin-to-facet distance over them; 0 where the
    origin is outside or on the boundary (quality.py:696-705).

    The metric runs in float64 on the rows. Each friction cone's edges end
    on one plane (its rim), and the support test's 1e-10 relative tolerance
    lies far below float32 rounding: in float32, as the JAX package computes
    it, whether a rim facet counts is decided by rounding, and epsilon comes
    out high on a quarter to a half of two-cone grasps. In float64 the test
    finds the hull of the given float32 rows, as a float64 qhull does."""
    g = g3.to(torch.float64)
    tri = torch.as_tensor(_triples(g.shape[-2]), device=g.device)
    a, b, c = g[..., tri[:, 0], :], g[..., tri[:, 1], :], g[..., tri[:, 2], :]
    n = torch.linalg.cross(b - a, c - a)
    n_norm = torch.linalg.norm(n, dim=-1)
    scale = torch.clamp(torch.abs(g).amax(dim=(-2, -1)), min=1e-30)
    nondegenerate = n_norm > 1e-12 * scale[..., None]
    na = torch.sum(n * a, dim=-1)
    offs = torch.einsum("...ti,...mi->...tm", n, g) - na[..., None]
    tol = 1e-10 * torch.clamp(n_norm, min=1e-30)[..., None]
    supporting = ((offs <= tol).all(dim=-1) | (offs >= -tol).all(dim=-1)) \
        & nondegenerate
    origin_off = -na / torch.clamp(n_norm, min=1e-30)
    side = torch.where(offs.sum(dim=-1) >= 0, 1.0, -1.0)
    inf = torch.tensor(torch.inf, dtype=g.dtype, device=g.device)
    interior_margin = torch.where(supporting, side * origin_off, inf).amin(-1)
    origin_inside = supporting.any(dim=-1) & (interior_margin > 1e-10)
    dists = closest_point_on_triangle_to_origin(a, b, c)
    eps = torch.where(supporting, dists, inf).amin(dim=-1)
    eps = torch.where(torch.isfinite(eps), eps, 0.0)
    return torch.where(origin_inside, eps, 0.0).to(g3.dtype)


def ferrari_canny_l1(g6, wrench_norm_thresh: float = DEFAULT_WRENCH_NORM_THRESH,
                     wrench_regularizer: float = DEFAULT_WRENCH_REGULARIZER,
                     num_iters: int = 300, device="cuda"):
    """Full 6-D epsilon (quality.py:527-623) of (M, 6) wrench rows. The hull
    comes from scipy's qhull on the host (offline path only); the guard
    and the facet QPs run on ``device``. Returns a float."""
    from scipy.spatial import ConvexHull  # host-only dependency

    g6 = np.asarray(g6, dtype=np.float64)
    try:
        hull = ConvexHull(g6, qhull_options="QJ")
    except Exception:
        return 0.0
    if len(hull.simplices) == 0:
        return 0.0
    g = torch.as_tensor(g6, device=device)
    min_norm_in_hull, coeffs = min_norm_in_simplex(
        g, num_iters=num_iters, wrench_regularizer=wrench_regularizer)
    if float(min_norm_in_hull) > wrench_norm_thresh:
        return 0.0
    if int((coeffs > 1e-4).sum()) <= g6.shape[1] - 1:
        return 0.0
    facets = torch.as_tensor(g6[hull.simplices], device=device)
    dists, _ = min_norm_in_simplex_batch(facets, num_iters=num_iters,
                                         wrench_regularizer=wrench_regularizer)
    return float(dists.min())


@functools.lru_cache(maxsize=16)
def _six_subsets(m: int) -> np.ndarray:
    # C(m, 6) grows combinatorially (C(40, 6) = 3.8M): beyond 40 rows the
    # enumeration would exhaust memory; use the qhull path instead
    if m > 40:
        raise ValueError(
            f"ferrari_canny_l1_device enumerates C({m},6) facet planes "
            f"({math.comb(m, 6):,}); wrench sets beyond 40 rows should "
            "use the host-qhull ferrari_canny_l1 instead")
    return np.asarray(list(itertools.combinations(range(m), 6)),
                      dtype=np.int64)


def _solve_ones_batched(p):
    """Solve P n = 1 for (..., 6, 6) systems by unrolled Gauss-Jordan with
    partial pivoting on 42 (...)-shaped operands, the JAX package's
    structure-of-arrays form (quality.py:426-462). Singular systems give
    non-finite rows, which the caller rejects. Returns (..., 6)."""
    d = p.shape[-1]
    ones = torch.ones(p.shape[:-2], dtype=p.dtype, device=p.device)
    rows = [[p[..., i, j] for j in range(d)] + [ones] for i in range(d)]
    inf = torch.tensor(torch.inf, dtype=p.dtype, device=p.device)
    for k in range(d):
        for i in range(k + 1, d):
            c = torch.abs(rows[i][k]) > torch.abs(rows[k][k])
            for j in range(k, d + 1):
                rk, ri = rows[k][j], rows[i][j]
                rows[k][j] = torch.where(c, ri, rk)
                rows[i][j] = torch.where(c, rk, ri)
        piv_safe = torch.where(torch.abs(rows[k][k]) < 1e-30, inf, rows[k][k])
        for i in range(d):
            if i == k:
                continue
            f = rows[i][k] / piv_safe
            for j in range(k, d + 1):
                rows[i][j] = rows[i][j] - f * rows[k][j]
    return torch.stack([rows[i][d] / rows[i][i] for i in range(d)], dim=-1)


_SUBSET_CHUNK = 16384


def _boundary_distance_6d(g6):
    """Distance from the origin to the boundary of conv(g6) for
    origin-interior hulls of (..., M, 6) row sets: the least 1/||n|| over
    the supporting planes <n, x> = 1 of all C(M, 6) row subsets
    (quality.py:466-513), in chunks of _SUBSET_CHUNK subsets.

    The solves and the support test run in float64 on the rows. Two
    contacts on the grasp axis resist no torque about it, so their hull is
    flat but for rounding: its facet planes across the thin direction come
    from nearly singular systems, and in float32 whether one is found is
    decided by rounding (epsilon 1e-8 or 1e-3 under a one-ulp change)."""
    m, d = g6.shape[-2:]
    lead = g6.shape[:-2]
    if m < d:   # no 6-D interior: no facet planes, epsilon 0
        return torch.zeros(lead, dtype=g6.dtype, device=g6.device)
    g = g6.to(torch.float64)
    subsets = torch.as_tensor(_six_subsets(m), device=g6.device)
    best = torch.full(lead, torch.inf, dtype=g.dtype, device=g6.device)
    for c0 in range(0, subsets.shape[0], _SUBSET_CHUNK):
        idx = subsets[c0:c0 + _SUBSET_CHUNK]                       # (T, 6)
        n = _solve_ones_batched(g[..., idx, :])            # (..., T, 6)
        side = n @ g.transpose(-1, -2)                     # (..., T, M)
        supporting = (side <= 1.0 + 1e-4).all(dim=-1)
        nn = torch.linalg.norm(n, dim=-1)
        ok = supporting & torch.isfinite(nn) & (nn > 1e-30)
        dist = torch.where(ok, 1.0 / torch.clamp(nn, min=1e-30), torch.inf)
        best = torch.minimum(best, dist.amin(dim=-1))
    return torch.where(torch.isfinite(best), best, 0.0).to(g6.dtype)


def _hull_guard(mn, coeffs, d, wrench_norm_thresh):
    """Origin in the hull with full-dimensional support (> d - 1 active
    coefficients): the reference's guards before the facet enumeration."""
    return (mn <= wrench_norm_thresh) & ((coeffs > 1e-4).sum(-1) > d - 1)


def ferrari_canny_l1_device(g6,
                            wrench_norm_thresh: float = DEFAULT_WRENCH_NORM_THRESH,
                            wrench_regularizer: float = DEFAULT_WRENCH_REGULARIZER,
                            num_iters: int = 300):
    """6-D epsilon of one (M, 6) wrench set with no host library
    (quality.py:516-550): 0 unless the hull guards hold, else the exact
    facet-plane enumeration. Returns a 0-d tensor."""
    g6 = torch.as_tensor(g6, dtype=torch.float32)
    mn, coeffs = min_norm_in_simplex(g6, num_iters=num_iters,
                                     wrench_regularizer=wrench_regularizer)
    if not bool(_hull_guard(mn, coeffs, g6.shape[-1], wrench_norm_thresh)):
        return torch.zeros((), dtype=torch.float32, device=g6.device)
    return _boundary_distance_6d(g6)


def ferrari_canny_l1_device_batch(
        g6_batch, valid=None,
        wrench_norm_thresh: float = DEFAULT_WRENCH_NORM_THRESH,
        wrench_regularizer: float = DEFAULT_WRENCH_REGULARIZER,
        num_iters: int = 300, group: int = 32):
    """6-D epsilon of (G, M, 6) wrench sets (quality.py:553-628): the hull
    guards for all grasps at once, then the facet enumeration for the
    accepted grasps only, ``group`` grasps at a time, scattered back.
    ``valid``: optional (G,) mask (contacts found, cones computable).
    Returns (G,) qualities, 0 where rejected. Rejected grasps are forward
    only: they never reach the enumeration (the JAX package's masked
    lanes, quality.py:623)."""
    g6_batch = torch.as_tensor(g6_batch, dtype=torch.float32)
    g = g6_batch.shape[0]
    mn, coeffs = min_norm_in_simplex_batch(
        g6_batch, num_iters=num_iters, wrench_regularizer=wrench_regularizer)
    ok = _hull_guard(mn, coeffs, g6_batch.shape[2], wrench_norm_thresh)
    if valid is not None:
        ok = ok & valid
    eps = torch.zeros(g, dtype=torch.float32, device=g6_batch.device)
    rows = torch.nonzero(ok)[:, 0]
    for c0 in range(0, rows.shape[0], max(1, group)):
        sel = rows[c0:c0 + group]
        eps[sel] = _boundary_distance_6d(g6_batch[sel])
    return eps


def force_closure_qp(g, wrench_norm_thresh: float = DEFAULT_WRENCH_NORM_THRESH,
                     wrench_regularizer: float = DEFAULT_WRENCH_REGULARIZER,
                     num_iters: int = 300):
    """QP force closure: is 0 in the convex hull of the wrench rows (M, d)?
    (quality.py:285-320)."""
    min_norm, _ = min_norm_in_simplex(g, num_iters=num_iters,
                                      wrench_regularizer=wrench_regularizer)
    return (min_norm < wrench_norm_thresh).to(torch.int32)


# ---------------------------------------------------------------------------
# Spectral wrench-space metrics (quality.py:441-525)
# ---------------------------------------------------------------------------

def min_singular(g):
    """Minimum singular value of the grasp map (quality.py:441-465)."""
    return torch.linalg.svdvals(g)[..., -1]


def wrench_volume(g, k: float = 1.0):
    """k * sqrt(prod sigma_i) (quality.py:467-495)."""
    return k * sqrt(torch.prod(torch.linalg.svdvals(g), dim=-1))


def grasp_isotropy(g):
    """sigma_min / sigma_max, 0 when degenerate (quality.py:497-525)."""
    s = torch.linalg.svdvals(g)
    ratio = s[..., -1] / torch.clamp(s[..., 0], min=1e-30)
    return torch.where(s[..., 0] > 0, ratio, 0.0)


def partial_closure(g_per_finger, target_wrench, force_limit,
                    num_fingers: int, wrench_norm_thresh: float = 1e-3,
                    wrench_regularizer: float = DEFAULT_WRENCH_REGULARIZER):
    """1 where the contacts resist the target wrench under per-finger force
    limits (quality.py:322-375)."""
    ok, _ = wrench_in_positive_span(
        g_per_finger, target_wrench, force_limit, num_fingers=num_fingers,
        wrench_norm_thresh=wrench_norm_thresh,
        wrench_regularizer=wrench_regularizer)
    return ok.to(torch.int32)


def wrench_resistance(g_per_finger, target_wrench, force_limit,
                      num_fingers: int, wrench_norm_thresh: float = 1e-3,
                      wrench_regularizer: float = DEFAULT_WRENCH_REGULARIZER,
                      finger_force_eps: float = 1e-9):
    """Inverse norm of the finger forces that resist the target wrench, 0
    when it cannot be resisted (quality.py:377-439)."""
    ok, lam_norm = wrench_in_positive_span(
        g_per_finger, target_wrench, force_limit, num_fingers=num_fingers,
        wrench_norm_thresh=wrench_norm_thresh,
        wrench_regularizer=wrench_regularizer)
    return torch.where(ok, 1.0 / torch.clamp(lam_norm, min=finger_force_eps),
                       0.0)


def wrench_in_positive_span(wrench_basis, target_wrench, force_limit,
                            num_fingers: int = 1,
                            wrench_norm_thresh: float = 1e-4,
                            wrench_regularizer: float = DEFAULT_WRENCH_REGULARIZER,
                            num_iters: int = 400):
    """Do positive combinations of the basis rows (M, d), within per-finger
    L1 force limits, produce the target wrench? (quality.py:725-784), by
    projected gradient. Returns (resisted (bool tensor), ||lambda||)."""
    m = wrench_basis.shape[0]
    per = m // num_fingers
    dt, dev = wrench_basis.dtype, wrench_basis.device
    gram = (wrench_basis @ wrench_basis.T
            + wrench_regularizer * torch.eye(m, dtype=dt, device=dev))
    q = -(wrench_basis @ target_wrench)
    step = 1.0 / (2.0 * torch.clamp(torch.trace(gram), min=1e-12))
    idxs = torch.arange(1, per + 1, dtype=dt, device=dev)

    def project(x):
        # exact projection onto {x >= 0, per-finger sum <= F}: clip, then
        # put each over-budget finger block on the scaled simplex
        xf = torch.clamp(x.reshape(num_fingers, per), min=0.0)
        s = xf.sum(dim=1, keepdim=True)
        u = torch.sort(xf, dim=1, descending=True)[0]
        css = torch.cumsum(u, dim=1) - force_limit
        rho = torch.clamp(torch.sum(u - css / idxs > 0, dim=1), min=1)
        theta = torch.gather(css, 1, (rho - 1)[:, None]) / rho[:, None].to(dt)
        projected = torch.clamp(xf - theta, min=0.0)
        return torch.where(s > force_limit, projected, xf).reshape(m)

    x = y = torch.zeros(m, dtype=dt, device=dev)
    for mom in _momenta(num_iters):
        x_new = project(y - step * (2.0 * (gram @ y) + 2.0 * q))
        y = x_new + mom * (x_new - x)
        x = x_new
    residual = wrench_basis.T @ x - target_wrench
    return (residual * residual).sum() < wrench_norm_thresh, \
        torch.linalg.norm(x)
