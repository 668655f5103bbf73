"""Point-cloud preprocessing: voxel downsampling and KNN normal estimation.

Port of ``pointnetgpd_tpu/ops/cloud.py`` (the reference's VoxelGrid and pcl
NormalEstimation KSearch=30 with camera-consistent flipping,
kinect2grasp.py:102-144). Differences that keep results equal:

- neighbor selection is always exact and breaks distance ties toward the
  lower index, as ``lax.top_k`` does (a stable sort); ``approx_min_k`` is a
  TPU-only choice and the JAX CPU path is exact too;
- squared distances, voxel centers and sums of squares round as the JAX
  package does on the CPU (``ops/fp.py``): voxel-center clouds sit on a
  regular grid, where many neighbors are at exactly equal distances;
  the voxel step is ``span * float32(1 / n_grid)``, as XLA computes it;
- Morton codes are int64 (torch's uint32 bit ops are incomplete); sorts by
  them are stable, as ``jnp.argsort`` is.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from . import knn_normals
from .fp import dot3, fma, sqrt, sumsq3


def voxel_downsample(points, n_grid: int = 500):
    """Occupied-voxel-center downsampling (voxelgrid.py:89-160). Returns
    (centers (P, 3), mask (P,)): row i is the center of point i's voxel,
    kept only for the first point landing in each voxel; masked rows are 0."""
    p = points.shape[0]
    if p == 0:
        return (torch.zeros((0, 3), dtype=points.dtype, device=points.device),
                torch.zeros((0,), dtype=torch.bool, device=points.device))
    lo = points.amin(dim=0)
    hi = points.amax(dim=0)
    span = torch.clamp(hi - lo, min=1e-9)
    # XLA rewrites the division by the constant grid size as a product
    # with its float32 reciprocal; the port rounds the same way
    step = span * torch.tensor(1.0 / n_grid, dtype=points.dtype,
                               device=points.device)
    idx = torch.clamp(((points - lo) / step).to(torch.int32), 0, n_grid - 1)
    centers = fma(idx.to(points.dtype) + 0.5, step, lo)
    vid = (idx[:, 0] * n_grid + idx[:, 1]) * n_grid + idx[:, 2]
    order = torch.argsort(vid, stable=True)
    sorted_vid = vid[order]
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=points.device),
                       sorted_vid[1:] != sorted_vid[:-1]])
    mask = torch.zeros((p,), dtype=torch.bool, device=points.device)
    mask[order] = first
    return torch.where(mask[:, None], centers, 0.0), mask


def voxel_downsample_packed(points, n_grid: int = 500, pad_value=-1e6):
    """``voxel_downsample`` compacted on the device: kept centers packed to
    the front (original order), the tail filled with ``pad_value``.
    Returns (packed (P, 3), count (0-d int32 tensor))."""
    centers, mask = voxel_downsample(points, n_grid=n_grid)
    p = points.shape[0]
    if p == 0:
        return centers, torch.zeros((), dtype=torch.int32, device=points.device)
    ar = torch.arange(p, device=points.device)
    pos = ar + torch.where(mask, 0, p)
    packed = centers[torch.argsort(pos, stable=True)]
    count = mask.sum().to(torch.int32)
    packed = torch.where((ar < count)[:, None], packed,
                         torch.as_tensor(pad_value, dtype=points.dtype,
                                         device=points.device))
    return packed, count


def morton_codes(points, bits: int = 10, bbox=None):
    """(N, 3) points -> (N,) int64 Morton (Z-order) codes over the points'
    own bounding box, or ``bbox=(lo, hi)`` when the array carries far
    sentinel padding."""
    if bbox is None:
        lo = points.amin(dim=0)
        hi = points.amax(dim=0)
    else:
        lo, hi = (torch.as_tensor(b, dtype=points.dtype, device=points.device)
                  for b in bbox)
    span = torch.clamp(hi - lo, min=1e-12)
    top = float(2 ** bits - 1)
    q = torch.clamp((points - lo) / span * top, 0.0, top).to(torch.int64)
    code = torch.zeros(points.shape[:1], dtype=torch.int64,
                       device=points.device)
    for b in range(bits):
        for a in range(3):
            code = code | (((q[:, a] >> b) & 1) << (3 * b + a))
    return code


def _eberly_shifted(a):
    """Shift by the mean eigenvalue and scale to O(1): eigenvalues of ``b``
    are 2p cos(phi + 2 pi k / 3), k=0 largest, k=1 smallest."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    q = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)[..., None, None] / 3.0
    a_c = a - q * eye
    scale = torch.amax(torch.abs(a_c), dim=(-2, -1), keepdim=True)
    tiny = torch.tensor(1e-30, dtype=a.dtype, device=a.device)
    b = a_c / torch.maximum(scale, tiny)
    p = sqrt(torch.sum(b * b, dim=(-2, -1), keepdim=True) / 6.0)
    c = b / torch.maximum(p, tiny)
    r = torch.clamp(torch.linalg.det(c)[..., None, None] / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    return b, p, phi, scale, tiny


def _eigvec_for(b, lam, scale, tiny, fallback_axis):
    """Unit eigenvector of ``b`` for the extreme eigenvalue ``lam``: the
    largest pairwise cross product of the rows of (b - lam I)."""
    m = b - lam * torch.eye(3, dtype=b.dtype, device=b.device)
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1),
                         torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], dim=-2)
    norms = torch.linalg.norm(cands, dim=-1)
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 3))[..., 0, :]
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    fallback = torch.zeros_like(v)
    fallback[..., fallback_axis] = 1.0
    degenerate = (n < 1e-12) | (scale[..., 0] < tiny)
    return torch.where(degenerate, fallback, v / torch.maximum(n, tiny))


def smallest_eigvec_sym3x3(a):
    """Closed-form least-eigenvalue unit eigenvector of batched symmetric
    3x3 matrices (Eberly); isotropic inputs return [0, 0, 1]."""
    b, p, phi, scale, tiny = _eberly_shifted(a)
    lam_min = 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)
    return _eigvec_for(b, lam_min, scale, tiny, 2)


def extreme_eigvecs_sym3x3(a):
    """(least, greatest)-eigenvalue eigenvectors, guaranteed orthonormal
    (the GPG local frame's (minor, normal) pair)."""
    b, p, phi, scale, tiny = _eberly_shifted(a)
    lam_min = 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)
    lam_max = 2.0 * p * torch.cos(phi)
    v_min = _eigvec_for(b, lam_min, scale, tiny, 2)
    v_max = _eigvec_for(b, lam_max, scale, tiny, 0)
    v_min = v_min - torch.sum(v_min * v_max, dim=-1, keepdim=True) * v_max
    n = torch.linalg.norm(v_min, dim=-1, keepdim=True)
    least = torch.argmin(torch.abs(v_max), dim=-1)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    axis = eye[least]
    alt = torch.linalg.cross(v_max, axis)
    alt = alt / torch.maximum(torch.linalg.norm(alt, dim=-1, keepdim=True),
                              tiny)
    v_min = torch.where(n < 1e-6, alt, v_min / torch.maximum(n, tiny))
    return v_min, v_max


def pairwise_d2(a, b, b_sq=None):
    """Squared distances |a_i - b_j|^2 in the matmul form
    |a|^2 - 2 a.b + |b|^2 -> (..., N, M); a (..., N, 3), b (..., M, 3)."""
    cross = dot3(a[..., :, None, 0], b[..., None, :, 0],
                 a[..., :, None, 1], b[..., None, :, 1],
                 a[..., :, None, 2], b[..., None, :, 2])
    if b_sq is None:
        b_sq = sumsq3(b)
    return (sumsq3(a)[..., :, None] - 2.0 * cross) + b_sq[..., None, :]


def min_k(d2, k: int, exact: bool = False):
    """(values, indices) of the k smallest entries along the last axis,
    exact, ties toward the lower index (``lax.top_k(-d2, k)``). ``exact`` is
    the JAX package's switch away from ``lax.approx_min_k`` on the TPU; it
    changes nothing here, since the selection is always exact (as JAX's is
    on every other backend)."""
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _plane_normals(nbr_pts):
    """(..., k, 3) neighbor sets -> least-eigenvector of their covariance."""
    centered = nbr_pts - nbr_pts.mean(dim=-2, keepdim=True)
    cov = torch.einsum("...ki,...kj->...ij", centered, centered)
    return smallest_eigvec_sym3x3(cov)


def _orient(normals, points, camera_pos):
    """Flip toward the camera (kinect2grasp.py:137-144) and normalize."""
    flip = torch.sum((camera_pos - points) * normals, dim=-1) < 0
    normals = torch.where(flip[..., None], -normals, normals)
    return normals / torch.clamp(torch.linalg.norm(normals, dim=-1,
                                                   keepdim=True), min=1e-12)


def estimate_normals_knn(points, camera_pos, *, k: int = 30,
                         chunk: int = 1024, exact: bool = False):
    """Per-point normals by exact k-NN plane fitting, flipped toward the
    camera. points (P, 3), or (B, P, 3) for B clouds at once; camera_pos
    (3,). On a CUDA device one launch of K5 (``ops/knn_normals.py``, span
    ``normals.kernel``); on the CPU ``_normals_plain``, in query chunks of
    ``chunk`` that bound memory. ``exact``: a no-op (see ``min_k``)."""
    if knn_normals.takes(points):
        with span("normals.kernel"):
            return knn_normals.normals(points, camera_pos, k=k)
    return _normals_plain(points, camera_pos, k=k, chunk=chunk)


def _normals_plain(points, camera_pos, *, k: int = 30, chunk: int = 1024):
    """K5's plain version: ``pairwise_d2`` rows of ``chunk`` queries,
    ``min_k``, ``_plane_normals`` and ``_orient``."""
    p_total = points.shape[-2]
    k = min(k, p_total)
    if k == 0:
        return torch.zeros_like(points)
    pts = points if points.dim() == 3 else points[None]
    bi = torch.arange(pts.shape[0], device=pts.device)[:, None, None]
    p_sq = sumsq3(pts)
    out = []
    for q0 in range(0, p_total, chunk):
        queries = pts[:, q0:q0 + chunk]
        _, nbr = min_k(pairwise_d2(queries, pts, b_sq=p_sq), k)
        out.append(_plane_normals(pts[bi, nbr]))
    cam = torch.as_tensor(camera_pos, dtype=points.dtype, device=points.device)
    normals = _orient(torch.cat(out, dim=1), pts, cam)
    return normals if points.dim() == 3 else normals[0]


def _window_chunk_normals(ps, queries, starts, *, k, window, chunk_group):
    """Plane normals of the (C, Q, 3) query chunks, chunk c searching the
    ``window`` sorted points of ``ps`` from ``starts[c]``: (C * Q, 3)."""
    q_chunk = queries.shape[1]
    win = torch.arange(window, device=ps.device)
    out = []
    for c0 in range(0, queries.shape[0], chunk_group):
        st = starts[c0:c0 + chunk_group]
        cand = ps[st[:, None] + win]                        # (C, W, 3)
        _, nbr = min_k(pairwise_d2(queries[c0:c0 + chunk_group], cand), k)
        nbr_pts = torch.gather(
            cand[:, None].expand(-1, q_chunk, -1, -1), 2,
            nbr[..., None].expand(-1, -1, -1, 3))           # (C, Q, k, 3)
        out.append(_plane_normals(nbr_pts).reshape(-1, 3))
    return torch.cat(out)


def estimate_normals_knn_window(points, camera_pos, *, k: int = 30,
                                window: int = 2048, q_chunk: int = 256,
                                exact: bool = False, bbox=None,
                                chunk_group: int = 16, mesh=None):
    """Morton-window KNN normals: each chunk of ``q_chunk`` consecutive
    Morton-sorted points searches only a ``window`` of surrounding sorted
    points (O(P * window)). ``bbox``: the real cloud's box when ``points``
    carries far sentinel padding. ``mesh`` (a ``parallel.mesh.Mesh``; JAX
    ``:209-299``): the query chunks are split over its shards, each with the
    sorted cloud on its device, and gathered once. As in the JAX package,
    the sorted cloud is padded to a multiple of ``q_chunk`` times the shard
    count and the window starts are clipped to the padded length, so the
    tail chunks' windows move with the shard count: equal to JAX at the
    same mesh size, not to the unsharded normals there. ``exact``: a no-op
    (see ``min_k``)."""
    p_total = points.shape[0]
    if p_total <= max(window, q_chunk) or p_total <= k:
        return estimate_normals_knn(points, camera_pos, k=k)
    dev = points.device
    order = torch.argsort(morton_codes(points, bits=10, bbox=bbox),
                          stable=True)
    ps = points[order]
    ndev = 1 if mesh is None else mesh.size
    pad = (-p_total) % (q_chunk * ndev)
    p_pad = p_total + pad
    if pad:
        ps = torch.cat([ps, torch.full((pad, 3), 1e9, dtype=points.dtype,
                                       device=dev)])
    n_chunks = p_pad // q_chunk
    starts = torch.clamp(
        torch.arange(n_chunks, device=dev) * q_chunk + q_chunk // 2
        - window // 2, 0, p_pad - window)
    queries = ps.reshape(n_chunks, q_chunk, 3)
    kw = dict(k=k, window=window, chunk_group=chunk_group)
    if mesh is None:
        normals_sorted = _window_chunk_normals(ps, queries, starts, **kw)
    else:
        from ..parallel import mesh as pmesh

        normals_sorted = pmesh.gather(pmesh.run_shards(
            mesh, lambda s, p, q, st: _window_chunk_normals(p, q, st, **kw),
            pmesh.replicate(ps, mesh), pmesh.shard_batch(queries, mesh),
            pmesh.shard_batch(starts, mesh)), dev)
    normals_sorted = normals_sorted[:p_total]
    normals = torch.zeros_like(points)
    normals[order] = normals_sorted
    cam = torch.as_tensor(camera_pos, dtype=points.dtype, device=dev)
    return _orient(normals, points, cam)


def seed_window_normals(points, seed_idx, camera_pos, *, k: int = 30,
                        knn: int = 100, window: int = 2048,
                        exact: bool = False, bbox=None,
                        seed_chunk: int = 32):
    """Normals for each seed's ``knn`` nearest neighbors only (the lazy
    alternative to all-P normals). Returns (pd2 (S, knn) squared seed ->
    neighbor distances, nbr_normals (S, knn, 3), seed_normals (S, 3)).
    ``exact`` and ``seed_chunk`` are accepted for the JAX package's callers
    and change nothing: the selection is always exact (``min_k``), and all
    seeds run as one batch (JAX's ``seed_chunk`` sizes the blocks of its
    sequential map)."""
    p_total = points.shape[0]
    dev = points.device
    cam = torch.as_tensor(camera_pos, dtype=points.dtype, device=dev)

    if p_total <= 2 * window or p_total <= knn:
        normals = estimate_normals_knn(points, cam, k=k)
        kk = min(knn, p_total)
        pd2, nbr = min_k(pairwise_d2(points[seed_idx], points), kk)
        if kk < knn:
            # far pd2 sentinel: the consumer's r-ball filter masks the pad
            pd2 = torch.nn.functional.pad(pd2, (0, knn - kk), value=1e9)
            nbr = torch.cat([nbr, nbr[:, -1:].expand(-1, knn - kk)], dim=1)
        return pd2, normals[nbr], normals[seed_idx]

    kk = min(knn, window)
    kf = min(k, window)
    order = torch.argsort(morton_codes(points, bits=10, bbox=bbox),
                          stable=True)
    rank = torch.argsort(order, stable=True)
    ps = points[order]
    starts = torch.clamp(rank[seed_idx] - window // 2, 0, p_total - window)
    seeds_xyz = points[seed_idx]
    cand = ps[starts[:, None] + torch.arange(window, device=dev)]  # (S, W, 3)
    pd2, nb = min_k(sumsq3(cand - seeds_xyz[:, None, :]), kk)      # (S, K)
    nbr_pts = torch.gather(cand, 1, nb[..., None].expand(-1, -1, 3))
    _, nb2 = min_k(pairwise_d2(nbr_pts, cand), kf)                 # (S, K, k)
    s, w = cand.shape[:2]
    pts_k = torch.gather(cand[:, None].expand(-1, kk, -1, -1), 2,
                         nb2[..., None].expand(-1, -1, -1, 3))     # (S,K,k,3)
    n_k = _orient(_plane_normals(pts_k), nbr_pts, cam)
    sn = n_k[torch.arange(s, device=dev), torch.argmin(pd2, dim=1)]
    if kk < knn:
        pd2 = torch.nn.functional.pad(pd2, (0, knn - kk), value=1e9)
        n_k = torch.cat([n_k, n_k[:, -1:].expand(-1, knn - kk, -1)], dim=1)
    return pd2, n_k, sn
