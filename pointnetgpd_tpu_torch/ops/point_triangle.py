"""Min point-triangle distance: the voxelizer's distance pass (kernel K3).

Port of ``pointnetgpd_tpu/ops/point_triangle_pallas.py``. For every grid
point, the minimum squared distance to a triangle set.

- ``morton_order``, ``pack_triangles``, ``blocked_grid``: host-side numpy
  packers, equal to the JAX package's arrays. Grid points come in spatially
  compact blocks of 128 (4x4x8 cells); triangles are Morton-sorted into
  supertiles of 128 rows of 16 floats, each supertile with a bounding sphere.
- ``min_point_triangle_dist2_torch`` / ``unsigned_distance_torch``: the plain
  version, the counterpart of ``mesh_to_sdf._unsigned_distance``: the
  closed-form closest point on each triangle (Ericson §5.1.5, the variant of
  ``grasping/quality.py closest_point_on_triangle_to_origin``), brute force
  over every triangle, chunked over points so memory stays bounded.
- ``min_point_triangle_dist2``: takes the plain version for CPU tensors and
  launches ``csrc/point_triangle.cu`` for CUDA tensors (or raises). The
  kernel prunes supertiles that cannot beat a block's running bound; the
  minimum it returns does not depend on what it skips.

The kernel follows the Pallas body's Ericson variant (edge priority
bc < ac < ab, then c < b < a, denominators ``max(den, 1e-30)``), the plain
version the oracle's (clipped parameters, the opposite priority); the two
agree to rounding, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .cloud import morton_codes

BLOCK_POINTS = 128       # points per CUDA block, one per thread
SUPER = 128              # triangles per supertile (pruning granularity)
_FAR = 1.0e8             # padding sentinel coordinate
# plain version: (points x triangles) per chunk; about 50 float32
# temporaries of that size are alive at once (3.4 GB on the card, 52 MB here)
_PAIRS_PER_CHUNK = {"cuda": 1 << 24, "cpu": 1 << 18}

launches = 0             # kernel launches (CUDA path only)


def morton_order(centroids: np.ndarray, bits: int = 10) -> np.ndarray:
    """Sort order by Morton code of quantized 3-D positions (host-side)."""
    code = morton_codes(torch.from_numpy(np.asarray(centroids, np.float32)),
                        bits=bits).numpy()
    return np.argsort(code, kind="stable")


def pack_triangles(tri_v: np.ndarray):
    """(F, 3, 3) float triangle vertices -> (tri_data (Fp, 16) f32,
    sup_data (Sp, 8) f32), Morton-sorted, padded to a SUPER multiple.

    tri_data columns: ax ay az bx by bz cx cy cz 0 0 0 0 0 0 0.
    sup_data columns: scx, scy, scz, sr (bounding sphere of each supertile's
    triangles), rest zero.
    """
    tri_v = np.asarray(tri_v, np.float32)
    f = tri_v.shape[0]
    cent = tri_v.mean(axis=1)
    order = morton_order(cent)
    tri_v = tri_v[order]

    f_pad = max(-(-f // SUPER) * SUPER, SUPER)
    data = np.zeros((f_pad, 16), np.float32)
    data[f:, 0:9] = _FAR      # degenerate far triangle: A=B=C=(FAR,FAR,FAR)
    data[:f, 0:3] = tri_v[:, 0]
    data[:f, 3:6] = tri_v[:, 1]
    data[:f, 6:9] = tri_v[:, 2]

    s = f_pad // SUPER
    sup = np.zeros((s, 8), np.float32)
    sup[:, 0:3] = _FAR        # padded supertiles: far away, never processed
    verts_flat = data[:, 0:9].reshape(f_pad, 3, 3)
    for i in range(s):
        vv = verts_flat[i * SUPER:(i + 1) * SUPER].reshape(-1, 3)
        vv = vv[(np.abs(vv) < _FAR / 2).all(axis=1)]
        if len(vv) == 0:      # all-padding supertile
            continue
        sc = 0.5 * (vv.min(axis=0) + vv.max(axis=0))
        sup[i, 0:3] = sc
        sup[i, 3] = np.linalg.norm(vv - sc, axis=1).max()
    return data, sup


def blocked_grid(dim_x: int, dim_y: int, dim_z: int, origin, res,
                 block=(4, 4, 8)):
    """Grid points of a (dim_x, dim_y, dim_z) lattice in spatially-blocked
    order (each 128 consecutive points = one (4,4,8) cell block), plus the
    inverse mapping.

    Returns (points (P, 3) f32 numpy with P % 128 == 0, unblock) where
    ``unblock(flat)`` maps the kernel's (P,) output (a tensor on any device,
    or an array) back to a tensor of shape (dim_x, dim_y, dim_z).
    """
    bx, by, bz = block
    nx = -(-dim_x // bx) * bx
    ny = -(-dim_y // by) * by
    nz = -(-dim_z // bz) * bz
    ii, jj, kk = np.meshgrid(np.arange(nx, dtype=np.float32),
                             np.arange(ny, dtype=np.float32),
                             np.arange(nz, dtype=np.float32), indexing="ij")
    pts = np.asarray(origin, np.float32) + np.float32(res) * np.stack(
        [ii, jj, kk], axis=-1)
    blocked = pts.reshape(nx // bx, bx, ny // by, by, nz // bz, bz, 3)
    blocked = blocked.transpose(0, 2, 4, 1, 3, 5, 6).reshape(-1, 3)

    def unblock(flat):
        a = torch.as_tensor(flat).reshape(nx // bx, ny // by, nz // bz,
                                          bx, by, bz)
        a = a.permute(0, 3, 1, 4, 2, 5).reshape(nx, ny, nz)
        return a[:dim_x, :dim_y, :dim_z]

    return np.ascontiguousarray(blocked), unblock


def _closest_dist2(a, b, c):
    """Squared distance from the origin to triangles (a, b, c), each a tuple
    of 3 coordinate tensors of one shape: the oracle's closest point
    (quality.py:265-315) with its clipped parameters and region priority."""
    ab = [b[i] - a[i] for i in range(3)]
    ac = [c[i] - a[i] for i in range(3)]

    def dot(u, v):
        return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]

    d1 = -dot(ab, a)
    d2 = -dot(ac, a)
    d3 = -dot(ab, b)
    d4 = -dot(ac, b)
    d5 = -dot(ab, c)
    d6 = -dot(ac, c)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    in_vert_a = (d1 <= 0) & (d2 <= 0)
    in_vert_b = (d3 >= 0) & (d4 <= d3)
    in_vert_c = (d6 >= 0) & (d5 <= d6)
    in_edge_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_edge_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    e43, e56 = d4 - d3, d5 - d6
    in_edge_bc = (va <= 0) & (e43 >= 0) & (e56 >= 0)

    def safe_div(num, den):
        return num / torch.where(den == 0, 1.0, den)

    t_ab = torch.clamp(safe_div(d1, d1 - d3), 0, 1)
    t_ac = torch.clamp(safe_div(d2, d2 - d6), 0, 1)
    t_bc = torch.clamp(safe_div(e43, e43 + e56), 0, 1)
    denom_sum = va + vb + vc
    denom = torch.where(denom_sum == 0, 1.0, denom_sum)
    v, w = vb / denom, vc / denom

    out = 0.0
    for i in range(3):
        p = a[i] + v * ab[i] + w * ac[i]
        p = torch.where(in_edge_ab, a[i] + t_ab * ab[i], p)
        p = torch.where(in_edge_ac, a[i] + t_ac * ac[i], p)
        p = torch.where(in_edge_bc, b[i] + t_bc * (c[i] - b[i]), p)
        p = torch.where(in_vert_a, a[i], p)
        p = torch.where(in_vert_b, b[i], p)
        p = torch.where(in_vert_c, c[i], p)
        out = out + p * p
    return out


def _min_dist2_plain(points, verts):
    """(P,) min squared distance from points (P, 3) to triangles given as
    verts (F, 9) = [a, b, c]; brute force, chunked over points."""
    p_total, f = points.shape[0], verts.shape[0]
    out = torch.empty((p_total,), dtype=torch.float32, device=points.device)
    chunk = max(1, _PAIRS_PER_CHUNK[points.device.type] // max(f, 1))
    for c0 in range(0, p_total, chunk):
        q = points[c0:c0 + chunk]
        a, b, c = ([verts[None, :, 3 * k + i] - q[:, i, None] for i in range(3)]
                   for k in range(3))
        out[c0:c0 + chunk] = _closest_dist2(a, b, c).amin(dim=1)
    return out


def min_point_triangle_dist2_torch(points_blocked, tri_data, sup_data=None):
    """Plain version of the kernel: (P,) min squared distance from each
    point to every triangle row of ``tri_data`` (padding rows included; they
    sit at _FAR and never win). ``sup_data`` is accepted for the kernel's
    signature and not used: the plain version never prunes."""
    return _min_dist2_plain(points_blocked.float(),
                            tri_data[:, 0:9].float())


def unsigned_distance_torch(points, tri_v):
    """(P,) min distance from each point (P, 3) to the triangles (F, 3, 3):
    the counterpart of ``mesh_to_sdf._unsigned_distance``."""
    d2 = _min_dist2_plain(points.float(), tri_v.float().reshape(-1, 9))
    return torch.sqrt(d2)


def min_point_triangle_dist2(points_blocked, tri_data, sup_data):
    """(P,) min SQUARED distance from each point to the triangle set.

    points_blocked: (P, 3) f32, P a multiple of 128, ordered so that each
        consecutive 128 points are spatially compact (any order is correct,
        a compact one prunes more).
    tri_data, sup_data: from ``pack_triangles``, on the points' device.
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if not points_blocked.is_cuda:
        return min_point_triangle_dist2_torch(points_blocked, tri_data,
                                              sup_data)
    return _launch(points_blocked, tri_data, sup_data)


def _launch(points, tri_data, sup_data):
    global launches
    p = points.shape[0]
    n_rows = tri_data.shape[0]
    n_sup = sup_data.shape[0]
    want = {"points": (points, (p, 3)), "tri_data": (tri_data, (n_rows, 16)),
            "sup_data": (sup_data, (n_sup, 8))}
    for name, (t, shape) in want.items():
        if (t.dim() != 2 or tuple(t.shape) != shape
                or t.dtype != torch.float32 or t.device != points.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{points.device}, got {tuple(t.shape)} "
                             f"{t.dtype} {t.device}")
    if p % BLOCK_POINTS:
        raise ValueError(f"the point count must be a multiple of "
                         f"{BLOCK_POINTS}, got {p}")
    if tri_data.data_ptr() % 16 or sup_data.data_ptr() % 16:
        raise ValueError("tri_data and sup_data must be 16-byte aligned "
                         "(the kernel reads them as float4)")
    if n_sup < 1 or n_rows != n_sup * SUPER:
        raise ValueError(f"tri_data must hold {SUPER} rows per supertile: "
                         f"{n_rows} rows, {n_sup} supertiles")
    out = torch.empty((p,), dtype=torch.float32, device=points.device)
    if p == 0:
        return out
    err = _build.library().point_triangle_launch(
        points.data_ptr(), p // BLOCK_POINTS, tri_data.data_ptr(),
        sup_data.data_ptr(), n_sup, out.data_ptr(),
        torch.cuda.current_stream(points.device).cuda_stream)
    _build.check(err, "point_triangle_launch")
    launches += 1
    return out
