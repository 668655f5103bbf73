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
  kernel walks a block's supertiles in the order of their lower bounds and
  stops at the first that cannot beat the block's running bound (above
  ``SORT_CHUNK`` supertiles, chunk by chunk: the chunk holding the nearest
  supertile first, then the others in index order, each walked the same
  way); inside a supertile each warp skips the triangles whose bounding
  sphere cannot beat the warp's own bound. The minimum it returns does not
  depend on what it skips.
- ``stage_triangles``, ``pair_dist2_staged``, ``supertile_bounds``,
  ``kernel_walk``, ``warp_pairs_needed``: the kernel's arithmetic and walk
  once more in plain torch, for the tests and for counting what a walk
  visits and what it needs (``chip_smoke.py``); no caller's path runs them.

The kernel follows the Pallas body's Ericson region tests and priority
(edge bc < ac < ab, then c < b < a, denominators ``max(den, 1e-30)``) with
a division-free body: per-triangle constants and reciprocals, two dot
products for the region tests, the face weights as dot products with two
per-triangle vectors, the closest point as ``a + s ab + t ac`` with
clamped edge parameters, each triangle rotated so that bc is its shortest
edge. The plain version is the oracle's (clipped parameters, the opposite
priority); the two agree to rounding, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .cloud import morton_codes
from .fp import sqrt

BLOCK_POINTS = 128       # points per CUDA block, one per thread
SUPER = 128              # triangles per supertile (pruning granularity)
_FAR = 1.0e8             # padding sentinel coordinate
_EPS = 1.0e-30           # the Pallas body's denominator guard
SORT_CHUNK = 16384       # supertiles the kernel sorts at a time in shared memory
WARP = 32                # points per warp: a 2x4x4 slab of a block
_SPHERE_MARGIN = 1.0 + 2.0 ** -16   # the kernel's triangle-sphere margin
# plain version: (points x triangles) per chunk; about 50 float32
# temporaries of that size are alive at once (3.4 GB on the card, 52 MB here)
_PAIRS_PER_CHUNK = {"cuda": 1 << 24, "cpu": 1 << 18}

launches = 0             # kernel launches (CUDA path only)


def _warp_order():
    """The block's point index of each (warp, lane) of the kernel: a point
    (ix, iy, iz) of the 4x4x8 cells sits at ix*32 + iy*8 + iz, and warp w
    holds the 2x4x4 slab ix in 2*(w // 2) + {0, 1}, iz in 4*(w % 2) + 0..3."""
    w, lane = np.divmod(np.arange(BLOCK_POINTS), WARP)
    ix = 2 * (w >> 1) + (lane >> 4)
    iz = 4 * (w & 1) + (lane & 3)
    return torch.from_numpy(ix * 32 + ((lane >> 2) & 3) * 8 + iz)


_WARP_ORDER = _warp_order()


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
    return sqrt(d2)


def stage_triangles(tri_data):
    """What the kernel stages for each triangle row of ``tri_data``:
    (consts (F, 24), spheres (F, 4)), float32, in its shared-memory order.

    Each triangle's vertices are rotated so that bc is its shortest edge.
    consts: a (3), |ab|^2, ab (3), |ac|^2, ac (3), kb = ab.ac - |ab|^2,
    u_v = (ac x n) / |n|^2 (3), |n|^2, u_w = (n x ab) / |n|^2 (3),
    1 / |ab|^2, 1 / |ac|^2, 1 / |bc|^2, -kb / |bc|^2, kc = |ac|^2 - ab.ac,
    for n = ab x ac and each divisor max(., 1e-30).
    spheres: the centre of each triangle's box and the distance to its
    farthest vertex, times 1 + 2^-16.
    """
    v = tri_data[:, 0:9].float().reshape(-1, 3, 3)
    a, b, c = v[:, 0], v[:, 1], v[:, 2]
    # bc the shortest edge: with an edge of (nearly) zero length only edge
    # bc's region test is exclusive
    l_ab, l_bc, l_ca = (((u - w) ** 2).sum(dim=1)
                        for u, w in ((b, a), (c, b), (a, c)))
    rot_ab = ((l_ab < l_bc) & (l_ab <= l_ca))[:, None]      # (c, a, b)
    rot_ca = (~rot_ab[:, 0] & (l_ca < l_bc))[:, None]       # (b, c, a)
    a, b, c = (torch.where(rot_ab, x, torch.where(rot_ca, y, z))
               for x, y, z in ((c, b, a), (a, c, b), (b, a, c)))
    ab, ac, bc = b - a, c - a, c - b

    def dot(u, w):
        return u[:, 0] * w[:, 0] + u[:, 1] * w[:, 1] + u[:, 2] * w[:, 2]

    def cross(u, w):
        return torch.stack([u[:, 1] * w[:, 2] - u[:, 2] * w[:, 1],
                            u[:, 2] * w[:, 0] - u[:, 0] * w[:, 2],
                            u[:, 0] * w[:, 1] - u[:, 1] * w[:, 0]], dim=1)

    def recip(x):
        return 1.0 / torch.clamp(x, min=_EPS)

    lab, lac, lbc, dd = dot(ab, ab), dot(ac, ac), dot(bc, bc), dot(ab, ac)
    n = cross(ab, ac)
    nn = dot(n, n)
    rn = recip(nn)[:, None]
    kb, kc, rbc = dd - lab, lac - dd, recip(lbc)
    consts = torch.cat(
        [a, lab[:, None], ab, lac[:, None], ac, kb[:, None],
         cross(ac, n) * rn, nn[:, None], cross(n, ab) * rn,
         torch.stack([recip(lab), recip(lac), rbc, -kb * rbc, kc], dim=1)],
        dim=1)
    centre = 0.5 * (v.amin(dim=1) + v.amax(dim=1))
    r = sqrt(((v - centre[:, None]) ** 2).sum(dim=2).amax(dim=1))
    return consts, torch.cat([centre, (r * _SPHERE_MARGIN)[:, None]], dim=1)


def pair_dist2_staged(p, q):
    """The kernel's division-free pair body: squared distance from points
    ``p`` (..., 3) to staged triangles ``q`` (..., 24), broadcast."""
    (ax, ay, az, lab, abx, aby, abz, lac, acx, acy, acz, kb, uvx, uvy, uvz,
     nn, uwx, uwy, uwz, rab, rac, rbc, kbr, kc) = q.unbind(-1)
    apx, apy, apz = p[..., 0] - ax, p[..., 1] - ay, p[..., 2] - az
    d1 = abx * apx + aby * apy + abz * apz
    d2 = acx * apx + acy * apy + acz * apz
    v = uvx * apx + uvy * apy + uvz * apz
    w = uwx * apx + uwy * apy + uwz * apz
    x, vb, vc = d2 - d1, v * nn, w * nn

    m_a = (d1 <= 0) & (d2 <= 0)
    m_b = (d1 >= lab) & (x <= kb)
    m_c = (d2 >= lac) & (x >= kc)
    m_ab = (vc <= 0) & (d1 >= 0) & (d1 <= lab)
    m_ac = (vb <= 0) & (d2 >= 0) & (d2 <= lac)
    m_bc = (vb + vc >= nn) & (x >= kb) & (x <= kc)

    t_ab = torch.clamp(d1 * rab, 0, 1)
    t_ac = torch.clamp(d2 * rac, 0, 1)
    t_bc = torch.clamp(x * rbc + kbr, 0, 1)
    # closest point a + s ab + t ac: face, then bc, ac, ab, c, b, a
    s, t = v, w
    for m, s_m, t_m in ((m_bc, 1 - t_bc, t_bc), (m_ac, 0.0, t_ac),
                        (m_ab, t_ab, 0.0), (m_c, 0.0, 1.0), (m_b, 1.0, 0.0),
                        (m_a, 0.0, 0.0)):
        s, t = torch.where(m, s_m, s), torch.where(m, t_m, t)
    rx = s * abx + (t * acx - apx)
    ry = s * aby + (t * acy - apy)
    rz = s * abz + (t * acz - apz)
    return rx * rx + ry * ry + rz * rz


def _box_sphere(pts):
    """Centre and half-diagonal of the box of points (..., n, 3)."""
    lo, hi = pts.amin(dim=-2), pts.amax(dim=-2)
    return 0.5 * (lo + hi), 0.5 * torch.linalg.norm(hi - lo, dim=-1)


def _box(pts):
    """Centre and half-extents of the box of points (..., n, 3)."""
    lo, hi = pts.amin(dim=-2), pts.amax(dim=-2)
    return 0.5 * (lo + hi), 0.5 * (hi - lo)


def _sphere_box_gap2(spheres, ctr, half):
    """Squared distance from sphere centres (..., 3) to boxes given by
    centre and half-extents (..., 3), broadcast: the kernel's reject test
    keeps a triangle when it is below (r + the warp's max distance)^2."""
    return (torch.clamp((spheres - ctr).abs() - half, min=0) ** 2).sum(dim=-1)


def supertile_bounds(points_blocked, sup_data):
    """(n_blocks, n_sup) lower bound from each 128-point block to each
    supertile: dist(block centre, sphere centre) - r - half-diagonal."""
    ctr, bhd = _box_sphere(points_blocked.float().reshape(-1, BLOCK_POINTS, 3))
    sup = sup_data.float()
    return (torch.linalg.norm(sup[None, :, :3] - ctr[:, None], dim=2)
            - sup[None, :, 3] - bhd[:, None])


def kernel_walk(points_blocked, tri_data, sup_data, *, sorted_walk=True,
                warp_reject=True, sort_chunk=SORT_CHUNK):
    """K3's walk in plain torch, one point per thread: the min squared
    distance (P,), and per block the supertiles visited and the (point,
    triangle) pairs evaluated (int64).

    ``sorted_walk``: take supertiles in the order of their bounds (ties to
    the lower index) until the first bound >= the block's running bound,
    in chunks of ``sort_chunk`` supertiles as the kernel sorts them: the chunk
    holding the block's nearest supertile first, then the others in index
    order, each from its least bound; else the nearest first and then every
    other in index order whose bound beats it (the TPU kernel's walk).
    ``warp_reject``: each warp (a 2x4x4 slab of 32 points) skips the
    triangles whose sphere lies farther from its slab's box than its
    running max; else it evaluates all 128 rows of a visited supertile.
    """
    dev = points_blocked.device
    nb = points_blocked.shape[0] // BLOCK_POINTS
    nw = BLOCK_POINTS // WARP
    lanes = _WARP_ORDER.to(dev)
    pts = points_blocked.float().reshape(nb, BLOCK_POINTS, 3)[:, lanes]
    pts = pts.reshape(nb, nw, WARP, 3)
    consts, spheres = stage_triangles(tri_data)
    n_sup = sup_data.shape[0]
    db = supertile_bounds(points_blocked, sup_data)
    starts = torch.zeros((nb, n_sup), dtype=torch.bool, device=dev)
    starts[:, 0] = True
    if sorted_walk:
        order = torch.sort(db, dim=1, stable=True).indices
        cid = order // sort_chunk
        head = cid[:, :1]                    # the nearest supertile's chunk
        rank = torch.where(cid == head, 0, torch.where(cid < head, cid + 1,
                                                       cid))
        order = order.gather(1, torch.sort(rank, dim=1, stable=True).indices)
        cid = order // sort_chunk
        starts[:, 1:] = cid[:, 1:] != cid[:, :-1]
    else:
        head = db.argmin(dim=1)                      # the first minimum
        idx = torch.arange(n_sup, device=dev).expand(nb, n_sup)
        rest = idx[idx != head[:, None]].reshape(nb, n_sup - 1)
        order = torch.cat([head[:, None], rest], dim=1)
    last_start = int(torch.nonzero(starts.any(dim=0))[-1, 0])
    wctr, whalf = _box(pts)
    m = torch.full((nb, nw, WARP), float("inf"), device=dev)
    visited = torch.zeros(nb, dtype=torch.int64, device=dev)
    pairs = torch.zeros(nb, dtype=torch.int64, device=dev)
    alive = torch.ones(nb, dtype=torch.bool, device=dev)
    cur = torch.full((nb,), float("inf"), device=dev)
    wmax = torch.full((nb, nw), float("inf"), device=dev)
    rows0 = torch.arange(SUPER, device=dev)
    chunk = max(1, _PAIRS_PER_CHUNK[dev.type] // (BLOCK_POINTS * SUPER))
    all_blocks = torch.arange(nb, device=dev)
    for k in range(n_sup):
        s = order[:, k]
        if sorted_walk:
            alive = alive | starts[:, k]
        take = alive & ((db[all_blocks, s] < cur) | (k == 0))
        if sorted_walk:
            alive = take
        blocks = torch.nonzero(take)[:, 0]
        if blocks.numel() == 0:
            if sorted_walk and k >= last_start:
                break
            continue
        for c0 in range(0, blocks.numel(), chunk):
            b = blocks[c0:c0 + chunk]
            rows = s[b, None] * SUPER + rows0                 # (nbc, 128)
            d2 = pair_dist2_staged(pts[b][:, :, :, None, :],
                                   consts[rows][:, None, None])
            if warp_reject:
                sp = spheres[rows][:, None]                 # (nbc, 1, 128, 4)
                gap = _sphere_box_gap2(sp[..., :3], wctr[b][:, :, None],
                                       whalf[b][:, :, None])
                reach = sp[..., 3] + sqrt(wmax[b])[:, :, None]
                keep = gap < reach * reach                    # (nbc, nw, 128)
                d2 = torch.where(keep[:, :, None], d2, float("inf"))
                pairs[b] += keep.sum(dim=(1, 2)) * WARP
            else:
                pairs[b] += BLOCK_POINTS * SUPER
            m[b] = torch.minimum(m[b], d2.amin(dim=-1))
        visited += take
        wmax = m.amax(dim=-1)
        cur = sqrt(wmax.amax(dim=-1))
    out = torch.empty((nb, BLOCK_POINTS), device=dev)
    out[:, lanes] = m.reshape(nb, BLOCK_POINTS)
    return out.reshape(-1), visited, pairs


def warp_pairs_needed(points_blocked, tri_data, d2):
    """Per block, the (point, triangle) pairs that the per-warp reject must
    keep under the final distances ``d2`` (P,): the (warp, triangle) pairs
    whose sphere lies nearer the warp's box than its final max distance,
    x 32."""
    nb = points_blocked.shape[0] // BLOCK_POINTS
    lanes = _WARP_ORDER.to(points_blocked.device)
    pts = points_blocked.float().reshape(nb, BLOCK_POINTS, 3)[:, lanes]
    pts = pts.reshape(-1, WARP, 3)
    wctr, whalf = _box(pts)
    wcur = d2.float().reshape(nb, BLOCK_POINTS)[:, lanes].reshape(-1, WARP)
    wcur = sqrt(wcur.amax(dim=1))
    _, spheres = stage_triangles(tri_data)
    count = torch.zeros(pts.shape[0], dtype=torch.int64,
                        device=points_blocked.device)
    chunk = max(1, _PAIRS_PER_CHUNK[points_blocked.device.type]
                // max(1, spheres.shape[0]))
    for c0 in range(0, pts.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        gap = _sphere_box_gap2(spheres[None, :, :3], wctr[sl, None],
                               whalf[sl, None])
        reach = spheres[None, :, 3] + wcur[sl][:, None]
        count[sl] = (gap < reach * reach).sum(dim=1)
    return count.reshape(nb, -1).sum(dim=1) * WARP


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


def _launch(points, tri_data, sup_data, stats=None):
    """Launch K3. ``stats``: None, or an (n_blocks, 2) int32 tensor of zeros
    on the points' device that receives per block the supertiles visited
    and the (point, triangle) pairs evaluated."""
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
    if stats is not None and (
            tuple(stats.shape) != (p // BLOCK_POINTS, 2)
            or stats.dtype != torch.int32 or stats.device != points.device
            or not stats.is_contiguous()):
        raise ValueError(f"stats must be contiguous int32 "
                         f"({p // BLOCK_POINTS}, 2) on {points.device}")
    out = torch.empty((p,), dtype=torch.float32, device=points.device)
    if p == 0:
        return out
    err = _build.library().point_triangle_launch(
        points.data_ptr(), p // BLOCK_POINTS, tri_data.data_ptr(),
        sup_data.data_ptr(), n_sup, out.data_ptr(),
        None if stats is None else stats.data_ptr(),
        torch.cuda.current_stream(points.device).cuda_stream)
    _build.check(err, "point_triangle_launch")
    launches += 1
    return out
