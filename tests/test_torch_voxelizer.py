"""The port's object-preparation path against the JAX package: the
mesh -> SDF voxelizer and everything around it.

- the packers of kernel K3 (``morton_order``, ``pack_triangles``,
  ``blocked_grid``/``unblock``) equal the JAX package's arrays exactly;
- the plain distance matches jitted ``mesh_to_sdf._unsigned_distance`` to
  rtol 1e-5 / atol 1e-7 (both float32; the atol covers points on edges, whose
  distance is rounding noise) and the Pallas kernel in interpret mode to
  rtol 1e-4 / atol 1e-7, as tests/test_point_triangle_pallas.py compares its
  own pair;
- ``_inside_parity`` gives an equal mask bit for bit;
- ``mesh_to_sdf`` and its entry points (``prepare_object_dir``,
  ``MeshProcessor``, ``approximate_convex_decomposition``,
  ``GraspableObject3D.transform``) give equal signs, equal origin and
  resolution, and distances within rtol 1e-5 / atol 1e-7: the port works in
  float32, while the JAX CPU path under the tests' x64 setting computes the
  distance in float64;
- file IO is byte-identical both ways, and ``Mesh3D`` is the same.

Small meshes throughout (at most 1,536 triangles): the plain versions are
brute force on the CPU.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pointnetgpd_tpu.database.mesh_processor import MeshProcessor as JMeshProcessor
from pointnetgpd_tpu.geometry import io as jio
from pointnetgpd_tpu.geometry import sdf as jsdf
from pointnetgpd_tpu.geometry.decomposition import (
    approximate_convex_decomposition as j_acd)
from pointnetgpd_tpu.geometry.mesh import Mesh3D as JMesh3D
from pointnetgpd_tpu.grasping.graspable_object import (
    GraspableObject3D as JGraspable)
from pointnetgpd_tpu.pipelines import prepare_objects as jprep
from pointnetgpd_tpu_torch.database.mesh_processor import MeshProcessor
from pointnetgpd_tpu_torch.geometry import io as tio
from pointnetgpd_tpu_torch.geometry import sdf as tsdf
from pointnetgpd_tpu_torch.geometry.decomposition import (
    approximate_convex_decomposition)
from pointnetgpd_tpu_torch.geometry.mesh import Mesh3D
from pointnetgpd_tpu_torch.grasping.graspable_object import GraspableObject3D
from pointnetgpd_tpu_torch.ops import point_triangle as k3
from pointnetgpd_tpu_torch.pipelines import prepare_objects as tprep

# both packages' ``ops`` re-export functions under the modules' names
jm = importlib.import_module("pointnetgpd_tpu.ops.mesh_to_sdf")
tm = importlib.import_module("pointnetgpd_tpu_torch.ops.mesh_to_sdf")
jk3 = importlib.import_module("pointnetgpd_tpu.ops.point_triangle_pallas")

RTOL, ATOL = 1e-5, 1e-7          # float32 port vs the JAX CPU path
K_RTOL, K_ATOL = 1e-4, 1e-7      # Ericson variants: kernel body vs oracle


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU; torch's thread pool in each worker
    oversubscribes it (the port's tests ran 10x slower under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ meshes

def cube(size=0.08):
    v = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                 dtype=np.float64) * size
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def box(lo, hi):
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    v = np.array([[x, y, z] for x in (lo[0], hi[0])
                  for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    return v, cube()[1]


def icosphere(radius=0.06):
    """Octahedron subdivided three times onto a sphere: 512 triangles."""
    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                  [0, 0, 1], [0, 0, -1]], float)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    m = JMesh3D(v, f).subdivide().subdivide().subdivide()
    return radius * m.vertices / np.linalg.norm(m.vertices, axis=1,
                                                 keepdims=True), m.triangles


def torus(nu=48, nv=16, big_r=0.05, small_r=0.02):
    """Watertight, non-convex: 2 * nu * nv triangles, outward winding."""
    u = 2 * np.pi * np.arange(nu) / nu
    w = 2 * np.pi * np.arange(nv) / nv
    uu, ww = np.meshgrid(u, w, indexing="ij")
    ring = big_r + small_r * np.cos(ww)
    v = np.stack([ring * np.cos(uu), ring * np.sin(uu),
                  small_r * np.sin(ww)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a, b = i * nv + j, (i + 1) % nu * nv + j
    c, d = (i + 1) % nu * nv + (j + 1) % nv, i * nv + (j + 1) % nv
    f = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                        np.stack([a, c, d], -1).reshape(-1, 3)])
    return v, f.astype(np.int32)


MESHES = {"cube": (cube, 16), "icosphere": (icosphere, 32),
          "torus": (torus, 32)}


def assert_sdf_equal(got, want):
    """Port SdfGrid vs JAX SdfGrid: equal signs, origin and resolution;
    distances to RTOL/ATOL; surface cells within one cell's worth."""
    gd, wd = got.data.numpy(), np.asarray(want.data)
    assert gd.shape == wd.shape
    np.testing.assert_array_equal(np.signbit(gd), np.signbit(wd))
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
    assert float(got.resolution) == float(want.resolution)
    np.testing.assert_allclose(got.gradients.numpy(),
                               np.asarray(want.gradients), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------------------ packers

@pytest.mark.parametrize("f", [5, 300, 1000])
def test_pack_triangles_and_morton_order_equal_jax(f):
    rs = np.random.RandomState(f)
    tv = (rs.rand(f, 3, 3) * [0.1, 0.2, 0.05] - 0.03).astype(np.float32)
    cent = tv.mean(axis=1)
    np.testing.assert_array_equal(k3.morton_order(cent),
                                  jk3.morton_order(cent))
    got, want = k3.pack_triangles(tv), jk3.pack_triangles(tv)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dims", [(10, 9, 17), (4, 4, 8), (24, 24, 24)])
def test_blocked_grid_and_unblock_equal_jax(dims):
    origin, res = [0.0123, -0.2, 1.5], 0.0173
    got, g_unblock = k3.blocked_grid(*dims, origin, res)
    want, w_unblock = jk3.blocked_grid(*dims, origin, res)
    np.testing.assert_array_equal(got, want)
    vals = np.random.RandomState(0).rand(got.shape[0]).astype(np.float32)
    np.testing.assert_array_equal(g_unblock(torch.from_numpy(vals)).numpy(),
                                  w_unblock(vals))


# ------------------------------------------------------------------ distance

def _distance_case(seed):
    """Random points and triangles plus degenerate (zero-area) triangles and
    points on vertices and on edges."""
    rs = np.random.RandomState(seed)
    tv = ((rs.rand(40, 3, 3) - 0.5) * 0.1).astype(np.float32)
    tv[0, 2] = tv[0, 1]                                   # two equal vertices
    tv[1] = tv[1, 0]                                      # a point
    tv[2, 2] = 0.3 * tv[2, 0] + 0.7 * tv[2, 1]            # collinear
    pts = ((rs.rand(300, 3) - 0.5) * 0.2).astype(np.float32)
    pts[:10] = tv[3:13, 0]                                # on vertices
    t = rs.rand(10, 1).astype(np.float32)
    pts[10:20] = tv[13:23, 0] + t * (tv[13:23, 1] - tv[13:23, 0])  # on edges
    return pts, tv


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_distance_matches_unsigned_distance(seed):
    pts, tv = _distance_case(seed)
    want = np.asarray(jm._unsigned_distance(jnp.asarray(pts),
                                            jnp.asarray(tv)))
    got = k3.unsigned_distance_torch(torch.from_numpy(pts),
                                     torch.from_numpy(tv)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[:10] == 0).all()


def test_plain_matches_pallas_kernel_in_interpret_mode():
    """The shape of tests/test_point_triangle_pallas.py: 256 points, 37
    triangles, through the packed layout both kernels take."""
    rs = np.random.RandomState(0)
    pts = ((rs.rand(256, 3) - 0.5) * 0.2).astype(np.float32)
    tv = ((rs.rand(37, 3, 3) - 0.5) * 0.1).astype(np.float32)
    tri_data, sup_data = k3.pack_triangles(tv)
    want = np.asarray(jk3.min_point_triangle_dist2(
        jnp.asarray(pts), jnp.asarray(tri_data), jnp.asarray(sup_data),
        interpret=True))
    n0 = k3.launches
    got = k3.min_point_triangle_dist2(torch.from_numpy(pts),
                                      torch.from_numpy(tri_data),
                                      torch.from_numpy(sup_data)).numpy()
    assert k3.launches == n0                     # CPU tensors: plain version
    np.testing.assert_allclose(np.sqrt(got), np.sqrt(want), rtol=K_RTOL,
                               atol=K_ATOL)


# ----------------------------------------- the kernel's division-free body

def _body_case(name):
    """(points (128, 3), triangles (F, 3, 3)) float32 for the pair body."""
    rs = np.random.RandomState(len(name))
    tv = ((rs.rand(24, 3, 3) - 0.5) * 0.1).astype(np.float32)
    pts = ((rs.rand(128, 3) - 0.5) * 0.2).astype(np.float32)
    if name == "vertices_edges_faces":
        bary = rs.dirichlet([1, 1, 1], 24).astype(np.float32)
        face = np.einsum("fk,fkd->fd", bary, tv)
        n = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        t = rs.rand(24, 1).astype(np.float32)
        pts[:24] = tv[:, 0]                                  # on vertices
        pts[24:48] = tv[:, 1] + t * (tv[:, 2] - tv[:, 1])    # on edges bc
        pts[48:72] = face                                    # on faces
        pts[72:96] = face + 0.003 * n                        # above faces
    elif name == "degenerate":
        tv[0, 1] = tv[0, 0]                                  # a == b
        tv[1, 2] = tv[1, 1]                                  # b == c
        tv[2] = tv[2, 0]                                     # a point
        tv[3, 2] = 0.3 * tv[3, 0] + 0.7 * tv[3, 1]           # collinear
        tv[4, 2] = 1.7 * tv[4, 1] - 0.7 * tv[4, 0]           # collinear, out
        for i in range(5, 13):                               # slivers
            ab = tv[i, 1] - tv[i, 0]
            perp = np.cross(ab, rs.rand(3) - 0.5)
            tv[i, 2] = (tv[i, 0] + rs.rand() * ab + 10.0 ** -(i - 2) * perp
                        / np.linalg.norm(perp))
        pts[:13] = tv[:13, 2]
        pts[13:26] = 0.5 * (tv[:13, 0] + tv[:13, 2]) + 1e-3
    elif name == "padding_rows":
        tv = tv[:5]                      # 123 padding rows at 1e8 in tri_data
    elif name == "far_points":
        pts = pts / np.linalg.norm(pts, axis=1, keepdims=True) * 50.0
    return pts, tv


def _exact_distance(pts, tv):
    """Float64 distance from points to triangles, robust to degenerate
    ones: the nearest of the three edges, or of the plane where the
    projection falls inside a triangle of non-zero area."""
    p = pts.astype(np.float64)[:, None]
    a, b, c = (tv[None, :, k].astype(np.float64) for k in range(3))

    def segment(u, w):
        uw = w - u
        ll = (uw * uw).sum(-1)
        t = np.clip(((p - u) * uw).sum(-1) / np.where(ll > 0, ll, 1), 0, 1)
        return np.linalg.norm(p - (u + t[..., None] * uw), axis=-1)

    d = np.minimum(np.minimum(segment(a, b), segment(b, c)), segment(c, a))
    n = np.cross(b - a, c - a)
    nn = (n * n).sum(-1)
    ok = nn > 1e-30
    h = ((p - a) * n).sum(-1) / np.where(ok, nn, 1)
    q = p - h[..., None] * n
    inside = ok & np.all([(np.cross(w - u, q - u) * n).sum(-1) >= 0
                          for u, w in ((a, b), (b, c), (c, a))], axis=0)
    return np.where(inside, np.minimum(d, np.abs(h) * np.sqrt(nn)),
                    d).min(axis=1)


def _close(got, want):
    return np.abs(got - want) <= K_ATOL + K_RTOL * np.abs(want)


@pytest.mark.parametrize("name", ["vertices_edges_faces", "degenerate",
                                  "padding_rows", "far_points"])
def test_division_free_body_matches_jax(name):
    """The kernel's pair body in plain torch (per-triangle constants and
    reciprocals, no division) over every row of ``tri_data``, padding
    included, against jitted ``_unsigned_distance``, the Pallas kernel in
    interpret mode and a float64 distance, to rtol 1e-4, atol 1e-7.

    On degenerate triangles each reference has a fault of its own: the
    oracle's edge priority sends a segment with b == c to vertex b, the
    Pallas body's sends one with a == b to vertex a, and both lose digits
    on slivers. The body rotates each triangle so that bc is its shortest
    edge and takes the face weights from per-triangle vectors: it holds to
    the float64 distance everywhere, and to each reference wherever that
    reference holds to the float64 distance."""
    import jax

    pts, tv = _body_case(name)
    tri_data, sup_data = k3.pack_triangles(tv)
    consts, spheres = k3.stage_triangles(torch.from_numpy(tri_data))
    pair = k3.pair_dist2_staged(torch.from_numpy(pts)[:, None], consts[None])
    assert torch.isfinite(pair).all()
    got = pair.amin(dim=1).sqrt().numpy()
    exact = _exact_distance(pts, tv)
    assert _close(got, exact).all()
    oracle = np.asarray(jax.jit(jm._unsigned_distance)(jnp.asarray(pts),
                                                       jnp.asarray(tv)))
    pallas = np.sqrt(np.asarray(jk3.min_point_triangle_dist2(
        jnp.asarray(pts), jnp.asarray(tri_data), jnp.asarray(sup_data),
        interpret=True)))
    for ref in (oracle, pallas):
        right = _close(ref, exact)
        assert right.all() or name == "degenerate"
        assert right.sum() >= len(pts) - 4
        assert _close(got[right], ref[right]).all()
    # every real triangle lies inside its sphere, padding ones at 1e8
    real = np.abs(tri_data[:, 0]) < k3._FAR / 2
    v = torch.from_numpy(tri_data[:, 0:9].reshape(-1, 3, 3))
    gap = torch.linalg.norm(v - spheres[:, None, :3], dim=2).amax(dim=1)
    assert (gap[real] <= spheres[real, 3]).all()
    assert (spheres[~real, :3] == k3._FAR).all()


def _walk_case():
    """A torus of 3,072 triangles (24 supertiles) and every 20th block of
    a blocked 40^3 grid around it: blocks small next to the mesh, near and
    far from the surface, as at the voxelizer's resolution."""
    v, f = torus(64, 24)
    tri_data, sup_data = k3.pack_triangles(v[f].astype(np.float32))
    pts, _ = k3.blocked_grid(40, 40, 40, [-0.075] * 3, 0.15 / 40)
    pts = pts.reshape(-1, k3.BLOCK_POINTS, 3)[::20].reshape(-1, 3)
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (pts, tri_data, sup_data)]


@pytest.mark.parametrize("sorted_walk", [True, False])
@pytest.mark.parametrize("warp_reject", [True, False])
def test_kernel_walk_returns_the_brute_force_minimum(sorted_walk,
                                                    warp_reject):
    """The kernel's walk (bound order or index order, with or without the
    per-warp reject) returns the minimum of the same pair body over every
    triangle, exactly, and the bound-ordered walk visits no more supertiles
    per block than the TPU kernel's index-order walk."""
    pts, tri_data, sup_data = _walk_case()
    consts, _ = k3.stage_triangles(tri_data)
    brute = torch.cat([k3.pair_dist2_staged(pts[c:c + 512, None],
                                            consts[None]).amin(dim=1)
                       for c in range(0, pts.shape[0], 512)])
    d2, visited, pairs = k3.kernel_walk(pts, tri_data, sup_data,
                                        sorted_walk=sorted_walk,
                                        warp_reject=warp_reject)
    assert torch.equal(d2, brute)
    _, index_visited, full_pairs = k3.kernel_walk(
        pts, tri_data, sup_data, sorted_walk=False, warp_reject=False)
    assert (visited <= index_visited).all() if sorted_walk else \
        torch.equal(visited, index_visited)
    assert (visited >= 1).all() and (visited < sup_data.shape[0]).any()
    if warp_reject:
        assert (pairs <= visited * k3.BLOCK_POINTS * k3.SUPER).all()
        assert pairs.sum() < full_pairs.sum()
    else:
        assert torch.equal(pairs, visited * k3.BLOCK_POINTS * k3.SUPER)
    np.testing.assert_allclose(
        d2.sqrt().numpy(),
        k3.min_point_triangle_dist2_torch(pts, tri_data).sqrt().numpy(),
        rtol=K_RTOL, atol=K_ATOL)


def test_warp_pairs_needed_counts_what_the_reject_keeps():
    """Under the final distances, the pairs the reject must keep are at
    most what the walk with the reject evaluated, and positive per block."""
    pts, tri_data, sup_data = _walk_case()
    d2, _, pairs = k3.kernel_walk(pts, tri_data, sup_data)
    need = k3.warp_pairs_needed(pts, tri_data, d2)
    assert (need > 0).all() and need.sum() <= pairs.sum()


def test_k3_launch_checks_its_arguments():
    """The wrapper raises on what the kernel cannot take, before any
    build: a stats tensor of the wrong shape or type, triangle rows that
    do not fill whole supertiles. It sets no cap on the supertile count:
    above ``SORT_CHUNK`` the kernel walks them in chunks."""
    pts, tri_data, sup_data = _walk_case()
    for bad in (torch.zeros((3, 2), dtype=torch.int32),
                torch.zeros((pts.shape[0] // 128, 2))):
        with pytest.raises(ValueError, match="stats"):
            k3._launch(pts, tri_data, sup_data, stats=bad)
    n = k3.SORT_CHUNK + 1
    with pytest.raises(ValueError, match="supertile"):
        k3._launch(pts, torch.zeros((n * k3.SUPER - 1, 16)),
                   torch.zeros((n, 8)))
    assert not hasattr(k3, "MAX_SUPERTILES")


@pytest.mark.parametrize("chunk", [4, 5, 7])
def test_kernel_walk_in_chunks_returns_the_brute_force_minimum(chunk):
    """The chunked walk the kernel takes above ``SORT_CHUNK`` supertiles
    (the chunk holding the nearest supertile first, then index order, each
    sorted and walked until its first bound >= the running bound), here in
    chunks of a few supertiles, returns the minimum of the pair body over
    every triangle, exactly; its first supertile is the nearest, and one
    chunk at least as large as the mesh is the single sorted walk."""
    pts, tri_data, sup_data = _walk_case()
    consts, _ = k3.stage_triangles(tri_data)
    brute = torch.cat([k3.pair_dist2_staged(pts[c:c + 512, None],
                                            consts[None]).amin(dim=1)
                       for c in range(0, pts.shape[0], 512)])
    d2, visited, pairs = k3.kernel_walk(pts, tri_data, sup_data, sort_chunk=chunk)
    assert torch.equal(d2, brute)
    assert (visited >= 1).all() and (pairs >= k3.WARP).all()
    assert (visited <= sup_data.shape[0]).all()
    one = k3.kernel_walk(pts, tri_data, sup_data)
    for a, b in zip(one, k3.kernel_walk(pts, tri_data, sup_data,
                                        sort_chunk=sup_data.shape[0])):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ voxelizer

def _grid_inputs(v, f, dim, padding=3):
    """The columns, z origin and spacing that mesh_to_sdf hands the parity
    pass, built as both packages build them."""
    verts = np.asarray(v, np.float32)
    tri_v = verts[f]
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    res = float((hi - lo).max()) / (dim - 1 - 2 * padding)
    origin = lo - padding * res + 1e-4 * res * np.array(
        [1.0, 2.6180339887, 4.2360679775])
    idx = np.arange(dim, dtype=np.float32)
    cols = (origin[:2] + res * np.stack(np.meshgrid(idx, idx, indexing="ij"),
                                        axis=-1).reshape(-1, 2))
    return cols.astype(np.float32), np.float32(origin[2]), np.float32(res), tri_v


@pytest.mark.parametrize("name", list(MESHES))
def test_inside_parity_mask_equals_jax(name):
    make, dim = MESHES[name]
    v, f = make()
    cols, z0, res, tri_v = _grid_inputs(v, f, dim)
    want = np.asarray(jm._inside_parity(jnp.asarray(cols), jnp.float32(z0),
                                        jnp.float32(res), jnp.asarray(tri_v),
                                        nz=dim))
    got = tm._inside_parity(torch.from_numpy(cols), z0, res,
                            torch.from_numpy(tri_v), nz=dim, chunk=100)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("seed", [0, 1])
def test_inside_parity_rounds_like_jax_on_edges_and_bin_bounds(seed):
    """Columns on triangle edges (a barycentric weight within rounding of
    0) and bins of 1e-6 (crossings within rounding of a bin bound): only
    XLA's fused-multiply-add association gives the JAX mask here, so this
    case catches a numerator, denominator or z_int rounded otherwise."""
    rs = np.random.RandomState(seed)
    nz, res, z0 = 64, np.float32(1e-6), np.float32(0.05)
    tv = rs.rand(200, 3, 3).astype(np.float32)
    tv[..., 2] = z0 + rs.rand(200, 3).astype(np.float32) * nz * res
    t = rs.rand(1000, 1).astype(np.float32)
    k, e = rs.randint(0, 200, 1000), rs.randint(0, 3, 1000)
    a, b = tv[k, e, :2], tv[k, (e + 1) % 3, :2]
    cols = np.concatenate([a + t * (b - a),
                           rs.rand(1000, 2).astype(np.float32)])
    want = np.asarray(jm._inside_parity(jnp.asarray(cols), jnp.float32(z0),
                                        jnp.float32(res), jnp.asarray(tv),
                                        nz=nz))
    got = tm._inside_parity(torch.from_numpy(cols), z0, res,
                            torch.from_numpy(tv), nz=nz)
    np.testing.assert_array_equal(got.numpy(), want)


def test_inside_parity_counts_misses_like_jax_on_an_open_mesh():
    """An open surface (odd triangle count): JAX's histogram counts every
    miss above each grid z, so the mask depends on the miss count too."""
    v, f = cube()
    f = f[:11]
    cols, z0, res, tri_v = _grid_inputs(v, f, 12)
    want = np.asarray(jm._inside_parity(jnp.asarray(cols), jnp.float32(z0),
                                        jnp.float32(res), jnp.asarray(tri_v),
                                        nz=12))
    got = tm._inside_parity(torch.from_numpy(cols), z0, res,
                            torch.from_numpy(tri_v), nz=12)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,dim,max_triangles", [
    ("cube", 16, 60000), ("icosphere", 20, 60000), ("torus", 20, 60000),
    ("icosphere", 16, 200)])                     # 512 -> decimated
def test_mesh_to_sdf_matches_jax(name, dim, max_triangles):
    v, f = MESHES[name][0]()
    want = jm.mesh_to_sdf(JMesh3D(v, f), dim=dim, padding=3,
                          max_triangles=max_triangles)
    got = tm.mesh_to_sdf(Mesh3D(v, f), dim=dim, padding=3,
                         max_triangles=max_triangles, device="cpu")
    assert got.data.device.type == "cpu"
    assert_sdf_equal(got, want)
    assert (got.data < 0).any()


# ------------------------------------------------------------------ entry points

def _write_ply(path, v, f):
    with open(path, "w") as fh:
        fh.write(f"ply\nformat ascii 1.0\nelement vertex {len(v)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 f"element face {len(f)}\nproperty list uchar int "
                 "vertex_indices\nend_header\n")
        for p in v:
            fh.write(f"{p[0]} {p[1]} {p[2]}\n")
        for t in f:
            fh.write(f"3 {t[0]} {t[1]} {t[2]}\n")


@pytest.mark.parametrize("fmt", ["obj", "ply"])
def test_prepare_object_dir_matches_jax(tmp_path, fmt):
    v, f = icosphere()
    paths = {}
    for pkg in ("jax", "port"):
        gdir = tmp_path / pkg / "google_512k"
        gdir.mkdir(parents=True)
        if fmt == "obj":
            jio.write_obj(str(gdir / "nontextured.obj"), v, f)
        else:
            _write_ply(str(gdir / "nontextured.ply"), v, f)
        paths[pkg] = gdir
    want = jprep.prepare_object_dir(str(tmp_path / "jax"), sdf_dim=16,
                                    sdf_padding=3)
    got = tprep.prepare_object_dir(str(tmp_path / "port"), sdf_dim=16,
                                   sdf_padding=3, device="cpu")
    assert got.endswith("google_512k/nontextured.sdf")
    assert_sdf_equal(tio.read_sdf(got, device="cpu"), jio.read_sdf(want))
    # the OBJ converted from the PLY is the same file
    assert ((paths["port"] / "nontextured.obj").read_bytes()
            == (paths["jax"] / "nontextured.obj").read_bytes())
    # an existing .sdf is kept unless overwrite is asked
    assert tprep.prepare_object_dir(str(tmp_path / "port"),
                                    device="cpu") == got
    assert tprep.prepare_object_dir(str(tmp_path / "none"),
                                    device="cpu") is None


def test_mesh_processor_matches_jax(tmp_path):
    v, f = cube()
    src = str(tmp_path / "cube.obj")
    jio.write_obj(src, v, f)
    config = {"sdf_dim": 32, "sdf_padding": 3, "obj_target_scale": 0.1,
              "obj_rescaling_type": "max"}
    jm_, jsd, jposes = JMeshProcessor(
        src, cache_dir=str(tmp_path / "jcache")).generate_graspable(config)
    proc = MeshProcessor(src, cache_dir=str(tmp_path / "cache"), device="cpu")
    m, sd, poses = proc.generate_graspable(config)
    np.testing.assert_array_equal(m.vertices, jm_.vertices)
    np.testing.assert_array_equal(m.triangles, jm_.triangles)
    assert_sdf_equal(sd, jsd)
    assert len(poses) == len(jposes) == 6
    for p, q in zip(poses, jposes):
        assert p["p"] == q["p"]
        np.testing.assert_array_equal(p["r"], q["r"])
    # the cached .sdf (newer than the source) is read back, not rebuilt
    again = MeshProcessor(src, cache_dir=str(tmp_path / "cache"),
                          device="cpu")
    n0 = k3.launches
    _, sd2, _ = again.generate_graspable(config)
    np.testing.assert_array_equal(sd2.data.numpy(), sd.data.numpy())
    assert k3.launches == n0


@pytest.mark.parametrize("shape", ["cube", "l_shape"])
def test_convex_decomposition_matches_jax(shape):
    if shape == "cube":
        v, f = box([0, 0, 0], [1, 1, 1])
    else:
        a, b = box([0, 0, 0], [2, 1, 1]), box([0, 0, 1], [1, 1, 2])
        m = JMesh3D(*a).merge(JMesh3D(*b))
        v, f = m.vertices, m.triangles
    want = j_acd(JMesh3D(v, f), max_pieces=8, concavity_tol=0.05, dim=24)
    got = approximate_convex_decomposition(Mesh3D(v, f), max_pieces=8,
                                           concavity_tol=0.05, dim=24,
                                           device="cpu")
    assert len(got) == len(want)
    assert (len(want) == 1) if shape == "cube" else (len(want) >= 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.vertices, w.vertices, atol=1e-6)
        np.testing.assert_array_equal(g.triangles, w.triangles)


@pytest.mark.parametrize("rotate", [True, False])
def test_graspable_transform_matches_jax(rotate):
    v, f = icosphere()
    v = v * [1.0, 0.7, 0.5]                      # an ellipsoid: rotation shows
    sdf_t = tm.mesh_to_sdf(Mesh3D(v, f), dim=16, padding=3, device="cpu")
    sdf_j = jm.mesh_to_sdf(JMesh3D(v, f), dim=16, padding=3)
    ang = 0.6 if rotate else 0.0
    t = np.eye(4)
    t[:3, :3] = [[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                 [0, 0, 1]]
    t[:3, 3] = [0.01, -0.02, 0.03]
    n0 = k3.launches
    got = GraspableObject3D(sdf_t, Mesh3D(v, f), key="e").transform(t)
    want = JGraspable(sdf_j, JMesh3D(v, f), key="e").transform(t)
    assert k3.launches == n0
    np.testing.assert_array_equal(got.mesh.vertices, want.mesh.vertices)
    assert_sdf_equal(got.sdf, want.sdf)
    np.testing.assert_allclose(got.center_of_mass, want.center_of_mass,
                               rtol=1e-12)
    r = got.rescale(2.0).sdf
    w = jsdf.rescale(want.sdf, 2.0)
    np.testing.assert_allclose(r.data.numpy(), np.asarray(w.data), rtol=RTOL,
                               atol=ATOL)
    assert float(r.resolution) == float(w.resolution)


# ------------------------------------------------------------------ sdf, io

def _sdf_pair(seed=0):
    rs = np.random.RandomState(seed)
    data = ((rs.rand(9, 8, 7) - 0.4) * 0.01).astype(np.float32)
    origin, res = np.array([0.1, -0.2, 0.03]), 0.00137
    return (tsdf.make_sdf(data, origin, res, device="cpu"),
            jsdf.make_sdf(data, origin, res))


def test_make_sdf_and_lookups_match_jax():
    got, want = _sdf_pair()
    for name in ("data", "origin", "gradients", "surface_points",
                 "surface_vals"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    rs = np.random.RandomState(1)
    coords = (rs.rand(200, 3) * [12, 11, 10] - 1.5).astype(np.float32)
    tc, jc = torch.from_numpy(coords), jnp.asarray(coords)
    for fn in ("signed_distance", "signed_distance_fast", "is_out_of_bounds",
               "grid_to_world", "world_to_grid"):
        g = getattr(tsdf, fn)(got, tc).numpy()
        w = np.asarray(getattr(jsdf, fn)(want, jc))
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-9, err_msg=fn)
    assert tsdf.is_out_of_bounds(got, tc).any()


def test_sdf_files_byte_identical_both_ways(tmp_path):
    got, want = _sdf_pair(2)
    tio.write_sdf(str(tmp_path / "port.sdf"), got)
    jio.write_sdf(str(tmp_path / "jax.sdf"), want)
    assert ((tmp_path / "port.sdf").read_bytes()
            == (tmp_path / "jax.sdf").read_bytes())
    back_j = jio.read_sdf(str(tmp_path / "port.sdf"))
    back_t = tio.read_sdf(str(tmp_path / "jax.sdf"), device="cpu")
    np.testing.assert_array_equal(np.asarray(back_j.data), got.data.numpy())
    np.testing.assert_array_equal(back_t.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(back_t.origin.numpy(),
                                  np.asarray(back_j.origin))


def test_mesh_readers_match_jax(tmp_path):
    v, f = icosphere()
    obj = str(tmp_path / "m.obj")
    with open(obj, "w") as fh:                     # slash forms + a quad
        fh.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                 "f 1/1 2/2 3/3 4/4\nf -4//1 -3//1 -2//1\n")
    off = str(tmp_path / "m.off")
    with open(off, "w") as fh:
        fh.write(f"OFF\n{len(v)} {len(f)} 0\n")
        fh.writelines(f"{p[0]} {p[1]} {p[2]}\n" for p in v)
        fh.writelines(f"3 {t[0]} {t[1]} {t[2]}\n" for t in f)
    ply = str(tmp_path / "m.ply")
    _write_ply(ply, v, f)
    for got, want in ((tio.read_obj(obj), jio.read_obj(obj)),
                      (tio.read_off(off), jio.read_off(off)),
                      (tprep.read_ply_mesh(ply), jprep.read_ply_mesh(ply))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    tio.write_obj(str(tmp_path / "a.obj"), v, f)
    jio.write_obj(str(tmp_path / "b.obj"), v, f)
    assert ((tmp_path / "a.obj").read_bytes()
            == (tmp_path / "b.obj").read_bytes())


# ------------------------------------------------------------------ Mesh3D

def _messy_mesh():
    """The icosphere with a degenerate triangle, an out-of-range index and
    an unreferenced vertex."""
    v, f = icosphere()
    v = np.concatenate([v, [[9.0, 9.0, 9.0]]])
    f = np.concatenate([f, [[0, 0, 1], [0, 1, len(v) + 3]]]).astype(np.int32)
    return v, f


@pytest.mark.parametrize("method", [
    "remove_bad_tris", "clean", "decimate", "center_of_mass", "stable_poses",
    "rescale_dimension", "normalize_vertices"])
def test_mesh3d_matches_jax(method):
    v, f = _messy_mesh()
    ops = {
        "remove_bad_tris": lambda m: m.remove_bad_tris(),
        "clean": lambda m: m.remove_bad_tris().remove_unreferenced_vertices(),
        "decimate": lambda m: m.remove_bad_tris()
        .remove_unreferenced_vertices().decimate(150),
        "center_of_mass": lambda m: m.remove_bad_tris()
        .remove_unreferenced_vertices().center_of_mass(),
        "stable_poses": lambda m: m.remove_bad_tris()
        .remove_unreferenced_vertices().decimate(100).stable_poses(),
        "rescale_dimension": lambda m: m.remove_bad_tris()
        .remove_unreferenced_vertices().rescale_dimension(0.2, "diag"),
        "normalize_vertices": lambda m: m.remove_bad_tris()
        .remove_unreferenced_vertices().normalize_vertices(),
    }
    got, want = ops[method](Mesh3D(v, f)), ops[method](JMesh3D(v, f))
    if isinstance(want, JMesh3D):
        np.testing.assert_array_equal(got.vertices, want.vertices)
        np.testing.assert_array_equal(got.triangles, want.triangles)
    elif isinstance(want, list):
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g["p"] == w["p"]
            for k in ("r", "x0", "face"):
                np.testing.assert_array_equal(g[k], w[k])
    else:
        np.testing.assert_array_equal(got, want)
