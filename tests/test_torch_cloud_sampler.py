"""The port's cloud ops and GPG sampler against the JAX package.

Packed voxels, Morton codes, squared distances and neighbor selection must
agree exactly (voxel-center clouds sit on a grid, where many neighbors tie:
both sides must round the distances the same way and break ties toward the
lower index); eigenvectors and normals to 1e-4. The sampler takes the JAX
package's seed uniforms as injected draws and must return the same
candidates.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnetgpd_tpu.grasping.gripper import Gripper as JGripper
from pointnetgpd_tpu.grasping import samplers as jsamplers
from pointnetgpd_tpu.ops import cloud as jc
from pointnetgpd_tpu_torch.grasping import samplers as tsamplers
from pointnetgpd_tpu_torch.grasping.gripper import Gripper, panel_box_array
from pointnetgpd_tpu_torch.ops import cloud as tc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU; torch's thread pool in each worker
    oversubscribes it (the port's tests ran 10x slower under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return np.asarray(a)


def _jittered(seed, n=1500, scale=0.2):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, 3) * scale).astype(np.float32)


def _tabletop(seed, n=700):
    rs = np.random.RandomState(seed)
    top = rs.rand(n, 3) * [0.06, 0.06, 0] + [0, 0, 0.08]
    front = rs.rand(n, 3) * [0.06, 0, 0.06] + [0, 0, 0.02]
    side = rs.rand(n, 3) * [0, 0.06, 0.06] + [0.06, 0, 0.02]
    pts = np.concatenate([top, front, side]).astype(np.float32)
    pts[:, :2] -= 0.03
    return pts


def _voxelized(seed, n_grid=150):
    """A voxel-center cloud: a regular grid, full of distance ties."""
    centers, mask = jc.voxel_downsample(_tabletop(seed), n_grid=n_grid)
    return np.asarray(centers)[np.asarray(mask)]


@pytest.mark.parametrize("cloud", ["jittered", "tabletop"])
def test_voxel_downsample_and_packed_exact(cloud):
    pts = _jittered(0) if cloud == "jittered" else _tabletop(1)
    for n_grid in (40, 500):
        c_j, m_j = jc.voxel_downsample(pts, n_grid=n_grid)
        c_t, m_t = tc.voxel_downsample(_t(pts), n_grid=n_grid)
        np.testing.assert_array_equal(m_t.numpy(), _np(m_j))
        np.testing.assert_array_equal(c_t.numpy(), _np(c_j))
        p_j, n_j = jc.voxel_downsample_packed(pts, n_grid=n_grid)
        p_t, n_t = tc.voxel_downsample_packed(_t(pts), n_grid=n_grid)
        assert int(n_t) == int(n_j)
        np.testing.assert_array_equal(p_t.numpy(), _np(p_j))


def test_morton_codes_exact():
    pts = _jittered(2)
    np.testing.assert_array_equal(tc.morton_codes(_t(pts)).numpy(),
                                  _np(jc.morton_codes(pts)).astype(np.int64))
    padded = np.concatenate([pts, np.full((50, 3), -1e6, np.float32)])
    bbox = (pts.min(0), pts.max(0))
    np.testing.assert_array_equal(
        tc.morton_codes(_t(padded), bbox=tuple(map(_t, bbox))).numpy(),
        _np(jc.morton_codes(padded, bbox=bbox)).astype(np.int64))


def test_eigvecs_sym3x3():
    rs = np.random.RandomState(3)
    q = rs.randn(200, 3, 3)
    a = (q @ q.transpose(0, 2, 1)).astype(np.float32)
    a[0] = np.eye(3)                                     # isotropic
    v = rs.randn(3).astype(np.float32)
    a[1] = np.outer(v, v)                                # rank 1
    small_j = _np(jc.smallest_eigvec_sym3x3(a))
    small_t = tc.smallest_eigvec_sym3x3(_t(a)).numpy()
    np.testing.assert_allclose(small_t, small_j, atol=ATOL)
    mn_j, mx_j = jc.extreme_eigvecs_sym3x3(a)
    mn_t, mx_t = tc.extreme_eigvecs_sym3x3(_t(a))
    np.testing.assert_allclose(mn_t.numpy(), _np(mn_j), atol=ATOL)
    np.testing.assert_allclose(mx_t.numpy(), _np(mx_j), atol=ATOL)


def test_pairwise_d2_and_min_k_exact_on_grid_ties():
    pts = _voxelized(4)
    q = pts[::7]
    # jitted, as on the frame path (XLA fuses it only under jit)
    d_j = _np(jax.jit(jc.pairwise_d2)(q, pts))
    d_t = tc.pairwise_d2(_t(q), _t(pts)).numpy()
    np.testing.assert_array_equal(d_t, d_j)
    _, i_j = jc.min_k(jnp.asarray(d_j), 30, exact=True)
    _, i_t = tc.min_k(_t(d_t), 30)
    np.testing.assert_array_equal(i_t.numpy(), _np(i_j))
    # the grid really has ties at the selection boundary
    srt = np.sort(d_j, axis=1)
    assert (srt[:, 29] == srt[:, 30]).any()


@pytest.mark.parametrize("cloud", ["jittered", "voxelized"])
def test_estimate_normals_knn(cloud):
    pts = _jittered(5, n=1200) if cloud == "jittered" else _voxelized(5)
    cam = np.array([0.5, 0.5, 1.0], np.float32)
    n_j = _np(jc.estimate_normals_knn(pts, cam, k=30, chunk=256, exact=True))
    n_t = tc.estimate_normals_knn(_t(pts), _t(cam), k=30, chunk=256).numpy()
    np.testing.assert_allclose(n_t, n_j, atol=ATOL)


def test_estimate_normals_knn_window():
    pts = _voxelized(6)
    padded = np.concatenate([pts, np.full((100, 3), -1e6, np.float32)])
    cam = np.array([0.5, 0.5, 1.0], np.float32)
    bbox = (pts.min(0), pts.max(0))
    n_j = _np(jc.estimate_normals_knn_window(
        padded, cam, k=20, window=512, q_chunk=128, exact=True,
        bbox=tuple(map(jnp.asarray, bbox))))
    n_t = tc.estimate_normals_knn_window(
        _t(padded), _t(cam), k=20, window=512, q_chunk=128,
        bbox=tuple(map(_t, bbox))).numpy()
    np.testing.assert_allclose(n_t[:len(pts)], n_j[:len(pts)], atol=ATOL)


@pytest.mark.parametrize("window", [256, 4096])   # windowed / dense branch
def test_seed_window_normals(window):
    pts = _voxelized(7)
    cam = np.array([0.5, 0.5, 1.0], np.float32)
    seed_idx = np.random.RandomState(7).choice(len(pts), 24, replace=False)
    bbox = (pts.min(0), pts.max(0))
    pd_j, nn_j, sn_j = jc.seed_window_normals(
        pts, jnp.asarray(seed_idx), cam, k=30, knn=100, window=window,
        exact=True, bbox=tuple(map(jnp.asarray, bbox)))
    pd_t, nn_t, sn_t = tc.seed_window_normals(
        _t(pts), _t(seed_idx), _t(cam), k=30, knn=100, window=window,
        bbox=tuple(map(_t, bbox)))
    np.testing.assert_array_equal(pd_t.numpy(), _np(pd_j))
    np.testing.assert_allclose(nn_t.numpy(), _np(nn_j), atol=ATOL)
    np.testing.assert_allclose(sn_t.numpy(), _np(sn_j), atol=ATOL)


class _SeedDraws:
    """The JAX sampler's seed uniforms for ``key``, injected into the port."""

    def __init__(self, key):
        self.k_seed, _ = jax.random.split(key)

    def seed_uniform(self, p, minval=0.0, maxval=1.0):
        if (minval, maxval) == (0.0, 1.0):
            u = jax.random.uniform(self.k_seed, (p,))
        else:
            u = jax.random.uniform(self.k_seed, (p,), minval=minval,
                                   maxval=maxval)
        return torch.from_numpy(np.array(u))


def test_gripper_copy_matches_jax_package():
    g = JGripper()
    from pointnetgpd_tpu.grasping.gripper import panel_box_array as jboxes

    np.testing.assert_array_equal(panel_box_array(Gripper()), jboxes(g))
    assert Gripper().open_width == g.open_width


@pytest.mark.parametrize("mode,seed_bias", [("lazy", "none"),
                                            ("normals", "none"),
                                            ("lazy", "height")])
def test_gpg_sample_candidates_matches_jax(mode, seed_bias):
    pts = _voxelized(8, n_grid=200)
    pts = np.concatenate([pts, np.full((64, 3), -1e6, np.float32)])
    cam = np.array([0.5, 0.5, 1.0], np.float32)
    finite = pts[:, 0] > -9.9e5
    bbox = (pts[finite].min(0), pts[finite].max(0))
    key = jax.random.PRNGKey(3)
    kw = dict(num_seeds=24, camera_pos=cam, normal_k=30, normal_window=256,
              seed_bias=seed_bias, debug=True)
    normals = None
    if mode == "normals":
        normals = _np(jc.estimate_normals_knn(pts, cam, k=30, exact=True))
    (cj, fj) = jsamplers.gpg_sample_candidates(
        pts, normals, key, JGripper(), exact=True,
        bbox=tuple(map(jnp.asarray, bbox)), **kw)
    (ct, ft) = tsamplers.gpg_sample_candidates(
        _t(pts), None if normals is None else _t(normals), Gripper(),
        bbox=tuple(map(_t, bbox)), draws=_SeedDraws(key), **kw)
    vj = _np(cj.valid)
    np.testing.assert_array_equal(ct.valid.numpy(), vj)
    assert vj.sum() > 0
    np.testing.assert_allclose(ct.frames.numpy()[vj], _np(cj.frames)[vj],
                               atol=1e-5)
    for name in tsamplers.FUNNEL_STAGES:
        assert int(ft[name]) == int(fj[name]), name
    np.testing.assert_array_equal(ft["seed_heights"].numpy(),
                                  _np(fj["seed_heights"]))
