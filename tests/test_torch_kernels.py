"""The port's kernel modules against the JAX package.

K1, the GPG panel-count scan (pointnetgpd_tpu_torch/ops/gpg_counts.py): the
plain version must equal ``gpg_scan_counts_jnp`` exactly, both scan axes.
K2, the fused PointNet trunk (pointnetgpd_tpu_torch/ops/pointnet_trunk.py):
the plain version and the BN folding must match ``trunk_reference`` and the
Pallas ``fused_trunk`` (interpret mode) to atol 1e-4.
K3, the min point-triangle distance (pointnetgpd_tpu_torch/ops/
point_triangle.py): its plain version is held against the JAX package in
tests/test_torch_voxelizer.py; here only its kernel, on a card.

The hand-written CUDA kernels themselves run only on a GPU: the tests marked
``cuda`` compare them with their plain versions there and skip elsewhere.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnetgpd_tpu.models.pointnet import init_pointnet_feat
from pointnetgpd_tpu.ops import gpg_counts_pallas as jk1
from pointnetgpd_tpu.ops import pointnet_trunk_pallas as jk2
from pointnetgpd_tpu_torch.models.convert import state_dict_from_jax
from pointnetgpd_tpu_torch.models.pointnet import PointNetfeat
from pointnetgpd_tpu_torch.ops import gpg_counts as k1
from pointnetgpd_tpu_torch.ops import point_triangle as k3
from pointnetgpd_tpu_torch.ops import pointnet_trunk as k2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU; torch's thread pool in each worker
    oversubscribes it (the port's tests ran 10x slower under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BOXES = np.array(
    [[[-0.02, -0.04, -0.01], [0.02, 0.04, 0.01]],     # open
     [[-0.03, -0.04, -0.01], [-0.02, 0.04, 0.01]],    # bottom
     [[-0.02, -0.05, -0.01], [0.02, -0.04, 0.01]],    # left
     [[-0.02, 0.04, -0.01], [0.02, 0.05, 0.01]]],     # right
    np.float32)
ATOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _random_case(seed, p=3000, f=37, ns=13):
    """Jittered random scene shaped like tests/test_gpg_counts_pallas.py."""
    rs = np.random.RandomState(seed)
    pts = rs.rand(p, 3).astype(np.float32) * 0.2 - 0.1
    seeds = pts[rs.choice(p, f)] + rs.randn(f, 3).astype(np.float32) * 1e-3
    q = rs.randn(f, 3, 3).astype(np.float32)
    u, _, vt = np.linalg.svd(q)
    rots = np.ascontiguousarray((u @ vt).astype(np.float32))
    fixed = (rs.rand(f).astype(np.float32) - 0.5) * 0.02
    scan = (rs.rand(f, ns).astype(np.float32) - 0.5) * 0.06
    return pts, seeds, rots, fixed, scan


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# --------------------------------------------------------------------- K1

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scan_is_y", [True, False])
def test_k1_plain_equals_jnp_oracle(seed, scan_is_y):
    pts, seeds, rots, fixed, scan = _random_case(seed)
    want = np.asarray(jk1.gpg_scan_counts_jnp(
        pts, seeds, rots, fixed, scan, BOXES, scan_is_y=scan_is_y))
    got = k1.gpg_scan_counts_torch(*_t(pts, seeds, rots, fixed, scan), BOXES,
                                   scan_is_y=scan_is_y, frame_chunk=16)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


def test_k1_plain_rounds_like_the_oracle_on_box_bounds():
    """Points placed on the rounding edge of a box bound: only the same
    fused-multiply-add association as the JAX CPU build classifies them the
    same way, so this case catches a plain version that rounds otherwise."""
    rs = np.random.RandomState(11)
    f, p = 24, 4000
    seeds = np.zeros((f, 3), np.float32)
    q = rs.randn(f, 3, 3).astype(np.float32)
    u, _, vt = np.linalg.svd(q)
    rots = np.ascontiguousarray((u @ vt).astype(np.float32))
    # points whose frame-0 coordinates sit within a few ulps of x = 0.02
    local = rs.rand(p, 3).astype(np.float32) * [0.0, 0.08, 0.02] \
        + [0.02, -0.04, -0.01]
    local[:, 0] += (rs.rand(p).astype(np.float32) - 0.5) * 4e-9
    pts = (local @ rots[0]).astype(np.float32)
    fixed = np.zeros(f, np.float32)
    scan = np.zeros((f, 3), np.float32)
    for scan_is_y in (True, False):
        want = np.asarray(jk1.gpg_scan_counts_jnp(
            pts, seeds, rots, fixed, scan, BOXES, scan_is_y=scan_is_y))
        got = k1.gpg_scan_counts_torch(*_t(pts, seeds, rots, fixed, scan),
                                       BOXES, scan_is_y=scan_is_y)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("scan_is_y", [True, False])
def test_k1_context_active_mask_contract(scan_is_y):
    """A context with an ``active`` mask returns the oracle's counts on every
    active frame (inactive frames are don't-cares by contract)."""
    pts, seeds, rots, fixed, scan = _random_case(3, f=40)
    active = np.zeros(40, bool)
    active[:19] = True
    ctx = k1.GpgScanContext(*_t(pts, seeds, rots), BOXES,
                            active=torch.from_numpy(active))
    got = ctx.counts(*_t(fixed, scan), scan_is_y=scan_is_y).numpy()
    jctx = jk1.GpgScanContext(pts, seeds, rots, BOXES,
                              active=jnp.asarray(active))
    want = np.asarray(jctx.counts(fixed, scan, scan_is_y=scan_is_y,
                                  interpret=True))
    np.testing.assert_array_equal(got[active], want[active])
    assert want[active].sum() > 0


def test_k1_sentinel_padding_and_empty_region():
    """Far sentinel points (the detector's bucket tail) count nowhere; a
    cloud far from every box counts zero."""
    pts, seeds, rots, fixed, scan = _random_case(4, p=500, f=5, ns=4)
    padded = np.concatenate([pts, np.full((300, 3), -1e6, np.float32)])
    a = k1.GpgScanContext(*_t(padded, seeds, rots), BOXES).counts(
        *_t(fixed, scan), scan_is_y=False)
    b = jk1.gpg_scan_counts_jnp(pts, seeds, rots, fixed, scan, BOXES,
                                scan_is_y=False)
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    far = np.full((100, 3), 5.0, np.float32)
    z = k1.GpgScanContext(*_t(far, seeds, rots), BOXES).counts(
        *_t(fixed, scan), scan_is_y=True)
    assert (z.numpy() == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("scan_is_y", [True, False])
def test_k1_kernel_equals_plain_on_card(cuda_device, scan_is_y):
    pts, seeds, rots, fixed, scan = _random_case(5, p=5000, f=300, ns=25)
    rs = np.random.RandomState(0)
    active = torch.from_numpy(rs.rand(300) < 0.3)
    dev = [t.to(cuda_device) for t in _t(pts, seeds, rots, fixed, scan)]
    ctx = k1.GpgScanContext(*dev[:3], BOXES, active=active.to(cuda_device))
    n0 = k1.launches
    got = ctx.counts(*dev[3:], scan_is_y=scan_is_y).cpu().numpy()
    assert k1.launches == n0 + 1
    want = k1.gpg_scan_counts_torch(*dev, BOXES, scan_is_y=scan_is_y)
    act = active.numpy()
    np.testing.assert_array_equal(got[act], want.cpu().numpy()[act])
    assert (got[~act] == 0).all()


# --------------------------------------------------------------------- K2

def _jax_feat(seed, rng):
    params, state = init_pointnet_feat(jax.random.PRNGKey(seed),
                                       input_chann=3)
    params, state = jax.device_get((params, state))
    for bn in ("bn1", "bn2", "bn3"):
        n = state[bn]["mean"].shape[0]
        state[bn] = {"mean": (rng.randn(n) * 0.1).astype(np.float32),
                     "var": (rng.rand(n) + 0.5).astype(np.float32)}
        params[bn] = {"scale": (rng.rand(n) + 0.5).astype(np.float32),
                      "bias": (rng.randn(n) * 0.1).astype(np.float32)}
    return params, state


def _port_feat(params, state):
    feat = PointNetfeat(3)
    feat.load_state_dict(state_dict_from_jax(params, state))
    return feat


def test_k2_fold_trunk_params_matches_jax():
    rng = np.random.RandomState(0)
    params, state = _jax_feat(0, rng)
    want = jk2.fold_trunk_params(params, state)
    got = k2.fold_trunk_params(_port_feat(params, state))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("b,n", [(3, 64), (8, 256)])
def test_k2_plain_matches_jax_reference_and_pallas(b, n):
    rng = np.random.RandomState(b)
    params, state = _jax_feat(b, rng)
    x = rng.randn(b, n, 3).astype(np.float32)
    jfold = jk2.fold_trunk_params(params, state)
    ref = np.asarray(jk2.trunk_reference(jnp.asarray(x), jfold))
    pallas = np.asarray(jk2.fused_trunk(jnp.asarray(x), jfold,
                                        interpret=True))
    with torch.no_grad():
        folded = k2.fold_trunk_params(_port_feat(params, state))
        plain = k2.trunk_reference(torch.from_numpy(x), folded).numpy()
        routed = k2.fused_trunk(torch.from_numpy(x), folded).numpy()
    assert plain.shape == (b, 1024)
    np.testing.assert_allclose(plain, ref, atol=ATOL)
    np.testing.assert_allclose(plain, pallas, atol=ATOL)
    np.testing.assert_array_equal(routed, plain)   # CPU tensors: plain


def test_k2_cpu_route_launches_nothing():
    rng = np.random.RandomState(2)
    params, state = _jax_feat(2, rng)
    n0 = k2.launches
    with torch.no_grad():
        k2.fused_trunk(torch.from_numpy(rng.randn(2, 16, 3).astype(
            np.float32)), k2.fold_trunk_params(_port_feat(params, state)))
    assert k2.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(64, 500), (5, 37)])
def test_k2_kernel_matches_plain_on_card(cuda_device, b, n):
    rng = np.random.RandomState(3)
    params, state = _jax_feat(3, rng)
    feat = _port_feat(params, state).to(cuda_device)
    x = torch.from_numpy(rng.randn(b, n, 3).astype(np.float32)).to(
        cuda_device)
    with torch.no_grad():
        folded = k2.fold_trunk_params(feat)
        n0 = k2.launches
        got = k2.fused_trunk(x, folded)
        assert k2.launches == n0 + 1
        want = k2.trunk_reference(x, folded)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=ATOL, rtol=ATOL)


# --------------------------------------------------------------------- K3

@pytest.mark.cuda
def test_k3_kernel_matches_plain_on_card(cuda_device):
    """Random triangles around a blocked 24^3 grid: the pruned kernel
    against the brute-force plain version, distances to rtol 1e-4, atol
    1e-7 (the two Ericson variants agree to rounding)."""
    rs = np.random.RandomState(6)
    tv = ((rs.rand(1000, 3, 3) - 0.5) * 0.1).astype(np.float32)
    pts, _ = k3.blocked_grid(24, 24, 24, [-0.08] * 3, 0.007)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (pts, *k3.pack_triangles(tv))]
    n0 = k3.launches
    got = k3.min_point_triangle_dist2(*args)
    assert k3.launches == n0 + 1
    want = k3.min_point_triangle_dist2_torch(*args)
    np.testing.assert_allclose(got.sqrt().cpu().numpy(),
                               want.sqrt().cpu().numpy(), rtol=1e-4,
                               atol=1e-7)
