"""The port's kernel modules against the JAX package.

K1, the GPG panel-count scan (pointnetgpd_tpu_torch/ops/gpg_counts.py): the
plain version must equal ``gpg_scan_counts_jnp`` exactly, both scan axes;
so must the kernel's counting scheme (sorted-shift runs and a prefix sum,
``gpg_scan_counts_ranges``) for any shift order, and its tile test
(``tile_slab_mask``) may never drop a point that the oracle counts.
K2, the fused PointNet trunk (pointnetgpd_tpu_torch/ops/pointnet_trunk.py):
the plain version and the BN folding must match ``trunk_reference`` and the
Pallas ``fused_trunk`` (interpret mode) to atol 1e-4, and so must the
kernel's 3xTF32 arithmetic (``trunk_3xtf32``), to 1e-4 * (1 + |ref|).
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
from pointnetgpd_tpu_torch.models import pointnet as port_pointnet
from pointnetgpd_tpu_torch.models.convert import (
    load_reference_checkpoint,
    pointnet_cls_from_state_dict,
    state_dict_from_jax,
)
from pointnetgpd_tpu_torch.models.pointnet import PointNetfeat, pointnet_cls_infer
from pointnetgpd_tpu_torch.ops import gpg_counts as k1
from pointnetgpd_tpu_torch.ops import point_triangle as k3
from pointnetgpd_tpu_torch.ops import pointnet_trunk as k2
from test_torch_voxelizer import _exact_distance, torus


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


def _box_bound_case():
    """24 frames at the origin; 4,000 points whose frame-0 x coordinates sit
    within a few ulps of the box bound x = 0.02."""
    rs = np.random.RandomState(11)
    f, p = 24, 4000
    seeds = np.zeros((f, 3), np.float32)
    q = rs.randn(f, 3, 3).astype(np.float32)
    u, _, vt = np.linalg.svd(q)
    rots = np.ascontiguousarray((u @ vt).astype(np.float32))
    local = rs.rand(p, 3).astype(np.float32) * [0.0, 0.08, 0.02] \
        + [0.02, -0.04, -0.01]
    local[:, 0] += (rs.rand(p).astype(np.float32) - 0.5) * 4e-9
    pts = (local @ rots[0]).astype(np.float32)
    return pts, seeds, rots, np.zeros(f, np.float32), np.zeros((f, 3),
                                                                np.float32)


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
    pts, seeds, rots, fixed, scan = _box_bound_case()
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


@pytest.mark.parametrize("scene", ["box_bounds", "random"])
@pytest.mark.parametrize("scan_is_y", [True, False])
def test_k1_tile_test_never_drops_a_counted_point(scene, scan_is_y):
    """For each frame, the oracle on the cloud with every tile that
    ``tile_slab_mask`` skips replaced by far sentinels counts exactly what
    it counts on the whole cloud."""
    if scene == "box_bounds":
        pts, seeds, rots, fixed, scan = _box_bound_case()
    else:
        pts, seeds, rots, fixed, scan = _random_case(8, p=6000, f=24, ns=9)
    ctx = k1.GpgScanContext(*_t(pts, seeds, rots), BOXES)
    keep = k1.tile_slab_mask(ctx.tile_box, ctx.seeds, ctx.rot_rows,
                             torch.from_numpy(fixed), BOXES,
                             scan_is_y=scan_is_y).numpy()
    cloud = ctx.points.numpy()
    tile_of = np.arange(cloud.shape[0]) // k1.TILE_POINTS
    want = np.asarray(jk1.gpg_scan_counts_jnp(
        cloud, seeds, rots, fixed, scan, BOXES, scan_is_y=scan_is_y))
    for f in range(seeds.shape[0]):
        kept = np.where(keep[f, tile_of][:, None], cloud, np.float32(-1e6))
        got = np.asarray(jk1.gpg_scan_counts_jnp(
            kept, seeds[f:f + 1], rots[f:f + 1], fixed[f:f + 1],
            scan[f:f + 1], BOXES, scan_is_y=scan_is_y))
        np.testing.assert_array_equal(got[0], want[f], err_msg=f"frame {f}")
    assert want.sum() > 0
    if scene == "random":     # the sorted cloud's tiles do get skipped
        assert keep.mean() < 0.8


@pytest.mark.parametrize("ns", [1, 32])
@pytest.mark.parametrize("order", ["ascending", "unsorted", "tied"])
@pytest.mark.parametrize("scan_is_y", [True, False])
def test_k1_range_counts_equal_jnp_oracle(ns, order, scan_is_y):
    """Runs of sorted shifts plus a prefix sum count exactly what the
    oracle's shift walk counts, whatever the order of the shifts."""
    pts, seeds, rots, fixed, scan = _random_case(9, p=2000, f=29, ns=ns)
    rs = np.random.RandomState(ns)
    if order == "ascending":
        scan = np.sort(scan, axis=1)
    elif order == "tied":                 # a few values, repeated
        scan = scan[:, rs.randint(0, max(ns // 4, 1), ns)]
    want = np.asarray(jk1.gpg_scan_counts_jnp(
        pts, seeds, rots, fixed, scan, BOXES, scan_is_y=scan_is_y))
    got = k1.gpg_scan_counts_ranges(*_t(pts, seeds, rots, fixed, scan),
                                    BOXES, scan_is_y=scan_is_y)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


@pytest.mark.parametrize("scan_is_y", [True, False])
def test_k1_context_sorts_the_cloud_by_morton_code(scan_is_y):
    """The context's cloud is the input's real points in Morton order with
    the sentinel tail last, each tile box holds its tile's real points, and
    its counts equal the JAX context's (interpret mode) on active frames."""
    pts, seeds, rots, fixed, scan = _random_case(10, p=2500, f=33, ns=7)
    padded = np.concatenate([pts, np.full((700, 3), -1e6, np.float32)])
    active = np.random.RandomState(1).rand(33) < 0.6
    ctx = k1.GpgScanContext(*_t(padded, seeds, rots), BOXES,
                            active=torch.from_numpy(active))
    cloud = ctx.points.numpy()
    real = cloud[:, 0] > -5e5
    assert real[:2500].all() and not real[2500:].any()
    np.testing.assert_array_equal(np.unique(cloud[:2500], axis=0),
                                  np.unique(pts, axis=0))
    box = ctx.tile_box.numpy()
    for t in range(box.shape[0]):
        tile = cloud[t * k1.TILE_POINTS:(t + 1) * k1.TILE_POINTS]
        tile = tile[tile[:, 0] > -5e5]
        if len(tile):
            np.testing.assert_array_equal(box[t], np.concatenate(
                [tile.min(0), tile.max(0)]))
        else:
            assert (box[t, :3] > box[t, 3:]).all()
    got = ctx.counts(*_t(fixed, scan), scan_is_y=scan_is_y).numpy()
    jctx = jk1.GpgScanContext(padded, seeds, rots, BOXES,
                              active=jnp.asarray(active))
    want = np.asarray(jctx.counts(fixed, scan, scan_is_y=scan_is_y,
                                  interpret=True))
    np.testing.assert_array_equal(got[active], want[active])
    assert want[active].sum() > 0


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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["unsorted", "ns1", "ns32", "all_active",
                                  "empty_cloud", "broadcast_shifts"])
def test_k1_kernel_cases_on_card(cuda_device, case):
    ns = {"ns1": 1, "ns32": 32}.get(case, 21)
    pts, seeds, rots, fixed, scan = _random_case(12, p=4000, f=200, ns=ns)
    if case == "empty_cloud":
        pts = pts[:0]
    if case == "broadcast_shifts":
        scan = np.broadcast_to(scan[0], scan.shape)
    active = np.random.RandomState(2).rand(200) < (
        1.0 if case == "all_active" else 0.4)
    dev = [t.to(cuda_device) for t in _t(pts, seeds, rots, fixed, scan)]
    ctx = k1.GpgScanContext(*dev[:3], BOXES,
                            active=torch.from_numpy(active).to(cuda_device))
    for scan_is_y in (True, False):
        got = ctx.counts(*dev[3:], scan_is_y=scan_is_y).cpu().numpy()
        want = k1.gpg_scan_counts_torch(*dev, BOXES, scan_is_y=scan_is_y)
        np.testing.assert_array_equal(got[active],
                                      want.cpu().numpy()[active])
        assert (got[~active] == 0).all()


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


def test_tf32_split_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10                       # TF32 spacing at 1.0
    v = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2**-23,
                      1.0 + 1.5 * ulp, 3.0], dtype=torch.float32)
    big, small = k2.tf32_split(v)
    np.testing.assert_array_equal(
        big.numpy(), np.float32([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0]))
    assert (big.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (small.view(torch.int32) & 0x1FFF).eq(0).all()
    x = torch.from_numpy(np.random.RandomState(0).randn(1000).astype(
        np.float32))
    b, s = k2.tf32_split(x)
    assert ((b + s - x).abs() <= x.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("b,n", [(3, 64), (8, 256)])
def test_k2_3xtf32_matches_jax_reference_and_pallas(b, n):
    """The kernel's split operands and three TF32 products, emulated in
    fp32, against the JAX reference and the Pallas kernel."""
    rng = np.random.RandomState(b + 10)
    params, state = _jax_feat(b, rng)
    x = rng.randn(b, n, 3).astype(np.float32)
    jfold = jk2.fold_trunk_params(params, state)
    ref = np.asarray(jk2.trunk_reference(jnp.asarray(x), jfold))
    pallas = np.asarray(jk2.fused_trunk(jnp.asarray(x), jfold,
                                        interpret=True))
    with torch.no_grad():
        folded = k2.fold_trunk_params(_port_feat(params, state))
        emu = k2.trunk_3xtf32(torch.from_numpy(x), folded).numpy()
        # one TF32 pass is not enough for this tolerance: the split matters
        w1, b1, w2, b2, w3, b3 = folded
        one = torch.relu(torch.from_numpy(x) @ w1 + b1)
        one = torch.relu(k2.tf32_round(one) @ k2.tf32_round(w2) + b2)
        one = torch.amax(k2.tf32_round(one) @ k2.tf32_round(w3) + b3, dim=1)
    np.testing.assert_allclose(emu, ref, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(emu, pallas, atol=ATOL, rtol=ATOL)
    assert np.abs(one.numpy() - ref).max() > 10 * np.abs(emu - ref).max()


def test_k2_3xtf32_reproduces_the_golden_checkpoint(monkeypatch):
    root = jk2.__file__.rsplit("/pointnetgpd_tpu/", 1)[0]
    io = np.load(f"{root}/tests/fixtures/golden_io.npz")
    model = pointnet_cls_from_state_dict(load_reference_checkpoint(
        f"{root}/tests/fixtures/golden_pointnet_3class.npz"),
        num_points=500, device="cpu")
    monkeypatch.setattr(port_pointnet, "fused_trunk", k2.trunk_3xtf32)
    x = torch.from_numpy(io["x"]).transpose(1, 2).contiguous()
    logp, trans = pointnet_cls_infer(model, x)
    np.testing.assert_allclose(trans.numpy(), io["trans"], atol=ATOL)
    np.testing.assert_allclose(logp.numpy(), io["logp"], atol=ATOL)


def test_k2_weights_sit_in_the_kernels_shared_memory_order():
    """Element (n, k) of a block of rows lies at float offset
    ((n // 8) * K / 4 + k // 4) * 32 + (n % 8) * 4 + k % 4 of its block: the
    no-swizzle core-matrix layout that the kernel's wgmma descriptors read
    (leading byte offset 128, stride byte offset K / 4 * 128)."""
    w = torch.arange(256 * 128, dtype=torch.float32).reshape(256, 128)
    tiled = k2.core_matrix_order(w, 64)
    blocks = tiled.reshape(4, -1)
    n, k = torch.meshgrid(torch.arange(64), torch.arange(128), indexing="ij")
    off = ((n // 8) * 32 + k // 4) * 32 + (n % 8) * 4 + k % 4
    for b in range(4):
        assert torch.equal(blocks[b][off], w[64 * b:64 * (b + 1)])
    assert torch.equal(k2.from_core_matrix_order(tiled), w)
    folded = k2.FoldedTrunk([torch.randn(3, 64), torch.randn(64),
                             torch.randn(64, 128), torch.randn(128),
                             torch.randn(128, 1024), torch.randn(1024)])
    w3b = k2.from_core_matrix_order(folded.tensor_core[5])
    w3s = k2.from_core_matrix_order(folded.tensor_core[6])
    order = [8 * (i // 8) + k2.TF32_K_ORDER[i % 8] for i in range(128)]
    np.testing.assert_allclose((w3b + w3s).numpy(),
                               folded[4].t()[:, order].numpy(), rtol=2**-21)


def test_k2_cpu_route_launches_nothing():
    rng = np.random.RandomState(2)
    params, state = _jax_feat(2, rng)
    n0 = k2.launches
    with torch.no_grad():
        k2.fused_trunk(torch.from_numpy(rng.randn(2, 16, 3).astype(
            np.float32)), k2.fold_trunk_params(_port_feat(params, state)))
    assert k2.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(64, 500), (5, 37), (512, 750), (4, 1),
                                 (1, 300), (3, 129)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 6, 8])
def test_k2_kernel_input_channels_on_card(cuda_device, c):
    """K2 takes 1..8 input channels: the Dual trunk's 6, and the edges 1
    and 8, against the plain version within 1e-4 x (1 + |ref|)."""
    g = torch.Generator().manual_seed(c)
    scale = (0.5, 0.1, 0.2, 0.1, 0.1, 0.1)
    shapes = ((c, 64), (64,), (64, 128), (128,), (128, 1024), (1024,))
    folded = k2.FoldedTrunk([(torch.randn(sh, generator=g) * s).to(
        cuda_device) for sh, s in zip(shapes, scale)])
    x = (torch.randn(37, 300, c, generator=g) * 0.05).to(cuda_device)
    with torch.no_grad():
        n0 = k2.launches
        got = k2.fused_trunk(x, folded)
        assert k2.launches == n0 + 1
        want = k2.trunk_reference(x, folded)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=ATOL, rtol=ATOL)


def _row_shards(folded, mp=2):
    """The mp tensor-parallel shards of a folded trunk: layer 3's output
    rows split, as ``parallel/tp.py`` splits conv3."""
    w1, b1, w2, b2, w3, b3 = folded
    w = w3.shape[1] // mp
    return [k2.FoldedTrunk([w1, b1, w2, b2,
                            w3[:, j * w:(j + 1) * w].contiguous(),
                            b3[j * w:(j + 1) * w].contiguous()])
            for j in range(mp)]


def test_k2_512_row_shards_are_the_full_trunks_halves():
    """A shard of 512 rows is K2's 512-row instance: its operands are the
    kernel's layout at 8 chunks of w3, and its plain and 3xTF32 results are
    the full trunk's columns exactly; widths the kernel lacks are refused
    before any launch."""
    rng = np.random.RandomState(4)
    params, state = _jax_feat(4, rng)
    folded = k2.fold_trunk_params(_port_feat(params, state))
    x = torch.from_numpy(rng.randn(6, 40, 3).astype(np.float32))
    full_ref = k2.trunk_reference(x, folded)
    full_tc = k2.trunk_3xtf32(x, folded)
    for j, sh in enumerate(_row_shards(folded)):
        assert tuple(sh.tensor_core[5].shape) == (8, 8, 32, 8, 4)
        cols = slice(512 * j, 512 * (j + 1))
        assert torch.equal(k2.trunk_reference(x, sh), full_ref[:, cols])
        assert torch.equal(k2.trunk_3xtf32(x, sh), full_tc[:, cols])
    w1, b1, w2, b2, w3, b3 = folded
    narrow = k2.FoldedTrunk([w1, b1, w2, b2, w3[:, :256].contiguous(),
                             b3[:256].contiguous()])
    with pytest.raises(ValueError):
        k2._launch(x, narrow)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(64, 500), (128, 750), (5, 37)])
def test_k2_512_row_instance_matches_plain_on_card(cuda_device, b, n):
    """K2's 512-row instance (a tensor-parallel shard's trunk) against its
    plain version within 1e-4 x (1 + |ref|), one launch per shard."""
    rng = np.random.RandomState(5)
    params, state = _jax_feat(3, rng)
    feat = _port_feat(params, state).to(cuda_device)
    x = torch.from_numpy(rng.randn(b, n, 3).astype(np.float32)).to(
        cuda_device)
    with torch.no_grad():
        for sh in _row_shards(k2.fold_trunk_params(feat)):
            n0 = k2.launches
            got = k2.fused_trunk(x, sh)
            assert k2.launches == n0 + 1 and got.shape == (b, 512)
            want = k2.trunk_reference(x, sh)
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


def _k3_edge_case(case):
    """(points, triangles) float32 for K3's edge cases on the card."""
    rs = np.random.RandomState(7)
    pts, _ = k3.blocked_grid(8, 8, 16, [-0.02, -0.02, -0.04], 0.005)
    tv = ((rs.rand(1000, 3, 3) - 0.5) * 0.1).astype(np.float32)
    if case == "one_supertile":
        tv = tv[:100]
    elif case == "far_block":                # grid 10 m from the mesh
        pts = pts + np.float32(10.0)
    elif case == "degenerate":
        tv[0::4, 1] = tv[0::4, 0]            # a == b
        tv[1::4, 2] = tv[1::4, 1]            # b == c
        tv[2::4] = tv[2::4, :1]              # points
        tv[3::4, 2] = 0.3 * tv[3::4, 0] + 0.7 * tv[3::4, 1]   # collinear
    return pts, tv


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_supertile", "all_padding_supertiles",
                                  "far_block", "degenerate"])
def test_k3_kernel_edge_cases_on_card(cuda_device, case):
    """K3 against its plain version on the edge cases of its walk and body:
    one supertile, all-padding supertiles appended (never better than a
    real one), a block far from the mesh; on degenerate triangles against
    a float64 distance (``_exact_distance``), since the plain version's
    edge priority, the JAX oracle's, misplaces segments with b == c. The
    stats launch returns the same distances and counts at least one
    supertile and one pair per block."""
    pts, tv = _k3_edge_case(case)
    tri_data, sup_data = k3.pack_triangles(tv)
    if case == "all_padding_supertiles":
        pad_t = np.zeros((3 * k3.SUPER, 16), np.float32)
        pad_t[:, 0:9] = k3._FAR
        pad_s = np.zeros((3, 8), np.float32)
        pad_s[:, 0:3] = k3._FAR
        tri_data = np.concatenate([pad_t[:k3.SUPER], tri_data,
                                   pad_t[k3.SUPER:]])
        sup_data = np.concatenate([pad_s[:1], sup_data, pad_s[1:]])
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (pts, tri_data, sup_data)]
    got = k3.min_point_triangle_dist2(*args)
    if case == "degenerate":
        want = _exact_distance(pts, tv)
    else:
        want = k3.min_point_triangle_dist2_torch(*args).sqrt().cpu().numpy()
    np.testing.assert_allclose(got.sqrt().cpu().numpy(), want, rtol=1e-4,
                               atol=1e-7)
    stats = torch.zeros((pts.shape[0] // k3.BLOCK_POINTS, 2),
                        dtype=torch.int32, device=cuda_device)
    again = k3._launch(*args, stats=stats)
    assert torch.equal(again, got)
    assert (stats[:, 0] >= 1).all() and (stats[:, 1] >= 32).all()
    assert (stats[:, 0] <= sup_data.shape[0]).all()


@pytest.mark.cuda
def test_k3_kernel_above_the_old_cap_on_card(cuda_device):
    """A torus of 2,160,000 triangles (16,875 supertiles, above the
    16,384 the kernel sorts at a time): the chunked walk against the brute
    force on 16 point blocks near the surface, rtol 1e-4, atol 1e-7; the
    stats launch returns the same distances."""
    v, f = torus(1500, 720)
    tri_data, sup_data = k3.pack_triangles(v[f].astype(np.float32))
    assert sup_data.shape[0] == 16875 > k3.SORT_CHUNK
    pts, _ = k3.blocked_grid(64, 64, 16, [-0.075, -0.075, -0.01], 0.15 / 64)
    blocks = pts.reshape(-1, k3.BLOCK_POINTS, 3)
    pick = np.linspace(0, len(blocks) - 1, 16).astype(int)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
            for a in (blocks[pick].reshape(-1, 3), tri_data, sup_data)]
    got = k3.min_point_triangle_dist2(*args)
    want = k3.min_point_triangle_dist2_torch(*args)
    np.testing.assert_allclose(got.sqrt().cpu().numpy(),
                               want.sqrt().cpu().numpy(), rtol=1e-4,
                               atol=1e-7)
    stats = torch.zeros((16, 2), dtype=torch.int32, device=cuda_device)
    assert torch.equal(k3._launch(*args, stats=stats), got)
    assert (stats[:, 0] >= 1).all() and (stats[:, 1] >= 32).all()
