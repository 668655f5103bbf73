"""The port's GPD baseline against the plain reference the benchmark holds it
to (``benchmarks/reference/gpd.py``): the per-sample crop, the k-NN normals,
the projection features, and one train step's loss, gradients and Adam
update, at a small size on the CPU (batch 4, 2,000-point box-surface
clouds, 200 points a crop, 12 and 3 channels, seeded weights); the
reference's projection against images worked out by hand; the GPD step's
spans; and, on the card, that its convolution gradients do not depend on
cuDNN's global TF32 flag.

The reference imports nothing of the program, so the two meet only in
these tests and in the benchmark's cell. Tolerances, each with its reason:

- crops: equal bit for bit (the reference rounds frame coordinates as the
  program is specified to, and takes the same keys and ranks);
- normals: within 1e-4 rad, away from near-degenerate neighbourhoods (a
  near tie at the 30th neighbour, where float32 distances in the program's
  matmul form may pick another point; two smallest eigenvalues within 1%
  of the largest; a normal all but perpendicular to the camera's ray,
  whose flip either side may take); the program solves float32 3x3
  eigenproblems in closed form, the reference float64 ``eigh``;
- projections of the same normals: within 1e-6 (float32 sums of at most
  50 unit normals, in other orders);
- features from each side's own normals: at most 1% of the cells over
  1e-5 (the cells of the excluded neighbourhoods above);
- the loss within 1e-6 relative and gradients within 1e-5 relative to
  each leaf's largest (float32 on both sides, other summation orders); the
  parameters after the Adam update within two float32 ulps of |p| (the
  sides round the subtraction apart) plus 1e-5 of the learning rate (the
  first update, lr g / (|g| + eps), moves with g where |g| is small, so it
  carries the gradients' own agreement).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks.reference import gpd as ref  # noqa: E402
from pointnetgpd_tpu_torch.draws import Draws  # noqa: E402
from pointnetgpd_tpu_torch.inference.gpd_scorer import (  # noqa: E402
    CAMERA, gpd_features)
from pointnetgpd_tpu_torch.models import gpd as tgpd  # noqa: E402
from pointnetgpd_tpu_torch.ops.cloud import estimate_normals_knn  # noqa: E402
from pointnetgpd_tpu_torch.ops.crop import (  # noqa: E402
    collect_grasp_clouds_percloud)
from pointnetgpd_tpu_torch.ops.projection import (  # noqa: E402
    gpd_projection_features)
from pointnetgpd_tpu_torch.training import train  # noqa: E402
from pointnetgpd_tpu_torch.utils.profiling import span  # noqa: E402

B, P, N, K = 4, 2000, 200, 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU (see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, p=P, b=B):
    """(grasps (B, 12), clouds (B, p, 3), transforms, labels, weights):
    each cloud on the six faces of a box of 4-6 cm sides, spread by area
    and turned at random; grasps at the cloud's mean plus 5 mm noise,
    random axis and approach angle, width 0.08 m."""
    rs = np.random.RandomState(seed)
    clouds = np.zeros((b, p, 3), np.float32)
    for i in range(b):
        sides = rs.uniform(0.04, 0.06, 3)
        area = np.repeat([sides[1] * sides[2], sides[0] * sides[2],
                          sides[0] * sides[1]], 2)
        face = rs.choice(6, p, p=area / area.sum())
        pts = (rs.rand(p, 3) - 0.5) * sides
        ax = face // 2
        pts[np.arange(p), ax] = (face % 2 * 2 - 1) * sides[ax] / 2
        q = np.linalg.qr(rs.randn(3, 3))[0]
        clouds[i] = pts @ q
    grasps = np.zeros((b, 12), np.float32)
    grasps[:, :3] = clouds.mean(1) + rs.randn(b, 3) * 0.005
    axes = rs.randn(b, 3)
    grasps[:, 3:6] = axes / np.linalg.norm(axes, axis=1, keepdims=True)
    grasps[:, 6] = 0.08
    grasps[:, 7] = rs.uniform(-np.pi, np.pi, b)
    transforms = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    labels = rs.randint(0, 2, b)
    return (torch.from_numpy(grasps), torch.from_numpy(clouds),
            torch.from_numpy(transforms), torch.from_numpy(labels),
            torch.ones(b))


def _ref_crop(batch, seed, p=P):
    """The reference's crop under the draws ``Draws(seed)`` makes for the
    program, in the program's order: the keys, then the ranks."""
    d = Draws(seed)
    keys = d.crop_keys(B, ref.key_width(p))
    return ref.crop(*batch[:3], keys, lambda c: d.crop_ranks(c, N),
                    num_out=N, min_points=50)


def _crop(batch, seed):
    return collect_grasp_clouds_percloud(*batch[:3], Draws(seed), num_out=N,
                                         min_point_limit=50)


def _model(chann, seed=0):
    torch.manual_seed(seed)
    return tgpd.GPDClassifier(chann)


# ------------------------------------------------------------------ crop

@pytest.mark.parametrize("p", [P, 5000])      # direct keys; interleaved
def test_crop_equals_the_reference(p):
    batch = _batch(1, p)
    pts, counts, valid = _crop(batch, 2)
    r_pts, r_counts, r_valid = _ref_crop(batch, 2, p)
    assert torch.equal(counts, r_counts) and torch.equal(valid, r_valid)
    assert bool(valid.all())
    assert torch.equal(pts, r_pts)


# --------------------------------------------------------------- normals

def _trusted(pts, k=K):
    """Points whose normal is well posed: no near tie at the k-th
    neighbour, the two smallest eigenvalues of the neighbours' covariance
    apart, the normal not perpendicular to the camera's ray (float64)."""
    x = pts.double()
    d2 = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    srt = torch.sort(d2, dim=-1).values
    kth, nxt = srt[..., k - 1], srt[..., k]
    apart = (nxt - kth) > 1e-4 * kth
    nbr = torch.sort(d2, dim=-1, stable=True).indices[..., :k]
    q = torch.gather(x[:, None].expand(-1, x.shape[1], -1, -1), 2,
                     nbr[..., None].expand(-1, -1, -1, 3))
    c = q - q.mean(dim=2, keepdim=True)
    lam = torch.linalg.eigvalsh(c.transpose(-1, -2) @ c)
    gap = (lam[..., 1] - lam[..., 0]) > 1e-2 * lam[..., 2]
    n = ref.normals(pts, k=k)
    ray = torch.tensor(CAMERA, dtype=torch.float64) - x
    facing = ((ray * n).sum(-1)).abs() > 1e-3 * ray.norm(dim=-1)
    return apart & gap & facing


def test_normals_agree_with_the_reference_where_well_posed():
    pts, _, valid = _crop(_batch(3), 4)
    assert bool(valid.all())
    got = estimate_normals_knn(pts, torch.tensor(CAMERA), k=K,
                               chunk=min(256, N)).double()
    want = ref.normals(pts, k=K)
    ok = _trusted(pts)
    assert float(ok.float().mean()) > 0.8, "too few well-posed points"
    angle = torch.atan2(torch.linalg.cross(got, want).norm(dim=-1),
                        (got * want).sum(-1))
    assert float(angle[ok].max()) < 1e-4


# ------------------------------------------------------------ projection

@pytest.mark.parametrize("chann", [12, 3])
def test_projection_of_the_same_normals_equals_the_reference(chann):
    batch = _batch(5)
    pts, _, _ = _crop(batch, 6)
    nrm = estimate_normals_knn(pts, torch.tensor(CAMERA), k=K, chunk=N)
    got = gpd_projection_features(pts, nrm, torch.ones(pts.shape[:2],
                                                       dtype=torch.bool),
                                  batch[0][:, 6], project_chann=chann)
    want = ref.features(pts, nrm, batch[0][:, 6], chann=chann)
    assert got.shape == want.shape == (B, 60, 60, chann)
    assert float((got > 0).float().mean()) > 0.001   # images not empty
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("chann", [12, 3])
def test_features_agree_with_the_reference(chann):
    batch = _batch(7)
    got, valid = train.make_gpd_feature_fn(
        num_points=N, project_chann=chann, knn_k=K)(*batch[:3], Draws(8))
    pts, _, r_valid = _ref_crop(batch, 8)
    want = ref.features(pts, ref.normals(pts, k=K), batch[0][:, 6],
                        chann=chann)
    assert torch.equal(valid, r_valid)
    off = ((got - want).abs() > 1e-5).float().mean()
    assert float(off) <= 0.01


def _hand_cloud():
    """Three points at res = 0.059 / 59 (about 1 mm): two in voxel (30, 30,
    30), one in (30, 30, 33); normals along x, y and z."""
    pts = torch.tensor([[0.0002, 0.0003, 0.0004], [0.0006, 0.0007, 0.0008],
                        [0.0005, 0.0005, 0.0035]])
    return pts, torch.eye(3), 0.059


def _hand_images(voxel_point_num):
    """The 12 channels by hand. Order (0, 1, 2): cell (30, 30) sees voxels
    w = 30 and 33 and takes the larger: one point, normal z, occupancy 1.
    Orders (1, 2, 0) and (0, 2, 1): the two voxels fall on cells (30, 30)
    (two points, or the first only at a cap of 1, the mean of their
    normals) and (30, 33) (normal z); occupancy over the image's largest
    count."""
    img = torch.zeros((60, 60, 12))
    img[30, 30, 0], img[30, 30, 3] = 1.0, 1.0
    first = torch.tensor([0.5, 0.5, 0.0]) if voxel_point_num > 1 \
        else torch.tensor([1.0, 0.0, 0.0])
    for base in (4, 8):
        img[30, 30, base] = 1.0
        img[30, 30, base + 1:base + 4] = first
        img[30, 33, base] = 0.5 if voxel_point_num > 1 else 1.0
        img[30, 33, base + 3] = 1.0
    return img


@pytest.mark.parametrize("voxel_point_num", [50, 1])
@pytest.mark.parametrize("side", ["reference", "port"])
def test_projection_of_three_points_by_hand(side, voxel_point_num):
    pts, nrm, width = _hand_cloud()
    if side == "reference":
        got = ref.features(pts[None], nrm[None], torch.tensor([width]),
                           voxel_point_num=voxel_point_num)[0]
    else:
        got = gpd_projection_features(
            pts[None], nrm[None], torch.ones((1, 3), dtype=torch.bool),
            torch.tensor([width]), voxel_point_num=voxel_point_num)[0]
    torch.testing.assert_close(got, _hand_images(voxel_point_num),
                               rtol=0, atol=1e-7)


# ------------------------------------------------------------ train step

@pytest.mark.parametrize("chann", [12, 3])
def test_train_step_equals_the_reference(chann):
    """One program step against the reference on the program's own
    features: loss, gradients (as they stand after the step), one Adam
    update."""
    batch = _batch(9)
    model = _model(chann, seed=chann)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = train.init_train_state(model, train.make_optimizer(
        1e-3, 30, 0.1, 8))
    step = train.make_gpd_train_step(num_points=N, project_chann=chann,
                                     knn_k=K)
    _, metrics = step(state, *batch, Draws(10))
    feats, valid = train.make_gpd_feature_fn(
        num_points=N, project_chann=chann, knn_k=K)(*batch[:3], Draws(10))
    loss, grads = ref.gradients(start, feats, batch[3],
                                batch[4] * valid.float())
    assert abs(float(metrics["loss"]) - loss) <= 1e-6 * abs(loss)
    m = {k: torch.zeros_like(v) for k, v in start.items()}
    v = {k: torch.zeros_like(x) for k, x in start.items()}
    tol = {k: 2.4e-7 * x.abs() + 1e-5 * 1e-3 for k, x in start.items()}
    ref.adam_step(start, grads, m, v, 1, 1e-3)
    for name, p in model.named_parameters():
        g = grads[name]
        assert float((p.grad - g).abs().max()) <= 1e-5 * float(
            g.abs().max()), name
        assert bool(((p.detach() - start[name]).abs()
                     <= tol[name]).all()), name


@pytest.mark.parametrize("settings", [
    {}, dict(stride=2, padding=1, dilation=2), dict(groups=2)])
def test_strict_convolution_gradients_are_the_convolution_s(settings):
    """The convolution that keeps TF32 off in its backward has the
    gradients of conv2d (float64 finite differences) and its outputs, at
    the module's default settings and at others."""
    conv = torch.nn.Conv2d(4, 6, 3, **settings).double()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 4, 9, 9), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    assert torch.equal(tgpd._conv(x, conv), conv(x))
    assert torch.autograd.gradcheck(
        lambda x, w, b: tgpd._StrictConv2d.apply(
            x, w, b, list(conv.stride), list(conv.padding),
            list(conv.dilation), conv.groups),
        (x, conv.weight, conv.bias))


# ----------------------------------------------------------------- spans

def _ranges(prof):
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.activity_type() == "user_annotation":
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return out


@pytest.mark.parametrize("chann,projections", [(12, 3), (3, 1)])
def test_a_gpd_step_opens_its_spans(chann, projections):
    batch = _batch(11)
    state = train.init_train_state(_model(chann), train.make_optimizer(1e-3))
    step = train.make_gpd_train_step(num_points=N, project_chann=chann,
                                     knn_k=K)
    step(state, *batch, Draws(12))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, *batch, Draws(12))
    got = _ranges(prof)
    counts = {s: len(got.get(s, [])) for s in ("gpd.crop", "gpd.normals",
                                               "gpd.project")}
    assert counts == {"gpd.crop": 1, "gpd.normals": 1,
                      "gpd.project": projections}
    (a, b), = got["train.crop"]
    assert all(a <= s and e <= b for name in counts for s, e in got[name])


def test_gpd_features_open_no_range_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert span("gpd.crop") is span("gpd.project") is span("gpd.normals")
    pts, _, _ = _crop(_batch(13), 14)
    got = gpd_features(pts, torch.full((B,), 0.08), project_chann=12)
    assert got.shape == (B, 60, 60, 12)


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: cuDNN's TF32 exists only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_gpd_conv_gradients_ignore_the_global_tf32_flag(cuda_device):
    """With cuDNN's ``allow_tf32`` left True, one GPD train step's
    convolution weight gradients equal those taken with it False."""
    batch = [t.to(cuda_device) for t in _batch(15, p=50000, b=16)]
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    grads = {}
    try:
        for flag in (True, False):
            cudnn.allow_tf32 = flag
            model = _model(12, seed=1).to(cuda_device)
            state = train.init_train_state(model, train.make_optimizer(1e-3))
            step = train.make_gpd_train_step(num_points=1000,
                                             project_chann=12, knn_k=K)
            step(state, *batch, Draws(16, cuda_device))
            grads[flag] = {n: model.get_parameter(n).grad.clone()
                           for n in ("conv1.weight", "conv2.weight")}
    finally:
        cudnn.allow_tf32 = saved
    for name, g in grads[False].items():
        scale = float(g.abs().max())
        assert scale > 0
        assert float((grads[True][name] - g).abs().max()) <= 1e-6 * scale, \
            name
