"""K5, exact k-NN plane normals (pointnetgpd_tpu_torch/ops/knn_normals.py,
csrc/knn_normals.cu), against its plain version.

On the card ``estimate_normals_knn`` takes K5; ``ops/cloud.py``
``_normals_plain`` is the plain version, run on the same card and the same
inputs. The plain version is held to the JAX package in
tests/test_torch_cloud_sampler.py and tests/test_cloud_ops.py, and to the
benchmark's float64 reference in tests/test_torch_gpd_plain.py.

What must agree, and how closely:

- the neighbours: K5's indices (nearest first) equal
  ``min_k(pairwise_d2(...))``'s exactly, ties toward the lower index
  included: both form the distances in the same float32 rounding;
- the normals: within 1e-4 rad of the plain version's where the normal is
  well posed (the two smallest eigenvalues of the neighbours' covariance
  apart by more than 1% of the largest, the normal more than 1e-3 from
  perpendicular to the camera's ray). K5 fits the plane in float64, the
  plain version in float32, so near-degenerate neighbourhoods may turn the
  two normals apart: those points are counted, and held to a share;
- against float64 normals (the reference's ``eigh`` on the same
  neighbours), wherever the normal is defined (the two smallest
  eigenvalues apart), K5 is off by more than 1e-5 rad on no more points
  than the plain version, and by no more in sum.

The tests marked ``cuda`` skip without a card. The CPU tests hold the build
entry, show that the CPU route neither builds nor launches K5 nor opens its
span, and hold the camera's forms and the span's reader.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import run  # noqa: E402
from pointnetgpd_tpu_torch import _build  # noqa: E402
from pointnetgpd_tpu_torch.draws import Draws  # noqa: E402
from pointnetgpd_tpu_torch.inference.gpd_scorer import CAMERA  # noqa: E402
from pointnetgpd_tpu_torch.ops import cloud as tcloud  # noqa: E402
from pointnetgpd_tpu_torch.ops import knn_normals  # noqa: E402
from pointnetgpd_tpu_torch.ops.crop import (  # noqa: E402
    collect_grasp_clouds_percloud)
from pointnetgpd_tpu_torch.ops.fp import sumsq3  # noqa: E402

ANGLE_TOL = 1e-4          # rad, K5 against the plain version, well posed
F64_TOL = 1e-5            # rad, against float64 normals
ILL_POSED_MAX = 0.05      # share of points whose normal is not well posed


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def box_clouds(rs, b, p):
    """(b, p, 3) float32: each cloud on the six faces of a box of 4-6 cm
    sides, spread by area and turned at random (the GPD cell's clouds)."""
    clouds = np.zeros((b, p, 3), np.float32)
    for i in range(b):
        sides = rs.uniform(0.04, 0.06, 3)
        area = np.repeat([sides[1] * sides[2], sides[0] * sides[2],
                          sides[0] * sides[1]], 2)
        face = rs.choice(6, p, p=area / area.sum())
        pts = (rs.rand(p, 3) - 0.5) * sides
        ax = face // 2
        pts[np.arange(p), ax] = (face % 2 * 2 - 1) * sides[ax] / 2
        clouds[i] = pts @ np.linalg.qr(rs.randn(3, 3))[0]
    return clouds


def cell_crops(seed, dev, b=128, p=50_000, n=1000):
    """(b, n, 3) crops as the GPD train cell makes them: each sample's own
    box-face cloud cropped around a grasp at its mean plus 5 mm noise, with
    a random axis and approach angle, 0.08 m wide, in the grasp's frame."""
    rs = np.random.RandomState(seed)
    clouds = box_clouds(rs, b, p)
    grasps = np.zeros((b, 12), np.float32)
    grasps[:, :3] = clouds.mean(1) + rs.randn(b, 3) * 0.005
    axes = rs.randn(b, 3)
    grasps[:, 3:6] = axes / np.linalg.norm(axes, axis=1, keepdims=True)
    grasps[:, 6] = 0.08
    grasps[:, 7] = rs.uniform(-np.pi, np.pi, b)
    transforms = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    args = [torch.from_numpy(a).to(dev) for a in (grasps, clouds,
                                                  transforms)]
    pts, counts, valid = collect_grasp_clouds_percloud(
        *args, Draws(seed, dev), num_out=n, min_point_limit=50)
    assert bool(valid.all()) and int(counts.min()) >= n
    return pts


def plain_neighbours(pts, k, chunk=256):
    """(B, P, k) indices of the plain version's selection."""
    p_sq = sumsq3(pts)
    return torch.cat([tcloud.min_k(tcloud.pairwise_d2(
        pts[:, q0:q0 + chunk], pts, b_sq=p_sq), k)[1]
        for q0 in range(0, pts.shape[1], chunk)], dim=1)


def k5(pts, camera=CAMERA, k=30):
    """K5's (normals, neighbours): one launch of the wrapper with the
    tests' index output."""
    b = pts.shape[0] if pts.dim() == 3 else 1
    idx = torch.empty((b, pts.shape[-2], min(k, pts.shape[-2])),
                      dtype=torch.int64, device=pts.device)
    n0 = knn_normals.launches
    got = knn_normals.normals(pts, camera, k=k, idx_out=idx)
    assert knn_normals.launches == n0 + 1
    return got, idx


def angle(a, b):
    a, b = a.double(), b.double()
    return torch.atan2(torch.linalg.cross(a, b).norm(dim=-1),
                       (a * b).sum(-1))


def posed(pts, nbr, normals, camera):
    """(well posed, defined) per point, from the float64 covariance of its
    neighbours. Well posed: the two smallest eigenvalues apart by more
    than 1% of the largest, the normal more than 1e-3 from perpendicular
    to the camera's ray. Defined: the two smallest apart by more than
    1e-9 of the largest (a line or a single point has no normal to be
    near)."""
    x = pts.double()
    bi = torch.arange(x.shape[0], device=x.device)[:, None, None]
    q = x[bi, nbr]
    c = q - q.mean(dim=2, keepdim=True)
    lam = torch.linalg.eigvalsh(c.transpose(-1, -2) @ c)
    gap = lam[..., 1] - lam[..., 0]
    ray = torch.as_tensor(camera, dtype=torch.float64, device=x.device) - x
    facing = (ray * normals.double()).sum(-1).abs() > 1e-3 * ray.norm(dim=-1)
    return (gap > 1e-2 * lam[..., 2]) & facing, gap > 1e-9 * lam[..., 2]


def float64_normals(pts, nbr, camera):
    """The reference's float64 normals (``eigh``, turned to the camera) on
    the given neighbour sets."""
    x = pts.double()
    bi = torch.arange(x.shape[0], device=x.device)[:, None, None]
    q = x[bi, nbr]
    c = q - q.mean(dim=2, keepdim=True)
    n = torch.linalg.eigh(c.transpose(-1, -2) @ c).eigenvectors[..., 0]
    cam = torch.as_tensor(camera, dtype=torch.float64, device=x.device)
    n = torch.where((((cam - x) * n).sum(-1) < 0)[..., None], -n, n)
    return n / n.norm(dim=-1, keepdim=True)


def hold(pts, camera=CAMERA, k=30, ill_posed_max=ILL_POSED_MAX):
    """K5 against the plain version on (B, P, 3) ``pts``: equal neighbours,
    normals within ``ANGLE_TOL`` where well posed, at most
    ``ill_posed_max`` of the points ill posed, and, where the normal is
    defined, no further from float64 normals than the plain version.
    Returns (K5's normals, neighbours, the share ill posed)."""
    kk = min(k, pts.shape[1])
    got, idx = k5(pts, camera, k)
    assert torch.equal(idx, plain_neighbours(pts, kk))
    want = tcloud._normals_plain(pts, camera, k=k, chunk=256)
    assert got.dtype == want.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert torch.allclose(got.double().norm(dim=-1),
                          torch.ones(got.shape[:2], dtype=torch.float64,
                                     device=got.device), atol=1e-6)
    # the float64 eigensolves on the host: cuSOLVER's batched solver takes
    # no batch of 128,000
    pts, idx, got_h, want = pts.cpu(), idx.cpu(), got.cpu(), want.cpu()
    if isinstance(camera, torch.Tensor):
        camera = camera.cpu()
    ok, defined = posed(pts, idx, got_h, camera)
    ill = 1.0 - float(ok.float().mean())
    assert ill <= ill_posed_max, f"{ill:.4f} of the points ill posed"
    if bool(ok.any()):
        assert float(angle(got_h, want)[ok].max()) < ANGLE_TOL
    exact = float64_normals(pts, idx, camera)
    e_k5 = angle(got_h, exact)[defined]
    e_plain = angle(want, exact)[defined]
    print(f"K5 on {tuple(pts.shape)}: {ill:.4%} ill posed; against "
          f"float64, {int((e_k5 > F64_TOL).sum())} points over {F64_TOL} "
          f"rad (plain {int((e_plain > F64_TOL).sum())}), sum "
          f"{float(e_k5.sum()):.3g} rad (plain {float(e_plain.sum()):.3g})")
    assert int((e_k5 > F64_TOL).sum()) <= int((e_plain > F64_TOL).sum())
    assert float(e_k5.sum()) <= float(e_plain.sum())
    return got, idx, ill


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k5_matches_plain_at_the_cell_shape(cuda_device, seed):
    """128 crops of 1,000 points, k = 30, as the GPD train cell makes
    them; ``estimate_normals_knn`` takes K5 and returns its normals."""
    pts = cell_crops(seed, cuda_device)
    got, _, _ = hold(pts)
    n0 = knn_normals.launches
    routed = tcloud.estimate_normals_knn(pts, CAMERA, k=30, chunk=256)
    assert knn_normals.launches == n0 + 1
    assert torch.equal(routed, got)


@pytest.mark.cuda
def test_k5_on_a_voxel_grid_with_exact_ties(cuda_device):
    """Voxel centres of a sphere's surface on a 2**-8 m grid, where many
    neighbours lie at exactly equal distances: the ties at the k-th
    neighbour are broken toward the lower index on both routes."""
    rs = np.random.RandomState(3)
    v = rs.randn(40_000, 3)
    v = 0.05 * v / np.linalg.norm(v, axis=1, keepdims=True)
    step = 2.0 ** -8
    grid = np.unique(np.round(v / step), axis=0) * step
    grid = grid[rs.permutation(len(grid))].astype(np.float32)
    pts = torch.from_numpy(np.stack([grid, grid[::-1].copy()])).to(
        cuda_device)
    _, idx, _ = hold(pts, camera=(0.0, 0.0, 1.0), ill_posed_max=0.5)
    # the k-th and the (k+1)-th neighbour tie for many points
    d2 = torch.sort(tcloud.pairwise_d2(pts, pts, b_sq=sumsq3(pts)),
                    dim=-1).values
    assert int((d2[..., 29] == d2[..., 30]).sum()) > 100


@pytest.mark.cuda
def test_k5_on_a_frame_with_a_sentinel_tail(cuda_device):
    """One (20,480, 3) cloud, its last 2,480 rows the robot node's -1e6
    sentinels: real points keep real neighbours; the sentinels, all at one
    place, take the fallback normal [0, 0, 1] on both routes."""
    rs = np.random.RandomState(4)
    real = box_clouds(rs, 1, 18_000)[0]
    cloud = np.full((20_480, 3), -1e6, np.float32)
    cloud[:18_000] = real
    pts = torch.from_numpy(cloud).to(cuda_device)
    cam = torch.tensor([0.0, 0.0, 0.5], device=cuda_device)
    # the sentinels (12.1% of the rows) have no plane: ill posed
    got, idx, _ = hold(pts[None], camera=cam, ill_posed_max=0.15)
    assert int(idx[0, :18_000].max()) < 18_000
    assert torch.equal(got[0, 18_000:], torch.tensor(
        [0.0, 0.0, 1.0], device=cuda_device).expand(2_480, 3))
    n0 = knn_normals.launches
    assert torch.equal(tcloud.estimate_normals_knn(pts, cam, k=30), got[0])
    assert knn_normals.launches == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 2, 7, 29])
def test_k5_on_clouds_smaller_than_k(cuda_device, p):
    """P < k: every point is a neighbour; P = 1: the fallback normal,
    turned to the camera."""
    rs = np.random.RandomState(p)
    pts = torch.from_numpy(box_clouds(rs, 3, p)).to(cuda_device)
    got, idx, _ = hold(pts, ill_posed_max=1.0)
    assert idx.shape == (3, p, p)
    if p == 1:
        assert torch.equal(got.abs(), torch.tensor(
            [0.0, 0.0, 1.0], device=cuda_device).expand(3, 1, 3))
    single = tcloud.estimate_normals_knn(pts[0], CAMERA, k=30)
    assert torch.equal(single, got[0])


@pytest.mark.cuda
def test_k5_adds_no_host_sync(cuda_device):
    """``estimate_normals_knn`` on K5 with the camera on the host (a tuple,
    a host tensor) under ``torch.cuda.set_sync_debug_mode("error")``: no
    synchronisation, hence no blocking copy of the camera."""
    pts = torch.from_numpy(box_clouds(np.random.RandomState(5), 128,
                                      1000)).to(cuda_device)
    tcloud.estimate_normals_knn(pts, CAMERA, k=30)
    torch.cuda.synchronize()
    n0 = knn_normals.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = tcloud.estimate_normals_knn(pts, CAMERA, k=30)
        b = tcloud.estimate_normals_knn(pts, torch.tensor(CAMERA), k=30)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert knn_normals.launches == n0 + 2
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    on_card = tcloud.estimate_normals_knn(
        pts, torch.tensor(CAMERA, device=cuda_device), k=30)
    assert torch.equal(a, on_card)


@pytest.mark.cuda
def test_k5_refuses_what_it_cannot_run(cuda_device):
    """On the card every call runs on K5: float64 points and k above
    ``KMAX`` raise rather than take the plain version."""
    pts = torch.from_numpy(box_clouds(np.random.RandomState(6), 2,
                                      500)).to(cuda_device)
    n0 = knn_normals.launches
    with pytest.raises(ValueError, match="float32"):
        tcloud.estimate_normals_knn(pts.double(), CAMERA, k=30)
    with pytest.raises(ValueError, match="at most"):
        tcloud.estimate_normals_knn(pts, CAMERA, k=knn_normals.KMAX + 1)
    assert knn_normals.launches == n0


# --- CPU ---------------------------------------------------------------------

def _refuse_build(monkeypatch):
    def refuse():
        raise AssertionError("built the kernels on the CPU route")

    monkeypatch.setattr(_build, "library", refuse)


def test_build_compiles_k5_without_contraction():
    assert _build.SOURCES["knn_normals.cu"] == ["-fmad=false"]
    assert (_build.CSRC / "knn_normals.cu").exists()
    assert "knn_normals_launch" in _build.SIGNATURES


@pytest.mark.parametrize("shape", [(2, 300, 3), (300, 3), (1, 3), (3, 20, 3)])
def test_cpu_route_is_the_plain_version(monkeypatch, shape):
    """A CPU cloud takes ``_normals_plain``: no build, no launch."""
    _refuse_build(monkeypatch)
    pts = torch.from_numpy(np.random.RandomState(1).uniform(
        -0.05, 0.05, shape).astype(np.float32))
    assert not knn_normals.takes(pts)
    n0 = knn_normals.launches
    got = tcloud.estimate_normals_knn(pts, CAMERA, k=30, chunk=128)
    assert knn_normals.launches == n0
    assert torch.equal(got, tcloud._normals_plain(pts, CAMERA, k=30,
                                                  chunk=128))


def test_no_normals_kernel_span_on_cpu():
    """Under a profiler the CPU route opens no ``normals.kernel`` range;
    the range around it is recorded, so the profiler sees ranges."""
    from torch.profiler import ProfilerActivity, profile, record_function

    pts = torch.from_numpy(box_clouds(np.random.RandomState(2), 2, 200))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("probe"):
            tcloud.estimate_normals_knn(pts, CAMERA, k=30)
    names = {e.name for e in prof.events()}
    assert "probe" in names and "normals.kernel" not in names


def test_camera_forms_agree_on_cpu():
    """A tuple, a list, a numpy array, a float32 or float64 tensor: the
    same camera rounded to float32, the same normals."""
    pts = torch.from_numpy(box_clouds(np.random.RandomState(3), 2, 400))
    cam = (-1.0, 0.1, 0.3)
    want = tcloud.estimate_normals_knn(pts, cam, k=30)
    for form in (list(cam), np.asarray(cam), torch.tensor(cam),
                 torch.tensor(cam, dtype=torch.float64)):
        assert torch.equal(tcloud.estimate_normals_knn(pts, form, k=30),
                           want)
    assert not torch.equal(
        tcloud.estimate_normals_knn(pts, (1.0, 0.1, 0.3), k=30), want)


def test_camera_is_passed_by_value_from_the_host():
    """A host camera becomes three float32 values and no tensor; a device
    camera (here the CPU stands in for the card) is not copied to the
    host."""
    assert knn_normals._camera(CAMERA, "cpu") == (None, (-1.0, 0.0, 0.0))
    cam, vals = knn_normals._camera(torch.tensor([0.1, 0.2, 0.3],
                                                 dtype=torch.float64), "cpu")
    assert cam is None
    assert vals == tuple(np.float32([0.1, 0.2, 0.3]).tolist())


@pytest.mark.parametrize("bad", ["float64", "k", "idx_shape", "idx_dtype"])
def test_k5_checks_before_building(monkeypatch, bad):
    """``knn_normals.normals`` refuses what K5 cannot run before it builds
    or launches anything."""
    _refuse_build(monkeypatch)
    pts = torch.zeros((2, 50, 3))
    kw = {"k": 30}
    if bad == "float64":
        pts = pts.double()
    elif bad == "k":
        kw["k"] = knn_normals.KMAX + 1
    elif bad == "idx_shape":
        kw["idx_out"] = torch.zeros((2, 50, 29), dtype=torch.int64)
    else:
        kw["idx_out"] = torch.zeros((2, 50, 30), dtype=torch.int32)
    with pytest.raises(ValueError):
        knn_normals.normals(pts, CAMERA, **kw)


def test_cpu_route_takes_any_k():
    """The plain version has no ``KMAX``: k = 40 on the CPU."""
    pts = torch.from_numpy(box_clouds(np.random.RandomState(4), 1, 200))
    got = tcloud.estimate_normals_knn(pts, CAMERA, k=knn_normals.KMAX + 8)
    assert got.shape == pts.shape and torch.isfinite(got).all()


def test_empty_cloud_launches_nothing(monkeypatch):
    """No point or no cloud: zeros of the input's shape, no build."""
    _refuse_build(monkeypatch)
    for shape in ((0, 3), (2, 0, 3), (0, 5, 3)):
        got = knn_normals.normals(torch.zeros(shape), CAMERA, k=30)
        assert got.shape == shape and not got.any()


def _metric():
    return run.load_file(run.HERE / "metrics"
                         / "gpd_train.normals_kernels.py")


def test_normals_kernels_metric_reads_the_span():
    """``gpd_train.normals_kernels``: nothing without a trace, without the
    span (the plain route, or a program without it), else its intervals
    per unit."""
    read = _metric().read
    assert read(SimpleNamespace(trace=None, units=4)) is None
    trace = SimpleNamespace(spans={"gpd.normals": [(0, 1)] * 4})
    assert read(SimpleNamespace(trace=trace, units=4)) is None
    trace.spans["normals.kernel"] = [(0, 1)] * 4
    assert read(SimpleNamespace(trace=trace, units=4)) == 1.0
    assert read(SimpleNamespace(trace=trace, units=2)) == 2.0


def test_normals_kernels_metric_is_declared():
    bench = run.read_json(run.ROOT / "BENCHMARK.json")
    entry = {m["name"]: m for m in bench["per_layer"]}[
        "gpd_train.normals_kernels"]
    assert entry["workloads"] == ["pointnetgpd-fullv-gpd.train-fullv-b128"]
    assert entry["layer"] == "GPD features"
    assert entry["moves"] == "train_samples_per_s"
