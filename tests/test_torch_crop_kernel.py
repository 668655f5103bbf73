"""K4, the prefix rank-select crop (pointnetgpd_tpu_torch/ops/crop_prefix.py,
csrc/crop_prefix.cu), against its plain version.

On the card, ``_crop_batch_prefix`` takes K4; with ``crop_prefix.takes``
forced false it takes the plain version (``_prefix_plain``) on the same
card, under the same draws. The two must agree bit for bit: the points, the
counts and their dtypes. The plain version is held to the JAX package in
tests/test_crop_parity.py, tests/test_torch_slice.py and
tests/test_torch_training.py.

The tests marked ``cuda`` skip without a card. The CPU tests hold the build
entries and show that the CPU route neither builds nor launches K4 nor
opens its span.
"""

import re

import numpy as np
import pytest
import torch

from pointnetgpd_tpu_torch import _build
from pointnetgpd_tpu_torch.draws import Draws
from pointnetgpd_tpu_torch.ops import crop as tcrop
from pointnetgpd_tpu_torch.ops import crop_prefix


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _rotations(rs, g):
    q = np.linalg.qr(rs.randn(g, 3, 3))[0]
    return q.astype(np.float32)


def _scene(rs, g, p, *, per_grasp=False, sentinel_from=None):
    """Clouds uniform in a 0.2 m cube, random frames, online boxes
    (x in (0, hd), y in +-w/2, z in +-w/4) of widths from 2 mm to 0.3 m;
    grasp 0 far away (count 0), grasp 1 in a box holding every point."""
    shape = (g, p, 3) if per_grasp else (p, 3)
    pc = rs.uniform(-0.1, 0.1, shape).astype(np.float32)
    if sentinel_from is not None:
        pc[..., sentinel_from:, :] = -1e6
    centers = rs.uniform(-0.1, 0.1, (g, 3)).astype(np.float32)
    centers[0] = 10.0
    w = rs.choice([0.002, 0.01, 0.03, 0.06, 0.12, 0.3], g).astype(np.float32)
    hd = np.float32(0.06)
    lo = np.stack([np.zeros_like(w), -w / 2, -w / 4], 1)
    hi = np.stack([np.full_like(w, hd), w / 2, w / 4], 1)
    lo[1], hi[1] = -1e3, 1e3
    return pc, centers, _rotations(rs, g), lo, hi


def _dev(arrays, dev):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _bits(t):
    return t.contiguous().view(torch.int32)


def _both_routes(monkeypatch, args, num_out, seed=0):
    """(K4's (points, counts), the plain version's) of one crop on the same
    draws; K4 launches twice, the plain version never."""
    dev = args[0].device
    n0 = crop_prefix.launches
    got = tcrop._crop_batch_prefix(*args, num_out, Draws(seed, dev))
    assert crop_prefix.launches == n0 + 2
    with monkeypatch.context() as m:
        m.setattr(crop_prefix, "takes", lambda *a: False)
        want = tcrop._crop_batch_prefix(*args, num_out, Draws(seed, dev))
    assert crop_prefix.launches == n0 + 2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(got[1], want[1])
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    return got


# (grasps, points, per-grasp clouds, num_out, sentinel tail from)
SHAPES = {
    "score": (512, 20000, False, 750, None),
    "train": (128, 20000, True, 750, None),
    "frame": (64, 20480, False, 500, 18000),
    "edge": (32, 4097, False, 500, None),
    "p_multiple_of_128": (40, 8192, False, 300, None),
    "per_grasp_odd": (33, 5001, True, 200, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
def test_k4_matches_plain_on_card(cuda_device, monkeypatch, name):
    g, p, per_grasp, num_out, tail = SHAPES[name]
    rs = np.random.RandomState(sum(map(ord, name)))
    args = _dev(_scene(rs, g, p, per_grasp=per_grasp, sentinel_from=tail),
                cuda_device)
    _, counts = _both_routes(monkeypatch, args, num_out)
    c = counts.cpu().numpy()
    real = p if tail is None else tail
    assert c[0] == 0 and c[1] == real                 # none, every point
    assert ((c > 0) & (c <= num_out)).any()           # with replacement
    assert (c > num_out).sum() > 1                    # the cyclic window


@pytest.mark.cuda
def test_k4_points_on_box_faces(cuda_device, monkeypatch):
    """Points on a lattice of 2**-8 m (exact in float32) and boxes whose
    faces lie on lattice planes, in frames that permute and flip the axes
    (exact rotations), so many points lie exactly on faces: the strict test
    leaves them out on both routes."""
    rs = np.random.RandomState(5)
    step = np.float32(2.0 ** -8)
    ax = np.arange(-20, 21, dtype=np.float32) * step
    pc = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    pc = pc[rs.permutation(len(pc))[:30000]]
    g = 48
    rot = np.zeros((g, 3, 3), np.float32)
    for i in range(g):
        rot[i, np.arange(3), rs.permutation(3)] = rs.choice([-1.0, 1.0], 3)
    centers = rs.randint(-8, 9, (g, 3)).astype(np.float32) * step
    half = rs.randint(1, 6, (g, 3)).astype(np.float32) * step
    args = _dev((pc, centers, rot, -half, half), cuda_device)
    _, counts = _both_routes(monkeypatch, args, 100)
    frames = np.einsum("gij,gpj->gpi", rot.astype(np.float64),
                       pc[None].astype(np.float64) - centers[:, None])
    strict = (np.abs(frames) < half[:, None]).all(-1).sum(-1)
    np.testing.assert_array_equal(counts.cpu().numpy(), strict)
    on_face = (np.abs(frames) == half[:, None]).any(-1).sum(-1)
    assert on_face.min() > 0


@pytest.mark.cuda
def test_k4_recenter_box_on_card(cuda_device, monkeypatch):
    """The training-frame crop around the recentred grasp center
    (``collect_candidate_clouds(recenter=True)``), K4 against the plain
    version."""
    rs = np.random.RandomState(7)
    g, p = 64, 20000
    pc = rs.uniform(-0.1, 0.1, (p, 3)).astype(np.float32)
    frames = rs.randn(g, 4, 3).astype(np.float32)
    frames[:, 0] = rs.uniform(-0.08, 0.08, (g, 3))
    pc_t, fr = _dev((pc, frames), cuda_device)
    n0 = crop_prefix.launches

    def run():
        return tcrop.collect_candidate_clouds(
            fr[:, 0], fr[:, 1], fr[:, 2], fr[:, 3], pc_t, 0.06, 0.08,
            Draws(3, cuda_device), num_out=500, recenter=True)

    got = run()
    assert crop_prefix.launches == n0 + 2
    with monkeypatch.context() as m:
        m.setattr(crop_prefix, "takes", lambda *a: False)
        want = run()
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert int(got[1].max()) > 0


@pytest.mark.cuda
def test_k4_on_a_cloud_of_two_million_points(cuda_device, monkeypatch):
    """Neither launch keeps a row in shared memory: a cloud of 2M points
    (a 250 KB bit row a grasp, past a block's 227 KB) runs on K4 and
    equals the plain version."""
    rs = np.random.RandomState(11)
    args = _dev(_scene(rs, 32, 2_000_001), cuda_device)
    assert crop_prefix.takes(args[0])
    _both_routes(monkeypatch, args, 300)


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 4])
def test_k4_refuses_float64_on_card(cuda_device, which):
    """On the card every prefix crop runs on K4, which computes in float32:
    a float64 input raises rather than taking the plain version."""
    args = _dev(_scene(np.random.RandomState(3), 32, 4097), cuda_device)
    args[which] = args[which].double()
    n0 = crop_prefix.launches
    with pytest.raises(ValueError, match="float32"):
        tcrop._crop_batch_prefix(*args, 64, Draws(0, cuda_device))
    assert crop_prefix.launches == n0


@pytest.mark.cuda
def test_k4_adds_no_host_sync(cuda_device):
    """``_crop_batch_prefix`` on K4 under
    ``torch.cuda.set_sync_debug_mode("error")``: no synchronisation. The
    shuffle is drawn beforehand (a draws source may synchronise; K4 may
    not)."""
    g, p, _, num_out, _ = SHAPES["score"]
    args = _dev(_scene(np.random.RandomState(13), g, p), cuda_device)
    perm = torch.randperm(p, device=cuda_device)

    class _Draws(Draws):
        def crop_perm(self, n):
            return perm

    tcrop._crop_batch_prefix(*args, num_out, _Draws(0, cuda_device))
    torch.cuda.synchronize()
    n0 = crop_prefix.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        pts, counts = tcrop._crop_batch_prefix(*args, num_out,
                                               _Draws(0, cuda_device))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert crop_prefix.launches == n0 + 2
    torch.cuda.synchronize()
    assert pts.shape == (g, num_out, 3)


# --- CPU ---------------------------------------------------------------------

def test_build_compiles_k4_without_contraction():
    assert _build.SOURCES["crop_prefix.cu"] == ["-fmad=false"]
    assert (_build.CSRC / "crop_prefix.cu").exists()


def _extern_c_arity(name):
    for src in sorted(_build.CSRC.glob("*.cu")):
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)",
                      src.read_text())
        if m:
            return len(m.group(1).split(","))
    raise AssertionError(f"no extern \"C\" {name} in {_build.CSRC}")


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_arity_matches_extern_c(name):
    assert len(_build.SIGNATURES[name]) == _extern_c_arity(name)


@pytest.mark.parametrize("which", [0, 1, 2, 3, 4])
def test_k4_checks_dtypes_before_building(monkeypatch, which):
    """``crop_prefix.crop`` refuses any input that is not float32 before it
    builds or launches anything."""
    def refuse():
        raise AssertionError("built the kernels for a float64 input")

    monkeypatch.setattr(_build, "library", refuse)
    args = _dev(_scene(np.random.RandomState(4), 32, 4097), "cpu")
    args[which] = args[which].double()
    perm = torch.arange(4097)
    with pytest.raises(ValueError, match="float32"):
        crop_prefix.crop(args[0], perm, *args[1:], 64, Draws(0))


def test_k4_with_no_grasp_launches_nothing(monkeypatch):
    """No grasp: no build, no launch, empty results of the plain version's
    dtypes and shapes, and the windows drawn once as the plain version
    draws them."""
    def refuse():
        raise AssertionError("built the kernels for no grasp")

    monkeypatch.setattr(_build, "library", refuse)
    calls = []

    class Counted(Draws):
        def crop_windows(self, count, num_out):
            calls.append((tuple(count.shape), count.dtype, num_out))
            return super().crop_windows(count, num_out)

    args = _dev(_scene(np.random.RandomState(5), 2, 5000), "cpu")
    args[1:] = [a[:0] for a in args[1:]]
    n0 = crop_prefix.launches
    pts, counts = crop_prefix.crop(args[0], torch.arange(5000), *args[1:],
                                   64, Counted(0))
    want = tcrop._prefix_plain(args[0], torch.arange(5000), *args[1:], 64,
                               Counted(0))
    assert crop_prefix.launches == n0
    assert calls[0] == calls[1] == ((0,), torch.int64, 64)
    for a, b in zip((pts, counts), want):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("per_grasp", [False, True])
def test_k4_cpu_route_launches_nothing(monkeypatch, per_grasp):
    """At the prefix route's edge (32 grasps, 4,097 points) the CPU route
    is the plain version: no build, no launch."""
    def refuse():
        raise AssertionError("the CPU route built the kernels")

    monkeypatch.setattr(_build, "library", refuse)
    args = _dev(_scene(np.random.RandomState(1), 32, 4097,
                       per_grasp=per_grasp), "cpu")
    assert not crop_prefix.takes(args[0])
    n0 = crop_prefix.launches
    pts, counts = tcrop._crop_batch_prefix(*args, 64, Draws(0))
    assert crop_prefix.launches == n0
    assert pts.shape == (32, 64, 3) and counts.dtype == torch.int64
    assert int(counts[1]) == 4097


def test_no_crop_kernel_span_on_cpu():
    """Under a profiler the CPU route opens no ``crop.kernel`` range; the
    range around it is recorded, so the profiler sees ranges."""
    from torch.profiler import ProfilerActivity, profile, record_function

    args = _dev(_scene(np.random.RandomState(2), 32, 4097), "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("probe"):
            tcrop._crop_batch_prefix(*args, 64, Draws(0))
    names = {e.name for e in prof.events()}
    assert "probe" in names and "crop.kernel" not in names
