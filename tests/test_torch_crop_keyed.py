"""K6, the keyed top-k crop (pointnetgpd_tpu_torch/ops/crop_keyed.py,
csrc/crop_keyed.cu), against its plain version.

On the card, ``_crop_batch`` takes K6 for every crop that is not a prefix
crop; with ``crop_keyed.takes`` forced false it takes the plain version
(``_keyed_plain``) on the same card, under the same draws. The two must
agree bit for bit: the points, the counts and their dtypes. The plain
version is held to the JAX package in tests/test_crop_parity.py,
tests/test_torch_slice.py and tests/test_torch_gpd.py.

The tests marked ``cuda`` skip without a card. The CPU tests hold the build
entries and show that the CPU route neither builds nor launches K6 nor
opens its span.
"""

import re

import numpy as np
import pytest
import torch

from pointnetgpd_tpu_torch import _build
from pointnetgpd_tpu_torch.draws import Draws
from pointnetgpd_tpu_torch.ops import crop as tcrop
from pointnetgpd_tpu_torch.ops import crop_keyed


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _scene(rs, g, p, num_out, *, per_grasp=False):
    """Clouds uniform in a 0.2 m cube, random frames, online boxes
    (x in (0, hd), y in +-w/2, z in +-w/4) of widths from 2 mm to 0.3 m;
    grasp 0 far away (count 0), grasp 1 in a box holding every point, and
    grasp 2 (where there is one) holding exactly min(num_out, p) points: an
    island of them around (5, 5, 5), which no other box reaches."""
    shape = (g, p, 3) if per_grasp else (p, 3)
    pc = rs.uniform(-0.1, 0.1, shape).astype(np.float32)
    centers = rs.uniform(-0.1, 0.1, (g, 3)).astype(np.float32)
    rot = np.linalg.qr(rs.randn(g, 3, 3))[0].astype(np.float32)
    w = rs.choice([0.002, 0.01, 0.03, 0.06, 0.12, 0.3], g).astype(np.float32)
    lo = np.stack([np.zeros_like(w), -w / 2, -w / 4], 1)
    hi = np.stack([np.full_like(w, 0.06), w / 2, w / 4], 1)
    centers[0] = 10.0
    lo[1], hi[1] = -1e3, 1e3
    if g > 2:
        n = min(num_out, p)
        island = rs.uniform(4.99, 5.01, (n, 3)).astype(np.float32)
        if per_grasp:
            pc[2, :n] = island
        else:
            pc[rs.permutation(p)[:n]] = island
        centers[2] = 5.0
        lo[2], hi[2] = -0.5, 0.5
    return pc, centers, rot, lo, hi


def _dev(arrays, dev):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _bits(t):
    return t.contiguous().view(torch.int32)


class TiedDraws(Draws):
    """Keys drawn from four values only, so most keys in a box tie and the
    stable order (the lower position first) decides."""

    def crop_keys(self, g, p_len):
        return torch.floor(super().crop_keys(g, p_len) * 4) / 4


def _both_routes(monkeypatch, args, num_out, seed=0, draws=Draws):
    """(K6's (points, counts), the plain version's) of one crop on the same
    draws; K6 launches twice, the plain version never."""
    dev = args[0].device
    n0 = crop_keyed.launches
    got = tcrop._crop_batch(*args, num_out, draws(seed, dev))
    assert crop_keyed.launches == n0 + 2
    with monkeypatch.context() as m:
        m.setattr(crop_keyed, "takes", lambda *a: False)
        want = tcrop._crop_batch(*args, num_out, draws(seed, dev))
    assert crop_keyed.launches == n0 + 2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(got[1], want[1])
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    return got


# (grasps, points, per-grasp clouds, num_out)
SHAPES = {
    "gpd_cell": (128, 50000, True, 1000),
    "interleave_padded": (24, 5000, True, 750),
    "interleave_padded_shared": (24, 5001, False, 500),
    "direct_4096": (16, 4096, True, 750),
    "direct_1000": (31, 1000, False, 750),
    "shared_g8": (8, 20000, False, 750),
    "shared_g31": (31, 20000, False, 750),
    "below_num_out": (12, 300, True, 500),
    "interleave_below_num_out": (6, 4500, True, 5000),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
def test_k6_matches_plain_on_card(cuda_device, monkeypatch, name):
    g, p, per_grasp, num_out = SHAPES[name]
    rs = np.random.RandomState(sum(map(ord, name)))
    args = _dev(_scene(rs, g, p, num_out, per_grasp=per_grasp), cuda_device)
    _, counts = _both_routes(monkeypatch, args, num_out)
    c = counts.cpu().numpy()
    assert c[0] == 0 and c[1] == p                    # none, every point
    assert c[2] == min(num_out, p)                    # exactly num_out
    assert ((c > 0) & (c < min(num_out, p))).any()    # with replacement
    if p > num_out:
        assert (c > num_out).sum() > 0                # without


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gpd_cell", "interleave_padded",
                                  "direct_1000", "shared_g31"])
def test_k6_keeps_the_stable_order_of_tied_keys(cuda_device, monkeypatch,
                                                name):
    g, p, per_grasp, num_out = SHAPES[name]
    rs = np.random.RandomState(sum(map(ord, name)) + 1)
    args = _dev(_scene(rs, g, p, num_out, per_grasp=per_grasp), cuda_device)
    _both_routes(monkeypatch, args, num_out, draws=TiedDraws)


@pytest.mark.cuda
def test_k6_on_a_row_past_shared_memory(cuda_device, monkeypatch):
    """A cloud of 2M points keys 2,000,016 positions a grasp (a 250 KB bit
    row, past ``SMEM_BYTES``): the row lives in a global scratch, and K6
    still equals the plain version."""
    rs = np.random.RandomState(11)
    p = 2_000_001
    assert 4 * crop_keyed.row_words(crop_keyed.key_len(p), 300) \
        > crop_keyed.SMEM_BYTES
    args = _dev(_scene(rs, 8, p, 300), cuda_device)
    _both_routes(monkeypatch, args, 300)


@pytest.mark.cuda
def test_k6_gpd_crop_on_card(cuda_device, monkeypatch):
    """The GPD step's crop (``collect_grasp_clouds_percloud``: the training
    frames, then K6 on each sample's own cloud) against its plain route."""
    rs = np.random.RandomState(7)
    b, p = 32, 20000
    clouds = rs.uniform(-0.03, 0.03, (b, p, 3)).astype(np.float32)
    grasps = np.zeros((b, 12), np.float32)
    grasps[:, :3] = rs.normal(0, 0.005, (b, 3))
    axes = rs.randn(b, 3)
    grasps[:, 3:6] = axes / np.linalg.norm(axes, axis=1, keepdims=True)
    grasps[:, 6] = 0.08
    grasps[:, 7] = rs.uniform(-np.pi, np.pi, b)
    transforms = np.broadcast_to(np.eye(4, dtype=np.float32), (b, 4, 4))
    args = _dev((grasps, clouds, transforms), cuda_device)
    n0 = crop_keyed.launches

    def run():
        return tcrop.collect_grasp_clouds_percloud(
            *args, Draws(3, cuda_device), num_out=1000)

    got = run()
    assert crop_keyed.launches == n0 + 2
    with monkeypatch.context() as m:
        m.setattr(crop_keyed, "takes", lambda *a: False)
        want = run()
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert int(got[1].max()) > 1000


@pytest.mark.cuda
def test_k6_with_no_grasp_on_card(cuda_device):
    args = _dev(_scene(np.random.RandomState(2), 3, 5000, 64), cuda_device)
    args[1:] = [a[:0] for a in args[1:]]
    n0 = crop_keyed.launches
    pts, counts = tcrop._crop_batch(*args, 64, Draws(0, cuda_device))
    assert crop_keyed.launches == n0
    assert pts.shape == (0, 64, 3) and counts.dtype == torch.int64


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1, 4])
def test_k6_refuses_float64_on_card(cuda_device, which):
    """On the card every keyed crop runs on K6, which computes in float32:
    a float64 input raises rather than taking the plain version."""
    args = _dev(_scene(np.random.RandomState(3), 8, 5000, 64), cuda_device)
    args[which] = args[which].double()
    n0 = crop_keyed.launches
    with pytest.raises(ValueError, match="float32"):
        tcrop._crop_batch(*args, 64, Draws(0, cuda_device))
    assert crop_keyed.launches == n0


@pytest.mark.cuda
def test_k6_adds_no_host_sync(cuda_device):
    """``_crop_batch`` on K6 under ``torch.cuda.set_sync_debug_mode("error")``
    at the GPD cell's shape: no synchronisation. The keys are drawn
    beforehand (a draws source may synchronise; K6 may not)."""
    g, p, per_grasp, num_out = SHAPES["gpd_cell"]
    args = _dev(_scene(np.random.RandomState(13), g, p, num_out,
                       per_grasp=per_grasp), cuda_device)
    keys = torch.rand((g, crop_keyed.key_len(p)), device=cuda_device)

    class _Draws(Draws):
        def crop_keys(self, n, p_len):
            return keys

    tcrop._crop_batch(*args, num_out, _Draws(0, cuda_device))
    torch.cuda.synchronize()
    n0 = crop_keyed.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        pts, counts = tcrop._crop_batch(*args, num_out,
                                        _Draws(0, cuda_device))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert crop_keyed.launches == n0 + 2
    torch.cuda.synchronize()
    assert pts.shape == (g, num_out, 3)


# --- CPU ---------------------------------------------------------------------

def test_build_compiles_k6_without_contraction():
    assert _build.SOURCES["crop_keyed.cu"] == ["-fmad=false"]
    assert (_build.CSRC / "crop_keyed.cu").exists()


def test_k6_entries_match_their_signatures():
    """The two ``extern "C"`` entries of csrc/crop_keyed.cu, each with the
    arity ``_build.SIGNATURES`` binds."""
    src = (_build.CSRC / "crop_keyed.cu").read_text()
    found = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert sorted(found) == ["crop_keyed_gather_launch",
                             "crop_keyed_select_launch"]
    for name, params in found.items():
        assert len(_build.SIGNATURES[name]) == len(params.split(","))


@pytest.mark.parametrize("p", [1, 4096, 4097, 5000, 50000])
def test_k6_layout_sizes(p):
    """The keyed layout's length and the row storage the select launch
    needs: the bits of every position and a power-of-two sort buffer."""
    n = crop_keyed.key_len(p)
    assert n == (p if p <= 4096 else 16 * -(-p // 16))
    assert crop_keyed.seg_len(p) * 16 in (0, n)
    kk = min(1000, p)
    words = crop_keyed.row_words(n, kk)
    buf = words - -(-n // 32) - (-(-n // 32) & 1)
    assert words % 2 == 0 and buf // 2 >= kk and (buf // 2) & (buf // 2 - 1) \
        == 0 and buf // 2 < 2 * max(kk, 1)


@pytest.mark.parametrize("which", [0, 1, 2, 3, 4, 5])
def test_k6_checks_dtypes_before_building(monkeypatch, which):
    """``crop_keyed.crop`` refuses any input that is not float32 (the keys
    included) before it builds or launches anything."""
    def refuse():
        raise AssertionError("built the kernels for a float64 input")

    monkeypatch.setattr(_build, "library", refuse)
    pc, centers, rot, lo, hi = _dev(_scene(np.random.RandomState(4), 8,
                                           5000, 64), "cpu")
    args = [pc, torch.rand(8, crop_keyed.key_len(5000)), centers, rot, lo,
            hi]
    args[which] = args[which].double()
    n0 = crop_keyed.launches
    with pytest.raises(ValueError, match="float32"):
        crop_keyed.crop(*args, 64, Draws(0))
    assert crop_keyed.launches == n0


def test_k6_with_no_grasp_launches_nothing(monkeypatch):
    """No grasp: no build, no launch, empty results of the plain version's
    dtypes and shapes, and the ranks drawn once as the plain version draws
    them."""
    def refuse():
        raise AssertionError("built the kernels for no grasp")

    monkeypatch.setattr(_build, "library", refuse)
    calls = []

    class Counted(Draws):
        def crop_ranks(self, count, num_out):
            calls.append((tuple(count.shape), count.dtype, num_out))
            return super().crop_ranks(count, num_out)

    args = _dev(_scene(np.random.RandomState(5), 2, 5000, 64), "cpu")
    args[1:] = [a[:0] for a in args[1:]]
    keys = torch.rand(0, crop_keyed.key_len(5000))
    n0 = crop_keyed.launches
    pts, counts = crop_keyed.crop(args[0], keys, *args[1:], 64, Counted(0))
    want = tcrop._keyed_plain(args[0], keys, *args[1:], 64, Counted(0))
    assert crop_keyed.launches == n0
    assert calls[0] == calls[1] == ((0,), torch.int64, 64)
    for a, b in zip((pts, counts), want):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("per_grasp,p", [(False, 5000), (True, 5000),
                                         (True, 1000)])
def test_k6_cpu_route_launches_nothing(monkeypatch, per_grasp, p):
    """The keyed crops on the CPU take the plain version: no build, no
    launch."""
    def refuse():
        raise AssertionError("the CPU route built the kernels")

    monkeypatch.setattr(_build, "library", refuse)
    args = _dev(_scene(np.random.RandomState(1), 8, p, 64,
                       per_grasp=per_grasp), "cpu")
    assert not crop_keyed.takes(args[0])
    n0 = crop_keyed.launches
    pts, counts = tcrop._crop_batch(*args, 64, Draws(0))
    assert crop_keyed.launches == n0
    assert pts.shape == (8, 64, 3) and counts.dtype == torch.int64
    c = counts.numpy()
    assert c[0] == 0 and c[1] == p and c[2] == 64


def test_no_crop_keyed_span_on_cpu():
    """Under a profiler the CPU route opens no ``crop.keyed`` range; the
    range around it is recorded, so the profiler sees ranges."""
    from torch.profiler import ProfilerActivity, profile, record_function

    args = _dev(_scene(np.random.RandomState(2), 8, 5000, 64), "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("probe"):
            tcrop._crop_batch(*args, 64, Draws(0))
    names = {e.name for e in prof.events()}
    assert "probe" in names and "crop.keyed" not in names
