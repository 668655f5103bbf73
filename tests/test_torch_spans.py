"""The port's spans on the CPU: each hot path (one online frame, one fused
scoring call, one fused train step) run under ``torch.profiler``, its
ranges read through the profiler's event list as the benchmark's trace
reader reads them. Every span is there, inside its parent; the frame
copies its results to the host in 9 fetches; each root's children cover
it; and a path's outputs are the same bits with the profiler on or off.
"""

import copy
from collections import defaultdict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pointnetgpd_tpu_torch.draws import Draws
from pointnetgpd_tpu_torch.inference import scorer
from pointnetgpd_tpu_torch.models.pointnet import PointNetCls
from pointnetgpd_tpu_torch.robot import node
from pointnetgpd_tpu_torch.training import train
from pointnetgpd_tpu_torch.training.data import SyntheticGraspData
from pointnetgpd_tpu_torch.utils.profiling import span

GPG = ("gpg.seeds", "gpg.local_frames", "gpg.compact", "gpg.tiles", "gpg.dy",
       "gpg.approach", "gpg.final", "gpg.unsort")
FRAME_STAGES = ("frame.pad", "frame.upload_voxel", "frame.bbox",
                "frame.normals", "frame.gpg", "frame.compact", "frame.score",
                "frame.collect", "frame.finish")
SCORE = ("score.crop", "score.forward", "score.rank")

# path -> (root, {span: parent})
PATHS = {
    "frame": ("frame.process", {
        **{s: "frame.process" for s in FRAME_STAGES},
        **{s: "frame.gpg" for s in GPG},
        "cloud.window_normals": "gpg.local_frames",
        "score.candidates": "frame.score",
        **{s: "frame.score" for s in SCORE},
        "score.fetch": "frame.collect"}),
    "score": ("score.candidates", {s: "score.candidates" for s in SCORE}),
    "train": ("train.step", {
        "train.crop": "train.step", "train.fwd_bwd": "train.step",
        "train.adam": "train.step", "train.forward": "train.fwd_bwd",
        "train.backward": "train.fwd_bwd"}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU (see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed, n=700):
    rs = np.random.RandomState(seed)
    top = rs.rand(n, 3) * [0.06, 0.06, 0] + [0.0, 0.0, 0.08]
    front = rs.rand(n, 3) * [0.06, 0, 0.06] + [0.0, 0.0, 0.02]
    side = rs.rand(n, 3) * [0, 0.06, 0.06] + [0.06, 0.0, 0.02]
    pts = np.concatenate([top, front, side]).astype(np.float32)
    pts[:, :2] -= 0.03
    return pts


def _model(k, seed=0):
    torch.manual_seed(seed)
    return PointNetCls(num_points=128, k=k).eval()


def _frame_path():
    cfg = node.DetectorConfig.production(
        num_grasps=20, max_num_samples=32, input_points_num=128,
        minimal_points_send_to_point_net=10, cloud_pad_to=512,
        normal_window=256, adaptive_bucket=False)
    det = node.GraspDetector(scorer.GraspScorer(
        model=_model(3), k=3, num_points=128, pad_to=32, device="cpu"),
        config=cfg)
    pts, cam = _scene(0), np.array([0.5, 0.5, 1.0], np.float32)

    def run():
        out = det.process_frame(pts, cam, seed=3)
        assert out["n_valid"] > 0
        out["points"] = out["points"].numpy()
        return out
    return run


def _score_path():
    pc = _scene(1)
    rs = np.random.RandomState(2)
    g = 32
    cand = np.zeros((g, 5, 3), np.float32)
    cand[:, 0] = pc[rs.choice(len(pc), g)] - [0.03, 0, 0]
    u, _, vt = np.linalg.svd(rs.randn(g, 3, 3))
    cand[:, 1:4] = u @ vt
    cand[:, 4] = cand[:, 0]
    model = _model(3, seed=1)
    args = (torch.from_numpy(pc), torch.from_numpy(cand),
            torch.ones(g, dtype=torch.bool), 0.06, 0.08)

    def run():
        return scorer.score_candidates_fused(
            model, *args, Draws(4), num_points=64, repeat=2, min_points=10)
    return run


def _train_path():
    base = _model(2, seed=2)
    batch = [torch.from_numpy(a) for a in SyntheticGraspData(
        batch_size=8, cloud_points=1024, seed=5).next_batch()]
    step = train.make_fused_train_step(num_points=64, min_point_limit=5)

    def run():
        model = copy.deepcopy(base)
        state = train.init_train_state(model, train.make_optimizer(0.005))
        _, metrics = step(state, *batch, Draws(6))
        return (metrics, {n: p.detach().clone()
                          for n, p in model.named_parameters()})
    return run


MAKERS = {"frame": _frame_path, "score": _score_path, "train": _train_path}


def _ranges(prof):
    """name -> [(start_ns, end_ns)] of the profiler's host annotations."""
    out = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.activity_type() == "user_annotation":
            out[e.name()].append((e.start_ns(), e.end_ns()))
    return out


@pytest.fixture(scope="module")
def runs():
    """path -> (ranges of one profiled run, its output, an unprofiled
    run's output)."""
    got = {}
    for name, make in MAKERS.items():
        run = make()
        run()                                  # first-call set-up
        off = run()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = run()
        got[name] = (_ranges(prof), on, off)
    return got


def _inside(inner, outer):
    s, e = inner
    return any(a <= s and e <= b for a, b in outer)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_every_span_is_inside_its_parent(runs, path):
    ranges = runs[path][0]
    root, parents = PATHS[path]
    assert len(ranges[root]) == 1
    for name, parent in parents.items():
        assert ranges[name], f"{name} missing"
        for iv in ranges[name]:
            assert _inside(iv, ranges[parent]), f"{name} outside {parent}"


@pytest.mark.parametrize("path", sorted(PATHS))
def test_children_cover_their_root(runs, path):
    ranges = runs[path][0]
    root, parents = PATHS[path]
    (a, b), = ranges[root]
    kids = sorted(iv for name, parent in parents.items() if parent == root
                  for iv in ranges[name])
    covered, end = 0, a
    for s, e in kids:
        covered += max(0, e - max(s, end))
        end = max(end, e)
    assert covered >= 0.9 * (b - a), (covered, b - a)


def _assert_same(x, y):
    if isinstance(x, dict):
        assert x.keys() == y.keys()
        for k in x:
            _assert_same(x[k], y[k])
    elif isinstance(x, (tuple, list)):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            _assert_same(u, v)
    elif isinstance(x, torch.Tensor):
        assert x.dtype == y.dtype and torch.equal(x, y)
    else:
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_outputs_are_equal_with_the_profiler_on_or_off(runs, path):
    _, on, off = runs[path]
    _assert_same(on, off)


def test_a_frame_fetches_its_results_in_nine_copies(runs):
    """6 scorer outputs and the frame's 3 extras (frames, valid count,
    voxel count), one copy each."""
    assert len(runs["frame"][0]["score.fetch"]) == 9


def test_span_is_a_shared_null_context_with_no_profiler():
    assert not torch.autograd._profiler_enabled()
    assert span("a") is span("b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("on.inside"):
            pass
        assert span("a") is not span("b")
    with span("off.outside"):
        pass
    names = _ranges(prof)
    assert "on.inside" in names and "off.outside" not in names
