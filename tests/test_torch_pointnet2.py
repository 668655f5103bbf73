"""PointNet++ SSG (``models/pointnet2.py``) and its sampling and grouping
(``ops/pointnet2_sample.py``, kernel K7 on the card) against the plain
reference the benchmark holds them to (``benchmarks/reference/pointnet2.py``),
at a small size on the CPU; the model in the trainer, the CLI and the
scorer; its spans; and, on the card, K7 against its plain version.

The reference imports nothing of the program. Tolerances, each with its
reason:

- indices (farthest-point sampling, ball query): equal, ties included:
  both sides form every squared distance in the same float32 rounding;
- the forward's log-probabilities: within 2e-5 absolute (float32 on both
  sides; the program takes BatchNorm's mean from a float64 sum and
  multiplies by rsqrt, the reference divides by sqrt, so each layer's
  normalized values differ by a few ulps, which the MLPs carry);
- one train step computed in float64 (``compute_dtype``) against the
  reference in float64: the loss within 1e-6 relative (the program takes
  it in float32 from the float64 log-probabilities), each gradient within
  1e-6 of its leaf's largest (the program rounds its float64 gradients to
  the float32 parameters'), left out the 12 biases that a train-mode
  BatchNorm cancels (0 in exact arithmetic); its Adam update within two
  float32 ulps of each parameter of the reference's Adam on the same
  gradients;
- the float32 step against the float64 reference: the loss within 1e-4
  relative, each gradient's norm within 0.05 of max(its norm, the median
  leaf's): at batch 4 the head's BatchNorms normalize over four samples,
  and the float32 step's gradients move by up to 1e-2 there (measured
  over five seeds on the CPU: 5e-5 to 9.6e-3; losses 1.9e-6 to 8.5e-6).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks.kinds.pn2_train import make_weights  # noqa: E402
from benchmarks.reference import pointnet2 as ref  # noqa: E402
from pointnetgpd_tpu_torch import _build  # noqa: E402
from pointnetgpd_tpu_torch.draws import Draws  # noqa: E402
from pointnetgpd_tpu_torch.inference import scorer as tscorer  # noqa: E402
from pointnetgpd_tpu_torch.models import pointnet2 as tpn2  # noqa: E402
from pointnetgpd_tpu_torch.ops import pointnet2_sample as k7  # noqa: E402
from pointnetgpd_tpu_torch.ops.crop import (  # noqa: E402
    collect_candidate_clouds, collect_grasp_clouds_batched)
from pointnetgpd_tpu_torch.training import train  # noqa: E402
from pointnetgpd_tpu_torch.utils.profiling import span  # noqa: E402

CONFIG = json.loads((ROOT / "benchmarks" / "configs"
                     / "pointnet2-ssg-1v-2class.json").read_text())
LOGP_TOL = 2e-5
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-6
F32_LOSS_RTOL = 1e-4
F32_GRAD_GAP = 0.05
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU (see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(seed, b, n, spread=1.0):
    """(b, n, 3) float32, uniform in a box of half extents 0.4, 0.8, 0.4
    (a crop at the model's scale) times ``spread``."""
    rs = np.random.RandomState(seed)
    x = (rs.rand(b, n, 3) - 0.5) * np.array([0.8, 1.6, 0.8]) * spread
    return torch.from_numpy(x.astype(np.float32))


def _model(seed=0, k=2):
    model = tpn2.PointNet2ClsSSG(k=k)
    params = make_weights(CONFIG, seed, "cpu")
    missing, unexpected = model.load_state_dict(params, strict=False)
    assert not unexpected
    assert all(m.endswith("num_batches_tracked") for m in missing)
    return model, params


# ------------------------------------------------------------ the indices

def _fps_cases():
    grid = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"),
                    -1).reshape(1, 64, 3) * 0.1
    dup = _cloud(3, 2, 40)
    dup = torch.cat([dup, dup, dup[:, :7]], dim=1)     # every point 2-3 times
    return {"random": (_cloud(1, 3, 300), 64),
            "grid ties": (torch.from_numpy(grid.astype(np.float32)), 40),
            "duplicates": (dup, 60),
            "more centroids than points": (_cloud(4, 2, 20), 32),
            "one point": (_cloud(5, 2, 1), 3)}


@pytest.mark.parametrize("case", sorted(_fps_cases()))
def test_fps_plain_equals_the_reference(case):
    xyz, npoint = _fps_cases()[case]
    got = k7.fps_plain(xyz, npoint)
    assert got.dtype == torch.int64 and got.shape == (xyz.shape[0], npoint)
    assert torch.equal(got, ref.fps(xyz, npoint))
    assert bool((got[:, 0] == 0).all())


def _ball_cases():
    xyz = _cloud(6, 3, 500)
    few = _cloud(7, 2, 300, spread=4.0)      # sparse: fewer than the slots
    grid = torch.from_numpy(_fps_cases()["grid ties"][0].numpy())
    return {"random": (xyz, xyz[:, :50], 0.2, 32),
            "fewer points than slots": (few, few[:, ::7], 0.2, 32),
            "none found": (few[:, :100], torch.full((2, 3, 3), 50.0), 0.2, 16),
            "on the sphere": (grid, grid[:, :10], 0.1, 8),
            "cloud under nsample": (xyz[:, :20], xyz[:, :5], 0.4, 64),
            "duplicates": (_fps_cases()["duplicates"][0],
                           _fps_cases()["duplicates"][0][:, :9], 0.4, 64)}


@pytest.mark.parametrize("case", sorted(_ball_cases()))
def test_ball_query_plain_equals_the_reference(case):
    xyz, centroids, radius, nsample = _ball_cases()[case]
    got = k7.ball_query_plain(xyz, centroids, radius, nsample)
    assert got.dtype == torch.int64
    assert got.shape == centroids.shape[:2] + (nsample,)
    assert torch.equal(got, ref.ball_query(xyz, centroids, radius, nsample))


def test_ball_query_pads_with_the_first_point_found():
    """By hand: points at 0, 0.5, 0.05, 2 and 0.1 on a line, a ball of
    radius 0.2 about the origin holds points 0, 2 and 4 in that order."""
    xyz = torch.tensor([[[0.0, 0, 0], [0.5, 0, 0], [0.05, 0, 0], [2, 0, 0],
                         [0.1, 0, 0]]])
    got = k7.ball_query_plain(xyz, xyz[:, :1], 0.2, 6)
    assert got.tolist() == [[[0, 2, 4, 0, 0, 0]]]
    assert k7.fps_plain(xyz, 3).tolist() == [[0, 3, 1]]


def test_the_model_scales_as_the_configuration_states():
    """The program's constant is the benchmark configuration's
    ``xyz_scale``, the reciprocal of the crop box's half-diagonal at the
    0.08 m grasp width."""
    assert tpn2.XYZ_SCALE == CONFIG["xyz_scale"]
    assert tpn2.XYZ_SCALE * np.sqrt(0.02 ** 2 + 0.04 ** 2 + 0.02 ** 2) \
        == pytest.approx(1.0, rel=1e-12)


def test_the_squared_radius_is_float32():
    r2 = k7.radius2(0.2)
    assert r2 == float(np.float32(0.2 * 0.2)) and r2 != 0.2 * 0.2


# ------------------------------------------------------------- the model

@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("train_mode", [True, False])
def test_forward_equals_the_reference(n, train_mode):
    """Published widths, batch 4, seeded weights; train mode with the
    batch's statistics, eval mode with the running ones."""
    model, params = _model(seed=n)
    model.train(train_mode)
    x = _cloud(8, 4, n, spread=0.05)     # the crop box, in metres
    with torch.no_grad():
        got, none = model(x)
    assert none is None
    want = ref.forward(params, x, CONFIG, ref.sample(x, CONFIG),
                       train=train_mode)
    assert got.shape == (4, 2)
    assert float((got - want).abs().max()) <= LOGP_TOL


def test_fused_maxpool_is_refused():
    model, _ = _model()
    with pytest.raises(ValueError, match="fused max-pool"):
        model(_cloud(9, 2, 64) * 0.05, fused_maxpool=True)


def _batch(seed, b=4, p=3000, n=256):
    """(grasps, clouds, transforms, labels, weights) as the benchmark's
    train mix makes them: clouds uniform in an 8 cm cube, grasps at the
    cloud's mean plus 5 mm noise, random axis and approach angle, 0.08 m
    wide."""
    rs = np.random.RandomState(seed)
    clouds = ((rs.rand(b, p, 3) - 0.5) * 0.08).astype(np.float32)
    grasps = np.zeros((b, 12), np.float32)
    grasps[:, :3] = clouds.mean(1) + rs.randn(b, 3) * 0.005
    axes = rs.randn(b, 3)
    grasps[:, 3:6] = axes / np.linalg.norm(axes, axis=1, keepdims=True)
    grasps[:, 6] = 0.08
    grasps[:, 7] = rs.uniform(-np.pi, np.pi, b)
    transforms = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    labels = torch.from_numpy(np.array([0, 1] * (b // 2)))
    return (torch.from_numpy(grasps), torch.from_numpy(clouds),
            torch.from_numpy(transforms), labels, torch.ones(b))


def _step(n, seed, compute_dtype=None):
    """One ``make_fused_train_step`` step from seeded weights: (loss, the
    gradients as they stand after the step, the parameters before and after
    it, the program's crop)."""
    batch = _batch(seed, n=n)
    model, params = _model(seed=seed + 1)
    state = train.init_train_state(model.train(),
                                   train.make_optimizer(LR, 30, 0.5, 8))
    step = train.make_fused_train_step(num_points=n,
                                       compute_dtype=compute_dtype)
    _, metrics = step(state, *batch, Draws(seed + 2))
    x, _, valid = collect_grasp_clouds_batched(
        *batch[:3], Draws(seed + 2), num_out=n, min_point_limit=50)
    assert bool(valid.all())
    named = dict(model.named_parameters())
    return (float(metrics["loss"]), {k: p.grad for k, p in named.items()},
            params, {k: p.detach() for k, p in named.items()}, x, batch)


# the biases a train-mode BatchNorm follows (each MLP layer's, fc1's, fc2's)
# and SA3's last BatchNorm shift, which moves every sample's feature alike
# before the head's BatchNorm
CANCELLED = {f"feat.sa{i}.mlp_convs.{j}.bias" for i in (1, 2, 3)
             for j in range(3)} | {"fc1.bias", "fc2.bias",
                                   "feat.sa3.mlp_bns.2.bias"}


def _float64_reference(params, x, batch):
    """(loss, gradients, the leaves compared: those whose gradient is at
    least a thousandth of the median leaf's; the others are the biases
    that a train-mode BatchNorm cancels, 0 in exact arithmetic)."""
    p64 = {k: v.double() for k, v in params.items()}
    x64 = x.double()
    loss, grads = ref.gradients(p64, x64, batch[3], batch[4], CONFIG,
                                ref.sample(x64, CONFIG))
    norms = {k: float(g.norm()) for k, g in grads.items()}
    med = float(torch.tensor(list(norms.values())).median())
    return loss, grads, [k for k, v in norms.items() if v >= 1e-3 * med]


@pytest.mark.parametrize("n,seed", [(256, 10), (256, 30), (1024, 50)])
def test_fused_train_step_equals_the_reference(n, seed):
    """The step computed in float64 (``compute_dtype``) against the
    reference in float64 on the program's own crop: the loss, every
    gradient that does not cancel, and the float32 Adam update."""
    loss, grads, start, after, x, batch = _step(n, seed, torch.float64)
    r_loss, r_grads, kept = _float64_reference(start, x, batch)
    assert abs(loss - r_loss) <= LOSS_RTOL * abs(r_loss)
    assert not set(kept) & CANCELLED and len(kept) >= 30
    for k in kept:
        g = r_grads[k]
        assert float((grads[k].double() - g).abs().max()) <= GRAD_RTOL * \
            float(g.abs().max()), k
    _holds_adam(start, grads, after, kept)


def _holds_adam(start, grads, after, kept):
    """The update is the reference's Adam step on the program's own
    gradients, within two float32 ulps of each parameter (the sides round
    the subtraction apart) and 1e-5 of the learning rate; every ``kept``
    leaf moved."""
    want = {k: v.clone() for k, v in start.items()}
    m = {k: torch.zeros_like(g) for k, g in grads.items()}
    v = {k: torch.zeros_like(g) for k, g in grads.items()}
    ref.adam_step(want, grads, m, v, 1, LR)
    for k, p in after.items():
        tol = 2.4e-7 * want[k].abs() + 1e-5 * LR
        assert bool(((p - want[k]).abs() <= tol).all()), k
        assert k not in kept or not torch.equal(p, start[k]), k


@pytest.mark.parametrize("seed", [10, 70])
def test_the_float32_step_stays_within_its_rounding(seed):
    """The float32 step against the float64 reference: the loss, and each
    kept leaf's gradient norm against max(its norm, the median leaf's), as
    the benchmark's ``grad_gap`` compares them."""
    loss, grads, start, after, x, batch = _step(256, seed)
    r_loss, r_grads, kept = _float64_reference(start, x, batch)
    assert abs(loss - r_loss) <= F32_LOSS_RTOL * abs(r_loss)
    norms = {k: float(r_grads[k].norm()) for k in kept}
    med = float(torch.tensor(list(norms.values())).median())
    worst = max(abs(float(grads[k].norm()) - norms[k]) / max(norms[k], med)
                for k in kept)
    assert worst <= F32_GRAD_GAP
    _holds_adam(start, grads, after, kept)


# ------------------------------------------------------------------ spans

def _ranges(prof):
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.activity_type() == "user_annotation":
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return out


def _traced_step(n=128):
    batch = _batch(13, n=n)
    model, _ = _model()
    state = train.init_train_state(model.train(), train.make_optimizer(LR))
    step = train.make_fused_train_step(num_points=n)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, *batch, Draws(14))
    return _ranges(prof)


def test_a_step_opens_its_spans_under_the_forward():
    got = _traced_step()
    assert len(got["pn2.fps"]) == len(got["pn2.group"]) == 2
    assert "pn2.kernel" not in got           # the CPU takes the plain route
    (a, b), = got["train.forward"]
    assert all(a <= s and e <= b for name in ("pn2.fps", "pn2.group")
               for s, e in got[name])


def test_the_kernel_route_opens_four_kernel_spans(monkeypatch):
    """With K7 taken (its launches stood in for by the plain versions), a
    step opens ``pn2.kernel`` once per sampling and per ball query, inside
    ``pn2.fps`` and ``pn2.group``."""
    calls = []
    monkeypatch.setattr(k7, "takes", lambda points: True)
    monkeypatch.setattr(k7, "fps_kernel", lambda *a: calls.append("f")
                        or k7.fps_plain(*a))
    monkeypatch.setattr(k7, "ball_query_kernel", lambda *a: calls.append(
        "b") or k7.ball_query_plain(*a))
    got = _traced_step()
    assert calls == ["f", "b", "f", "b"]
    assert len(got["pn2.kernel"]) == 4
    outer = got["pn2.fps"] + got["pn2.group"]
    assert all(any(a <= s and e <= b for a, b in outer)
               for s, e in got["pn2.kernel"])


def test_sampling_opens_no_range_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert span("pn2.fps") is span("pn2.group") is span("pn2.kernel")
    model, _ = _model()
    with torch.no_grad():
        assert model(_cloud(15, 2, 128) * 0.05)[0].shape == (2, 2)


# -------------------------------------------------- the trainer, the CLI

def test_the_trainer_builds_the_chosen_model():
    from pointnetgpd_tpu_torch.training.loop import TrainConfig, Trainer

    assert isinstance(Trainer._model(TrainConfig(model="pointnet2_ssg")),
                      tpn2.PointNet2ClsSSG)
    with pytest.raises(ValueError, match="unknown model"):
        Trainer._model(TrainConfig(model="pointnet3"))


def test_cli_trains_the_pointnet2_variant(tmp_path, capsys):
    from pointnetgpd_tpu_torch.cli.train import VARIANTS, main

    var = VARIANTS["1v_pn2"]
    assert (var["grasp_points_num"], var["lr"], var["num_classes"]) == (
        1024, 1e-3, 2)
    common = ["--synthetic", "--device", "cpu", "--batch-size", "4",
              "--cloud-points", "2048", "--steps-per-epoch", "2",
              "--eval-steps", "1", "--model-path", str(tmp_path / "m"),
              "--log-dir", str(tmp_path / "l")]
    assert main(["--variant", "1v_pn2", "--mode", "train", "--epoch", "1",
                 *common]) == 0
    out = capsys.readouterr().out
    assert "Epoch 0: train_acc=" in out
    sd = torch.load(tmp_path / "m" / "step_2" / "model.pt")
    assert sd["feat.sa2.mlp_convs.0.weight"].shape == (128, 131, 1)
    assert sd["fc3.weight"].shape == (2, 256)


# ------------------------------------------------------------ the scorer

def _candidates(pc, g, seed):
    rs = np.random.RandomState(seed)
    centers = pc[rs.randint(0, len(pc), g)] + rs.randn(g, 3) * 0.003
    rot = np.linalg.qr(rs.randn(g, 3, 3))[0]
    return np.concatenate([centers[:, None], rot, centers[:, None]],
                          1).astype(np.float32)


def test_score_candidates_fused_scores_with_pointnet2():
    """The fused scorer's probabilities are the reference's eval-mode
    forward on the crops it scored (the crop, then the resample, from the
    same draws)."""
    n = 128
    pc = _cloud(16, 1, 3000)[0] * 0.05
    cand = torch.from_numpy(_candidates(pc.numpy(), 6, 17))
    valid = torch.ones(6, dtype=torch.bool)
    model, params = _model(seed=18)
    model.eval()
    pred, prob, counts, ok, good, order = tscorer.score_candidates_fused(
        model, pc, cand, valid, 0.06, 0.08, Draws(19), num_points=n,
        min_points=5)
    d = Draws(19)
    clouds, _, cvalid = collect_candidate_clouds(
        cand[:, 0], cand[:, 1], cand[:, 2], cand[:, 3], pc, 0.06, 0.08, d,
        num_out=n, min_point_limit=5)
    idx = d.resample(6, n, clouds.shape[1])
    x = clouds[torch.arange(6)[:, None], idx.long()]
    want = torch.softmax(ref.forward(params, x, CONFIG, ref.sample(x, CONFIG),
                                     train=False), dim=-1)
    assert bool(ok.any()) and torch.equal(ok, cvalid & valid)
    assert float((prob[ok] - want[ok]).abs().max()) <= LOGP_TOL
    assert torch.equal(pred[ok], want[ok].argmax(-1))


def test_grasp_scorer_scores_with_pointnet2():
    model, _ = _model(seed=20)
    pc = (_cloud(21, 1, 2500)[0] * 0.05).numpy()
    cand = _candidates(pc, 5, 22)
    ts = tscorer.GraspScorer(model=model, k=2, num_points=96, pad_to=8,
                             min_points=5, device="cpu")
    out = ts.score_candidates(pc, cand, 0.06, 0.08, seed=3)
    assert out["prob"].shape == (5, 2) and out["pred"].shape == (5,)
    v = out["valid"]
    assert v.any()
    np.testing.assert_allclose(out["prob"][v].sum(-1), 1.0, atol=1e-6)
    ranked = out["score"][out["good_indices"]]
    assert list(ranked) == sorted(ranked, reverse=True)


# ------------------------------------------------------------- the kernel

def test_build_compiles_k7_without_contraction():
    assert _build.SOURCES["pointnet2_sample.cu"] == ["-fmad=false"]
    assert {"pn2_fps_launch", "pn2_ball_query_launch"} <= set(
        _build.SIGNATURES)


@pytest.mark.parametrize("fn", ["fps", "ball"])
def test_k7_refuses_what_it_does_not_take_before_building(monkeypatch, fn):
    def refuse():
        raise AssertionError("built the kernels for a refused input")

    monkeypatch.setattr(_build, "library", refuse)
    xyz = _cloud(23, 2, 50)
    for bad, match in ((xyz.double(), "float32"), (xyz[:, :0], "empty"),
                       (xyz[0], r"\(B, N, 3\)")):
        with pytest.raises(ValueError, match=match):
            if fn == "fps":
                k7.fps_kernel(bad, 8)
            else:
                k7.ball_query_kernel(bad, xyz[:, :4] if bad.dim() == 3
                                     else bad[:4], 0.2, 8)
    if fn == "fps":
        with pytest.raises(ValueError, match="at most"):
            k7.fps_kernel(torch.zeros(1, k7.FPS_MAX_POINTS + 1, 3), 8)
    else:
        with pytest.raises(ValueError, match="centroids"):
            k7.ball_query_kernel(xyz, xyz[:1, :4], 0.2, 8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [1.0, 0.02])
def test_k7_equals_the_plain_version_on_the_card(cuda_device, spread):
    """At the cell's shape (128 crops of 1,024 points at the model's
    scale, SA1 then SA2), and on clouds packed so tightly that many
    distances tie: K7's indices equal the plain version's run on the card,
    one launch each."""
    xyz = _cloud(24, 128, 1024, spread).to(cuda_device)
    xyz[:, 900:] = xyz[:, :124]              # duplicated points
    for npoint, radius, nsample in ((512, 0.2, 32), (128, 0.4, 64)):
        n0 = k7.launches
        got = k7.farthest_point_sample(xyz, npoint)
        assert k7.launches == n0 + 1
        assert torch.equal(got, k7.fps_plain(xyz, npoint))
        centroids = xyz[torch.arange(128, device=cuda_device)[:, None], got]
        ball = k7.ball_query(xyz, centroids, radius, nsample)
        assert k7.launches == n0 + 2
        assert torch.equal(ball, k7.ball_query_plain(xyz, centroids, radius,
                                                     nsample))
        xyz = centroids
    torch.cuda.synchronize()
