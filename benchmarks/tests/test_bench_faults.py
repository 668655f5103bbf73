"""Each cell's comparison sees its faults: the rest of a run is driven on
the CPU at a small size with the timed path broken underneath, and
``correct`` has to come out false. The limits are the committed ones."""

import pytest
import torch

from benchmarks import faults, run

BENCH = run.read_json(run.ROOT / "BENCHMARK.json")
SCORE = ("pointnetgpd-1v-3class.score-batch",
         dict(scene_points=5000, candidates=32, num_points=64, scenes=2,
              check_units=2))
TRAIN = ("pointnetgpd-1v-2class.train-b128",
         dict(batch=8, cloud_points=5000, num_points=64, pool=3))
FRAME = ("pointnetgpd-1v-3class.frame-tabletop",
         dict(face_points=500, scenes=1, check_units=1))


def _run(cell, seed=2 ** 31 + 101):
    name, small = cell
    return run.run_cell(BENCH, name, seed, 0.05, False, device="cpu",
                        overrides=small)


def _altered(fn):
    """An answer altered where it is produced: candidate 0's
    probabilities moved by 0.01."""
    def wrapped(*a, **kw):
        pred, prob, *rest = fn(*a, **kw)
        prob = prob.clone()
        prob[0] += torch.tensor([-0.01, 0.0, 0.01])
        return (pred, prob, *rest)
    return wrapped


def _half_batch(fn):
    """Half of the batch left out: the second half of the real candidates
    is never scored."""
    def wrapped(model, pc, cands, valid_in, *a, **kw):
        half = torch.cumsum(valid_in.long(), 0) <= valid_in.sum() // 2
        return fn(model, pc, cands, valid_in & half, *a, **kw)
    return wrapped


def test_score_sound_run_is_correct():
    assert _run(SCORE)["correct"]


@pytest.mark.parametrize("fault", [_altered, _half_batch,
                                   faults.reversed_ranking_of])
def test_score_faults_are_caught(monkeypatch, fault):
    from pointnetgpd_tpu_torch.inference import scorer

    monkeypatch.setattr(scorer, "score_candidates_fused",
                        fault(scorer.score_candidates_fused))
    assert not _run(SCORE)["correct"]


def test_train_sound_run_is_correct():
    assert _run(TRAIN)["correct"]


def test_train_unchanged_state_is_caught(monkeypatch):
    from pointnetgpd_tpu_torch.training import train

    def no_step(state):
        state.step += 1
    monkeypatch.setattr(train, "_adam", no_step)
    out = _run(TRAIN)
    assert not out["correct"]
    assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_train_fault_in_the_window_alone_is_caught(monkeypatch):
    """A step that goes wrong only after its first calls (as a step
    captured or switched after a few warm steps would) is caught by the
    step after the window."""
    from pointnetgpd_tpu_torch.training import train

    fn = train.masked_nll_loss
    calls = []

    def later_half(log_probs, labels, weights, group=None):
        calls.append(1)
        if len(calls) > 3:
            keep = torch.arange(weights.shape[0]) < weights.shape[0] // 2
            weights = weights * keep
        return fn(log_probs, labels, weights, group)
    monkeypatch.setattr(train, "masked_nll_loss", later_half)
    out = _run(TRAIN)
    assert not out["correct"]
    for name in ("loss_gap", "grad_gap"):
        assert out["checks"][name]["value"] <= out["checks"][name]["limit"]
    assert (out["checks"]["after_loss_gap"]["value"]
            > out["checks"]["after_loss_gap"]["limit"])


def test_train_half_batch_is_caught(monkeypatch):
    from pointnetgpd_tpu_torch.training import train

    fn = train.masked_nll_loss

    def half(log_probs, labels, weights, group=None):
        keep = torch.arange(weights.shape[0]) < weights.shape[0] // 2
        return fn(log_probs, labels, weights * keep, group)
    monkeypatch.setattr(train, "masked_nll_loss", half)
    assert not _run(TRAIN)["correct"]


def test_frame_sound_run_is_correct():
    out = _run(FRAME)
    assert out["correct"], out["checks"]


def test_frame_half_sampler_is_caught():
    undo = faults.half_sampler()
    try:
        out = _run(FRAME)
    finally:
        undo()
    assert not out["correct"]
    assert out["checks"]["sampler_count_gap"]["value"] > \
        out["checks"]["sampler_count_gap"]["limit"]


def test_frame_altered_candidates_are_caught(monkeypatch):
    from pointnetgpd_tpu_torch.robot import node

    fn = node.gpg_sample_candidates

    def reversed_approach(*a, **kw):
        # each hand turned to approach from below the table
        cand = fn(*a, **kw)
        frames = cand.frames.clone()
        frames[:, 1] = -frames[:, 1]
        frames[:, 3] = -frames[:, 3]
        return cand._replace(frames=frames)
    monkeypatch.setattr(node, "gpg_sample_candidates", reversed_approach)
    out = _run(FRAME)
    assert not out["correct"]
    assert out["checks"]["rule_violations"]["value"] > 0


@pytest.mark.parametrize("fault", [_altered, _half_batch,
                                   faults.reversed_ranking_of])
def test_frame_scorer_faults_are_caught(monkeypatch, fault):
    from pointnetgpd_tpu_torch.inference import scorer

    monkeypatch.setattr(scorer, "score_candidates_fused",
                        fault(scorer.score_candidates_fused))
    assert not _run(FRAME)["correct"]


@pytest.mark.parametrize("cell", [SCORE, TRAIN, FRAME],
                         ids=["score", "train", "frame"])
def test_the_control_is_not_correct(cell):
    """The reference with the PointNet's products in TF32 (inputs and crop
    in float32) in the program's place fails a number."""
    from benchmarks import calibrate

    name, small = cell
    got = calibrate.readings(name, 2 ** 31 + 7, "control", 0.05, "cpu",
                             small)["numbers"]
    limits = run.read_json(run.HERE / "limits" / f"{name}.json")
    assert any(got[k] > limits[k] for k in got), got
