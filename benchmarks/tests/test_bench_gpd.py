"""The GPD baseline's cell on the CPU at a small size: a run traced and
untraced reports every metric of the cell and is ``correct`` under the
committed limits; each planted fault of the kind, the TF32 control, and a
fault planted in the program itself fail a limit, and the float64 witness
fails none."""

import pytest
import torch

from benchmarks import calibrate, run

BENCH = run.read_json(run.ROOT / "BENCHMARK.json")
NAME = "pointnetgpd-fullv-gpd.train-fullv-b128"
# above 4,096 points a cloud, so the crop takes the program's interleaved
# route, as the cell's 50,000 do; at lr 1e-3 the CNN learns a pool of 16
# samples by heart within a few steps, and a loss of exactly 0 after the
# window leaves nothing to compare
SMALL = dict(batch=8, cloud_points=5000, num_points=256, pool=2,
             trace_units=2, lr=1e-4)
LIMITS = run.read_json(run.HERE / "limits" / f"{NAME}.json")
TRACED = {"gpd_train.crop_ms", "gpd_train.normals_ms", "gpd_train.project_ms",
          "gpd_train.projections", "mfu.gpd_train", "train.crop_ms",
          "train.fwd_bwd_ms", "train.forward_ms", "train.backward_ms",
          "train.adam_ms", "device_idle.train"}


def _run(trace=False, seed=2 ** 31 + 29):
    return run.run_cell(BENCH, NAME, seed, 0.05, trace, device="cpu",
                        overrides=SMALL)


@pytest.mark.parametrize("trace", [False, True])
def test_gpd_cell_on_the_cpu(trace):
    out = run.run_cell(BENCH, NAME, 2 ** 32 + 3, 0.3, trace, device="cpu",
                       overrides=SMALL)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(LIMITS)
    want = TRACED if trace else {"train_samples_per_s", "setup_s"}
    assert set(out["metrics"]) == want
    if trace:
        assert out["metrics"]["gpd_train.projections"]["value"] == 3.0


def _fails(got):
    return [k for k, v in got.items() if v > LIMITS[k]]


@pytest.mark.parametrize("mode", ["control", "fault:half_batch",
                                  "fault:unflipped",
                                  "fault:swapped_orders"])
def test_the_control_and_each_planted_fault_fail_a_limit(mode):
    got = calibrate.readings(NAME, 2 ** 31 + 41, mode, 0.05, "cpu",
                             SMALL)["numbers"]
    assert _fails(got), got
    if mode in ("fault:unflipped", "fault:swapped_orders"):
        assert "features_gap" in _fails(got)


def test_the_float64_witness_meets_every_limit():
    """The reference in float64 in the program's place rounds otherwise
    than float32 does and is right: no limit may fail it."""
    got = calibrate.readings(NAME, 2 ** 31 + 41, "fault:float64", 0.05,
                             "cpu", SMALL)["numbers"]
    assert not _fails(got), got


def test_an_unknown_fault_is_refused():
    with pytest.raises(ValueError, match="unknown fault"):
        calibrate.readings(NAME, 1, "fault:nothing", 0.0, "cpu", SMALL)


def test_swapped_orders_in_the_program_are_caught(monkeypatch):
    from pointnetgpd_tpu_torch.ops import projection

    a, b, c = projection._ORDERS
    monkeypatch.setattr(projection, "_ORDERS", (a, c, b))
    out = _run()
    assert not out["correct"]
    assert out["checks"]["features_gap"]["value"] > LIMITS["features_gap"]


def test_a_program_step_without_its_update_is_caught(monkeypatch):
    from pointnetgpd_tpu_torch.training import train

    def no_step(state):
        state.step += 1
    monkeypatch.setattr(train, "_adam", no_step)
    out = _run()
    assert not out["correct"]
    assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_gpd_counts_are_the_layer_widths():
    from benchmarks.counts import gpd

    config = run.read_json(run.ROOT / "benchmarks/configs/"
                           "pointnetgpd-fullv-gpd.json")
    assert gpd.forward_flops(config) == 37_632_000 + 28_800_000 + 7_202_000
    assert gpd.train_flops(config) == 3 * 73_634_000


def test_box_clouds_lie_on_the_box_faces():
    from benchmarks.kinds import gpd_train

    t = dict(batch=3, cloud_points=4000, box_side_m=[0.04, 0.06])
    pts = gpd_train.box_clouds(t, 7, 0, "cpu")
    assert pts.shape == (3, 4000, 3)
    # rotation keeps distances: every point lies between
    # the smallest half side and the half diagonal from the centre
    r = pts.norm(dim=-1)
    assert float(r.min()) >= 0.02 - 1e-6
    assert float(r.max()) <= (3 * 0.03 ** 2) ** 0.5 + 1e-6
    assert torch.allclose(pts.mean(dim=1), torch.zeros(3, 3), atol=2e-3)
