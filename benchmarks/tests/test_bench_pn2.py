"""The PointNet++ train cell on the CPU at a small size: a run traced and
untraced reports the cell's metrics and is ``correct`` under the committed
limits; the TF32 control and each planted fault fail a limit, sampling
faults ``sample_mismatch`` among them, also where planted in the program;
the float64 witness fails none; the parent of this cell, which lacks the
program's PointNet++, fails at construction; the counts, worked out by
hand."""

import ast
import sys
from pathlib import Path

import pytest
import torch

from benchmarks import calibrate, run
from benchmarks.counts import peaks
from benchmarks.counts import pointnet2 as counts

BENCH = run.read_json(run.ROOT / "BENCHMARK.json")
NAME = "pointnet2-ssg-1v-2class.train-ssg-b128"
CONFIG = run.read_json(run.ROOT / "benchmarks" / "configs"
                       / "pointnet2-ssg-1v-2class.json")
# 1,024 points a crop as in the cell, so that every level samples as it
# does there; 4,000-point clouds keep the crops full; 16 samples, since the
# head's BatchNorms normalize over the batch: over 4 the float32 losses of
# the program and of the reference part by up to 1e-5 (float64 witness:
# 4e-6), over 16 by 1.4e-6 at most (six seeds on the CPU)
SMALL = dict(batch=16, cloud_points=4000, pool=2, trace_units=2)
LIMITS = run.read_json(run.HERE / "limits" / f"{NAME}.json")
# on the CPU the sampling takes its plain route (no ``pn2.kernel``), the
# crop its plain one (no ``crop.kernel``) and no kernel of K7 runs
TRACED = {"train.fwd_bwd_ms", "train.crop_ms", "device_idle.train",
          "train.forward_ms", "train.backward_ms", "train.adam_ms",
          "pn2_train.fps_ms", "pn2_train.group_ms", "mfu.pn2_train"}
SEED = 2 ** 31 + 43


def _run(trace=False, seed=SEED):
    return run.run_cell(BENCH, NAME, seed, 0.05, trace, device="cpu",
                        overrides=SMALL)


@pytest.mark.parametrize("trace", [False, True])
def test_pn2_cell_on_the_cpu(trace):
    out = run.run_cell(BENCH, NAME, 2 ** 32 + 7, 0.3, trace, device="cpu",
                       overrides=SMALL)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(LIMITS)
    want = TRACED if trace else {"train_samples_per_s", "setup_s"}
    assert set(out["metrics"]) == want


def _kernel_stand_ins(monkeypatch):
    """K7's route taken, its launches stood in for by the plain versions
    (the CPU has no kernel)."""
    from pointnetgpd_tpu_torch.ops import pointnet2_sample as k7

    monkeypatch.setattr(k7, "takes", lambda points: True)
    monkeypatch.setattr(k7, "fps_kernel", k7.fps_plain)
    monkeypatch.setattr(k7, "ball_query_kernel", k7.ball_query_plain)


def test_a_traced_run_counts_four_sampling_kernels_a_step(monkeypatch):
    _kernel_stand_ins(monkeypatch)
    out = _run(trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["pn2_train.sample_kernels"]["value"] == 4.0


def _fails(got):
    return [k for k, v in got.items() if v > LIMITS[k]]


@pytest.mark.parametrize("mode", ["control", "fault:fps_random_start",
                                  "fault:pad_zero"])
def test_the_control_and_each_planted_fault_fail_a_limit(mode):
    got = calibrate.readings(NAME, 2 ** 31 + 41, mode, 0.05, "cpu",
                             SMALL)["numbers"]
    assert _fails(got), got
    if mode.startswith("fault:"):
        assert got["sample_mismatch"] > 0
    else:
        assert got["sample_mismatch"] == 0     # TF32 moves no index


def test_the_float64_witness_meets_every_limit():
    """The reference in float64 in the program's place rounds otherwise
    than float32 does and is right: no limit may fail it."""
    got = calibrate.readings(NAME, 2 ** 31 + 41, "fault:float64", 0.05,
                             "cpu", SMALL)["numbers"]
    assert not _fails(got), got


def test_an_unknown_fault_is_refused():
    with pytest.raises(ValueError, match="unknown fault"):
        calibrate.readings(NAME, 1, "fault:nothing", 0.0, "cpu", SMALL)


def _random_start(fn):
    """FPS started at a random index r, not 0: the sampling of the cloud
    rolled by r, its indices rolled back."""
    def wrapped(xyz, npoint):
        n = xyz.shape[1]
        r = int(torch.randint(1, n, ()))
        return (fn(torch.roll(xyz, -r, dims=1), npoint) + r) % n
    return wrapped


def _pad_zero(fn):
    """A ball query that pads its free slots with index 0 (the slots after
    the first that repeat the first index found)."""
    def wrapped(xyz, centroids, radius, nsample):
        idx = fn(xyz, centroids, radius, nsample)
        first = idx[..., :1]
        pad = (idx == first) & (torch.arange(nsample) > 0)
        return torch.where(pad, 0, idx)
    return wrapped


@pytest.mark.parametrize("plant", ["fps", "ball"])
def test_sampling_faults_in_the_program_are_caught(monkeypatch, plant):
    from pointnetgpd_tpu_torch.ops import pointnet2_sample as k7

    if plant == "fps":
        monkeypatch.setattr(k7, "fps_plain", _random_start(k7.fps_plain))
    else:
        monkeypatch.setattr(k7, "ball_query_plain",
                            _pad_zero(k7.ball_query_plain))
    out = _run()
    assert not out["correct"]
    assert out["checks"]["sample_mismatch"]["value"] > 0


def test_the_parent_fails_at_construction(monkeypatch):
    """A program without ``models/pointnet2.py`` (the parent of this cell)
    cannot build the cell: set-up raises before any step."""
    monkeypatch.setitem(sys.modules, "pointnetgpd_tpu_torch.models.pointnet2",
                        None)
    with pytest.raises(ImportError):
        run.make_cell(BENCH, NAME, 1, torch.device("cpu"), SMALL)


def test_the_reference_imports_nothing_but_torch():
    path = run.HERE / "reference" / "pointnet2.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            assert all(a.name.split(".")[0] == "torch" for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            assert node.module.split(".")[0] in ("torch", "__future__")


def test_counts_by_hand():
    """One sample's forward at the published widths, 2 per multiply-add:
    SA1 512 x 32 rows through 3-64-64-128, SA2 128 x 64 rows through
    131-128-128-256, SA3 128 rows through 259-256-512-1024, the head
    1024-512-256-2."""
    sa1 = 2 * 512 * 32 * (3 * 64 + 64 * 64 + 64 * 128)
    sa2 = 2 * 128 * 64 * (131 * 128 + 128 * 128 + 128 * 256)
    sa3 = 2 * 128 * (259 * 256 + 256 * 512 + 512 * 1024)
    head = 2 * (1024 * 512 + 512 * 256 + 256 * 2)
    assert (sa1, sa2, sa3, head) == (408_944_640, 1_080_033_280,
                                     184_745_984, 1_311_744)
    assert counts.forward_flops(CONFIG) == sa1 + sa2 + sa3 + head \
        == 1_675_035_648
    assert abs(counts.forward_flops(CONFIG) / 1.674e9 - 1) < 1e-3
    assert counts.train_flops(CONFIG) == 3 * 1_675_035_648


def test_k7_bound_by_hand():
    """FPS: 511 and 127 passes of 9 instructions over 1,024 and 512 points
    at half the float32 peak; the ball queries' bytes: the clouds and the
    centroids read, 32 and 64 int64 indices a centroid written."""
    b = 128
    fps = b * (511 * 1024 + 127 * 512) * 9 / (peaks.FP32_FLOPS / 2)
    nbytes = (b * 1024 * 12 + b * 512 * 12 + b * 512 * 32 * 8
              + b * 512 * 12 + b * 128 * 12 + b * 128 * 64 * 8)
    want = fps + nbytes / peaks.HBM_BYTES_PER_S
    assert counts.k7_bound_s(CONFIG, b) == pytest.approx(want, rel=1e-12)
    assert 2.8e-5 < want < 2.9e-5


def test_the_configuration_keeps_the_published_widths():
    assert [sa["mlp"] for sa in CONFIG["sa"]] == [
        [64, 64, 128], [128, 128, 256], [256, 512, 1024]]
    assert [(sa["npoint"], sa["radius"], sa["nsample"])
            for sa in CONFIG["sa"]] == [(512, 0.2, 32), (128, 0.4, 64),
                                        (None, None, None)]
    assert CONFIG["fc"] == [512, 256] and CONFIG["num_points"] == 1024
    assert CONFIG["reduced"] == [] and CONFIG["dtype"] == "float32"
    # the reciprocal of the crop box's half-diagonal at w = 0.08 m
    w = 0.08
    assert CONFIG["xyz_scale"] == pytest.approx(
        1 / ((w / 4) ** 2 + (w / 2) ** 2 + (w / 4) ** 2) ** 0.5, rel=1e-15)
    assert Path(run.ROOT / BENCH["configs"][-1]["file"]).is_file()
