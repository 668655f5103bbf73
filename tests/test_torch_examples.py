"""The port's drivers in ``pointnetgpd_tpu_torch/examples/`` against the JAX
package's ``examples/``: their deterministic pieces, and the whole workflow
at its smallest size on the CPU.

Stated tolerances: ``synth_meshes`` writes byte-equal PLY files;
``split_labels`` equal split files and an equal transform pickle;
``_parse_eval_acc``, ``_test_label_hist``, ``_load_yield_summary`` and the
parity driver's ``_test_prior`` and ``_final_quarter`` equal results, and
its ``write_report`` equal tables and summary lines (the lines that name
the device differ). The whole workflow (4 objects, so that
``gt_robustness``'s second scene has one; sdf_dim 24, 2 grasps per class,
1 epoch x 2 steps at batch 4, 2 views of 3,000 points, 8 GPG seeds, the
detect stage's bucket 1024), stopped before its detect stage and then
resumed with ``--resume``: every stage exits 0 and leaves the
reference-layout files, the resumed run does not repeat a recorded stage,
the report's fields are filled, and ``gt_robustness`` runs both arms on
its tree. The
detect stage against JAX's: ``tests/test_torch_examples_detect.py``.
"""

import glob
import json
import os
import pickle

import numpy as np
import pytest
import torch

from examples import integrated_workflow as jwf
from examples import train_parity_experiment as jpar
from pointnetgpd_tpu_torch.examples import gt_robustness as tgt
from pointnetgpd_tpu_torch.examples import integrated_workflow as twf
from pointnetgpd_tpu_torch.examples import train_parity_experiment as tpar


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(root):
    """Files under ``root``, not following the ``data`` symlink."""
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


# --------------------------------------------------------------- the pieces

def test_synth_meshes_byte_equal_jax(tmp_path):
    """Seven objects: every maker of the six, and the wrap to the first."""
    a, b = str(tmp_path / "t"), str(tmp_path / "j")
    assert twf.synth_meshes(a, 7, seed=3) == jwf.synth_meshes(b, 7, seed=3)
    fa, fb = _files(a), _files(b)
    assert fa == fb and len(fa) == 7
    for rel in fa:
        with open(os.path.join(a, rel), "rb") as x, \
                open(os.path.join(b, rel), "rb") as y:
            assert x.read() == y.read(), rel
    assert os.path.islink(os.path.join(a, "data"))


def _rows(rs, n):
    rows = rs.rand(n, 12).astype(np.float32)
    rows[:, 10] = rs.choice([2.0, 1.6, 1.2, 0.8, 0.6, 0.4, 0.2], n)
    return rows


def test_split_labels_equal_jax(tmp_path):
    rs = np.random.RandomState(0)
    out = tmp_path / "gen"
    out.mkdir()
    for i, n in enumerate((9, 14, 1)):
        np.save(out / f"r4_{i:03d}_box_{n}.npy", _rows(rs, n))
    got = twf.split_labels(str(tmp_path / "t"), str(out), seed=2)
    want = jwf.split_labels(str(tmp_path / "j"), str(out), seed=2)
    assert got == want and len(got) == 3
    a, b = str(tmp_path / "t"), str(tmp_path / "j")
    assert _files(a) == _files(b)
    for rel in _files(a):
        if rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(os.path.join(a, rel)),
                                          np.load(os.path.join(b, rel)))
    pa, pb = (pickle.load(open(os.path.join(r, "PointNetGPD/data/"
                                            "google2cloud.pkl"), "rb"))
              for r in (a, b))
    assert pa.keys() == pb.keys()
    for k in pa:
        assert pa[k][0] == pb[k][0]
        np.testing.assert_array_equal(pa[k][1], pb[k][1])


LOG = """
$ pointnetgpd_tpu.pipelines.generate_dataset r4 --data-root R
$ m.cli.train --variant 1v --mode train --tag wf20
Test done, acc=0.5, loss=0.7
$ m.cli.train --variant 1v --mode test --tag wf20
Test done, acc=0.71875, loss=0.6
Test done, acc=nan-ish, loss=0.6
$ m.cli.train --variant 1v_gpd --mode test --tag wf20gpd
Test done, acc=0.625, loss=0.8
$ m.cli.train --variant fullv --mode test
Test done, acc=oops
"""


@pytest.mark.parametrize("variant", [None, "1v", "1v_gpd", "fullv",
                                     "1v_mc"])
def test_parse_eval_acc_equal_jax(tmp_path, variant):
    log = tmp_path / "workflow.log"
    log.write_text(LOG)
    got = twf._parse_eval_acc(str(log), variant=variant)
    assert got == jwf._parse_eval_acc(str(log), variant=variant)
    assert twf._parse_eval_acc(str(tmp_path / "missing.log")) is None
    if variant == "1v":
        assert got == 0.71875


@pytest.mark.parametrize("variant", sorted(jwf.VARIANT_CFG))
def test_test_label_hist_equal_jax(tmp_path, variant):
    assert twf.VARIANT_CFG == jwf.VARIANT_CFG
    rs = np.random.RandomState(1)
    test = tmp_path / "PointNetGPD/data/ycb_grasp/test"
    test.mkdir(parents=True)
    for i, n in enumerate((30, 0, 17)):
        rows = _rows(rs, n)
        rows[:, 11] = rs.rand(n) * 40
        np.save(test / f"{i:03d}_obj.npy", rows)
    vcfg = twf.VARIANT_CFG[variant]
    got = twf._test_label_hist(str(tmp_path), vcfg)
    assert got == jwf._test_label_hist(str(tmp_path), vcfg)
    assert sum(got) > 0


def test_load_yield_summary_equal_jax(tmp_path):
    assert twf._load_yield_summary(str(tmp_path)) is None
    assert jwf._load_yield_summary(str(tmp_path)) is None
    ys = {"grasps_per_class": 2, "n_classes": 7, "objects": [],
          "total_rows": 9}
    (tmp_path / "yield_summary.json").write_text(json.dumps(ys))
    assert (twf._load_yield_summary(str(tmp_path))
            == jwf._load_yield_summary(str(tmp_path)) == ys)


def _curves(rs, epochs, n_ours, n_ref):
    def hist(seed):
        return {"seed": seed, "seconds": float(rs.rand() * 9),
                "test_acc": rs.rand(epochs).tolist(),
                "train_loss": rs.rand(epochs).tolist()}
    return {"meta": {"objects": ["parity_box", "parity_torus_mesh"],
                     "n_train": 11, "n_test": 3, "points_per_view": 500,
                     "num_classes": 2, "thresh_good": 0.6,
                     "thresh_bad": 0.6, "test_prior": 0.6667},
            "epochs": epochs, "batch_size": 8, "lr": 0.005,
            "num_points": 96, "n_seeds": max(n_ours, n_ref),
            "ours": [hist(s) for s in range(n_ours)],
            "reference": [hist(s) for s in range(n_ref)]}


def _numbers(lines):
    """The report's tables and summary lines: every line from the first
    results section on, but the wall-time line (it names the device)."""
    start = next(i for i, ln in enumerate(lines) if ln.startswith("## "))
    return [ln for ln in lines[start:] if not ln.startswith("Wall time")]


@pytest.mark.parametrize("epochs,n_ours,n_ref", [(7, 3, 2), (2, 1, 0),
                                                 (4, 0, 3)])
def test_parity_driver_pieces_equal_jax(tmp_path, epochs, n_ours, n_ref):
    rs = np.random.RandomState(epochs)
    test = tmp_path / "PointNetGPD/data/ycb_grasp/test"
    test.mkdir(parents=True)
    for i, n in enumerate((5, 8)):
        np.save(test / f"o{i}.npy", _rows(rs, n))
    meta = {"objects": ["o0", "o1"]}
    for k, (g, b) in ((2, (0.6, 0.6)), (3, (0.5, 1.2))):
        assert (tpar._test_prior(str(tmp_path), meta, k, g, b)
                == jpar._test_prior(str(tmp_path), meta, k, g, b))
    curves = _curves(rs, epochs, n_ours, n_ref)
    for h in curves["ours"] + curves["reference"]:
        assert tpar._final_quarter(h, epochs) == jpar._final_quarter(
            h, epochs)
    assert tpar.OBJECTS_2CLASS == jpar.OBJECTS_2CLASS
    out = {}
    for name, mod in (("t", tpar), ("j", jpar)):
        md = tmp_path / f"{name}.md"
        mod.write_report(json.loads(json.dumps(curves)), str(md),
                         str(tmp_path / "c.json"))
        out[name] = md.read_text().splitlines()
    assert _numbers(out["t"]) == _numbers(out["j"])
    assert len(_numbers(out["t"])) >= epochs + 5


# ------------------------------------------------------- the whole workflow

WF_ARGS = ["--objects", "4", "--epochs", "1", "--steps-per-epoch", "2",
           "--batch-size", "4", "--grasps-per-class", "2", "--num-seeds",
           "8", "--sdf-dim", "24", "--max-rounds", "2", "--n-views", "2",
           "--max-points", "3000", "--cloud-points", "3000",
           "--cloud-pad-to", "1024", "--device", "cpu"]
OFFLINE = ["0_synth_meshes", "1_prepare_objects_sdf", "2_generate_dataset",
           "3_split_labels", "4_render_clouds", "5_train_1v", "6_eval_1v",
           "7_infer_cli"]


class _Interrupted(Exception):
    """Raised in place of the workflow's detect stage."""


@pytest.fixture(scope="module")
def interrupted(tmp_path_factory):
    """The port's workflow at its smallest size, stopped by an error in its
    last stage (detect): stages 0-7 ran, each in a fresh process on one
    CPU thread. Returns the root and the stage book as the run left it."""
    root = tmp_path_factory.mktemp("wf")

    def stop(*a, **k):
        raise _Interrupted

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setattr(twf, "detect_stage", stop)
        with pytest.raises(_Interrupted):
            twf.main(["--root", str(root / "tree"), "--out-md",
                      str(root / "report.md")] + WF_ARGS)
    return root, json.load(open(root / "tree/stage_times.json"))


@pytest.fixture(scope="module")
def workflow(interrupted):
    """The same run resumed (``--resume``): the detect stage and the
    report."""
    root, _ = interrupted
    md = root / "report.md"
    assert twf.main(["--root", str(root / "tree"), "--out-md", str(md),
                     "--resume"] + WF_ARGS) == 0
    return root / "tree", md


def test_workflow_stops_with_its_stage_book(interrupted):
    root, times = interrupted
    assert list(times) == OFFLINE
    assert not (root / "tree/det.json").exists()
    assert not (root / "report.md").exists()
    log = open(root / "tree/workflow.log").read()
    assert log.count("$ pointnetgpd_tpu_torch.") == 6


def test_workflow_runs_at_smallest_size(interrupted, workflow):
    root, md = workflow
    times = json.load(open(root / "stage_times.json"))
    assert list(times) == OFFLINE + ["8_detect_frame"]
    # resumed: the offline stages did not run again
    assert {k: times[k] for k in OFFLINE} == interrupted[1]
    base = root / "PointNetGPD/data/ycb-tools/models/ycb"
    names = sorted(os.listdir(base))
    assert names == ["000_ellipsoid", "001_box", "002_cylinder", "003_cone"]
    for nm in names:
        g = base / nm / "google_512k"
        for f in ("nontextured.ply", "nontextured.obj", "nontextured.sdf"):
            assert (g / f).stat().st_size > 0, (nm, f)
        assert len(glob.glob(str(base / nm / "rgbd/clouds/pc_NP3_NP5_*"
                                 ".npy"))) == 2
        for split in ("train", "test"):
            assert (root / f"PointNetGPD/data/ycb_grasp/{split}/{nm}.npy"
                    ).exists()
    assert (root / "PointNetGPD/data/google2cloud.pkl").exists()
    assert glob.glob(str(root / "learned_models/step_*/model.pt"))
    ys = json.load(open(root / "generated_grasps/yield_summary.json"))
    assert len(ys["objects"]) == 4 and ys["total_rows"] > 0
    log = open(root / "workflow.log").read()
    assert log.count("$ pointnetgpd_tpu_torch.") == 6
    assert log.count("--device cpu") == 6
    det = json.load(open(root / "det.json"))
    assert det["scene_objects"] and det["scene_points"] > 0
    for preset in twf.PRESETS:
        d = det[preset]
        assert d["funnel"]["frames"] == 8 * 19
        assert d["ground_truth"]["n_candidates"] == d["candidates"]
    text = md.read_text()
    assert "test acc" in text and "majority prior" in text
    assert "## Labeling yield" in text and "## Per-stage wall time (cpu)" \
        in text
    for key in times:
        assert f"| {key} |" in text
    for preset in twf.PRESETS:
        assert f"### Preset `{preset}`" in text
    assert "Total:" in text and "on cpu + host" in text


def test_gt_robustness_both_arms(workflow):
    root, _ = workflow
    out = tgt.main(["--root", str(root), "--num-seeds", "8",
                    "--cloud-pad-to", "1024", "--device", "cpu"])
    same = out["same_scene_new_sampler_seed"]
    det0 = json.load(open(root / "det.json"))
    assert same["seed"] == 7
    assert same["scene_objects"] == det0["scene_objects"]
    assert len(same["scene_objects"]) == 3
    new = out["new_scene"]
    assert new["scene_objects"] and not (set(new["scene_objects"])
                                         & set(det0["scene_objects"]))
    for d in (same, new):
        for preset in twf.PRESETS:
            assert d[preset]["funnel"]["frames"] == 8 * 19
    assert json.load(open(root / "gt_robustness.json")) == json.loads(
        json.dumps(out))
