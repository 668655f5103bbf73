"""The port's one-process drivers: ``end_to_end_demo``,
``train_parity_experiment --skip-reference`` and
``execute_grasp_registration``, at their smallest sizes on the CPU.

- The demo runs as ``tests/test_imports.py`` runs the JAX package's (3
  train steps, a fresh process) and prints the same five stage lines.
- The parity driver builds a two-object dataset (2 grasps per class, 2
  rounds, sdf_dim 28, 2 views of 500 points) and trains the port's path for
  2 epochs: its curves file and report are written in the JAX driver's
  layout.
- The registration driver against the JAX package's on one grid (JAX's SDF
  stored into the port's database, as
  ``tests/test_torch_api.py::test_dexnet_lifecycle_matches_jax`` does),
  JAX's antipodal rounds replayed into the port (``_Replay``) and JAX's
  force-only metric in float64 (``exact_jax_canny``): the stored rows meet
  that test's ``_assert_rows``; on the rows both packages stored (matched
  by configuration) the collision flags are equal and the best
  collision-free grasp is the same, and where all rows are shared the best
  grasp's index is equal. It needs h5py.
"""

import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import jax
import pytest
import torch

from pointnetgpd_tpu_torch.examples import train_parity_experiment as tpar

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_end_to_end_demo_runs():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "pointnetgpd_tpu_torch.examples.end_to_end_demo",
         "--steps", "3", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=900, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    for stage in ("[0/4] device: cpu", "[1/4]", "[2/4]", "[3/4]", "[4/4]",
                  "demo complete"):
        assert any(ln.startswith(stage) for ln in lines), out.stdout
    assert "SDF (48, 48, 48) on cpu" in out.stdout
    assert re.search(r"trained 3 steps: loss [\d.]+ -> [\d.]+", out.stdout)


def test_train_parity_experiment_skip_reference(tmp_path):
    out_json, out_md = tmp_path / "curves.json", tmp_path / "PARITY.md"
    assert tpar.main([
        "--root", str(tmp_path / "data"), "--skip-reference",
        "--objects", "parity_box", "parity_torus_mesh",
        "--grasps-per-class", "2", "--max-rounds", "2", "--epochs", "2",
        "--seeds", "1", "--batch-size", "8", "--num-points", "96",
        "--sdf-dim", "28", "--sdf-res", "0.0049", "--views-per-object", "2",
        "--points-per-view", "500", "--device", "cpu", "--out-json",
        str(out_json), "--out-md", str(out_md)]) == 0
    curves = json.load(open(out_json))
    meta = curves["meta"]
    assert meta["objects"] == ["parity_box", "parity_torus_mesh"]
    assert meta["n_train"] > 0 and meta["n_test"] > 0
    assert meta["views_per_object"] == 2 and meta["device"] == "cpu"
    assert 0 < meta["test_prior"] <= 1
    assert curves["reference"] == [] and len(curves["ours"]) == 1
    ours = curves["ours"][0]
    assert ours["seed"] == 0 and len(ours["test_acc"]) == 2
    assert np.isfinite(ours["train_loss"]).all()
    text = out_md.read_text()
    assert "## Final-quarter mean test accuracy (per seed)" in text
    assert "| 0 | - | " in text and "2 views/object" in text
    assert json.load(open(tmp_path / "data" / "parity_meta.json"))[
        "n_train"] == meta["n_train"]


def test_registration_matches_jax(tmp_path, monkeypatch, capsys):
    pytest.importorskip("h5py")
    from examples import execute_grasp_registration as jreg
    from pointnetgpd_tpu import api as japi
    from pointnetgpd_tpu.grasping import collision_checker as jcc
    from pointnetgpd_tpu.pipelines import generate_dataset as jgen
    from pointnetgpd_tpu_torch import api as tapi
    from pointnetgpd_tpu_torch.examples import execute_grasp_registration \
        as treg
    from pointnetgpd_tpu_torch.geometry import sdf as tsdf
    from pointnetgpd_tpu_torch.pipelines import generate_dataset as tgen

    from test_torch_api import _Replay
    from test_torch_labeling import exact_jax_canny
    from test_torch_labeling_samplers import LabelJaxDraws, _assert_rows

    seen = {}
    sim = japi.DexNet.compute_simulation_data

    def jax_sim(self, key, *a, **k):
        seen["sdf"] = self.dataset.sdf(key)
        return sim(self, key, *a, **k)

    get = japi.DexNet.get_grasps

    def jax_get(self, key, *a, **k):
        seen["grasps"] = get(self, key, *a, **k)
        return seen["grasps"]

    collide = jcc.GraspCollisionChecker.grasps_in_collision

    def jax_collide(self, frames):
        seen["collides"] = np.asarray(collide(self, frames))
        return seen["collides"]

    monkeypatch.setattr(japi.DexNet, "compute_simulation_data", jax_sim)
    monkeypatch.setattr(japi.DexNet, "get_grasps", jax_get)
    monkeypatch.setattr(jcc.GraspCollisionChecker, "grasps_in_collision",
                        jax_collide)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rp = _Replay(monkeypatch, (jgen, tgen))
    with jax.enable_x64(False), exact_jax_canny():
        jreg.main()
    best_j = int(re.search(r"best collision-free grasp #(\d+)",
                           capsys.readouterr().out).group(1))
    assert rp.rounds

    # the port labels on JAX's grid, with JAX's rounds
    jsd = seen["sdf"]
    t_sim = tapi.DexNet.compute_simulation_data

    def port_sim(self, key, *a, **k):
        self.dataset.store_sdf(key, tsdf.make_sdf(
            np.asarray(jsd.data), np.asarray(jsd.origin),
            float(jsd.resolution), device="cpu"), force_overwrite=True)
        return t_sim(self, key, *a, **k)

    monkeypatch.setattr(tapi.DexNet, "compute_simulation_data", port_sim)
    (tmp_path / "t").mkdir()
    with jax.enable_x64(False):
        got = treg.run(str(tmp_path / "t"), device="cpu",
                       draws=LabelJaxDraws(jax.random.PRNGKey(0)))
    assert not rp.rounds

    configs, metrics = seen["grasps"]

    def rows(c, m):
        return np.concatenate([c, m["friction"][:, None],
                               m["robust_ferrari_canny"][:, None]], 1)

    want = rows(configs, metrics)
    have = rows(got["configs"], got["metrics"])
    assert len(want) > 0
    _assert_rows(have, want, jsd)
    # the rows both stored (by configuration; a grasp whose contacts
    # coincide may fill a class in one package only, ROADMAP Queue C item
    # 7, which _assert_rows bounds): equal collision flags, and the same
    # best collision-free grasp among them
    where_j = {tuple(r[:10]): j for j, r in enumerate(want)}
    pairs = [(i, where_j[tuple(r[:10])]) for i, r in enumerate(have)
             if tuple(r[:10]) in where_j]
    assert len(pairs) >= len(want) - 2
    ti, ji = (np.array(ix) for ix in zip(*pairs))
    np.testing.assert_array_equal(got["collides"][ti], seen["collides"][ji])

    def best(rows_, collides, ix):
        return ix[np.argsort(-rows_[ix, 11] * ~collides[ix])[0]]

    assert where_j[tuple(have[best(have, got["collides"], ti), :10])] \
        == best(want, seen["collides"], ji)
    if len(pairs) == len(want) == len(have):
        assert got["best"] == best_j
    assert not got["collides"][got["best"]]
