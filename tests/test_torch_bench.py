"""The port's benchmark program (``pointnetgpd_tpu_torch/bench.py``) on the
CPU: its emit contract (exactly one JSON line on normal exit, on an
exception, on SIGTERM and at its deadline; the backend probe's budget
bounded; staged families published after a late failure), its sizes against
the JAX bench's, a whole run at a tiny size, the error line where no GPU
answers, and its headline scene and the voxelizer's dense route against the
JAX package.
"""

import functools
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnetgpd_tpu.inference import scorer as jscorer
from pointnetgpd_tpu.models.pointnet import init_pointnet_cls
from pointnetgpd_tpu_torch.models.convert import (pointnet_cls_from_state_dict,
                                                  state_dict_from_jax)
from pointnetgpd_tpu_torch.ops import point_triangle as k3
from test_torch_slice import JaxDraws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_BENCH = os.path.join(REPO, "pointnetgpd_tpu_torch", "bench.py")
jm = importlib.import_module("pointnetgpd_tpu.ops.mesh_to_sdf")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU; torch's thread pool in each worker
    oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_bench():
    """A fresh copy of the port's bench: its staged RESULT starts empty."""
    return _load(PORT_BENCH, "port_bench_under_test")


def _line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


# ------------------------------------------------------------ emit contract

@pytest.mark.parametrize("value,error,want", [
    (123.0, None, {"value": 123.0}),
    (None, "backend unavailable", {"value": None,
                                   "error": "backend unavailable"}),
    (7.0, "train bench died", {"value": 7.0, "partial": "train bench died"}),
])
def test_emit_once_prints_exactly_one_line(capsys, value, error, want):
    bench = _load_bench()
    bench.RESULT["value"] = value
    bench._emit_once(error=error)
    bench._emit_once(error="second call must be ignored")
    parsed = _line(capsys)
    assert parsed["value"] == want["value"]
    assert parsed.get("error") == want.get("error")
    assert parsed["extras"].get("partial") == want.get("partial")
    assert parsed["metric"] == "grasp_candidates_scored_per_sec_750pt"


@pytest.mark.parametrize("late", [False, True])
def test_main_emits_one_line_when_families_fail(capsys, monkeypatch, late):
    bench = _load_bench()
    if late:
        monkeypatch.setattr(bench, "bench_reference_torch",
                            lambda: 86.0)
    else:
        monkeypatch.setattr(bench, "bench_reference_torch", lambda: (
            _ for _ in ()).throw(RuntimeError("no ref")))

    def fake_device(baseline, device):
        if late:
            bench.RESULT["value"] = 46000.0
            bench.RESULT["vs_baseline"] = 46000.0 / baseline
            raise RuntimeError("train family crashed")
        raise RuntimeError("card down")

    monkeypatch.setattr(bench, "bench_device", fake_device)
    bench.main([])
    parsed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert parsed["metric"] == "grasp_candidates_scored_per_sec_750pt"
    if late:
        assert parsed["value"] == 46000.0
        assert parsed["vs_baseline"] == 46000.0 / 86.0
        assert parsed["extras"][
            "reference_torch_cpu_candidates_per_sec"] == 86.0
        assert "train family crashed" in parsed["extras"]["partial"]
        assert "error" not in parsed
    else:
        assert parsed["value"] is None
        assert "card down" in parsed["error"]
        assert "no ref" in parsed["extras"]["family_errors"][
            "reference_baseline"]


def test_backend_probe_budget_is_bounded(monkeypatch):
    bench = _load_bench()
    sleeps = []
    monkeypatch.setattr(bench.time, "sleep", lambda s: sleeps.append(s))
    probes = []

    class _FakeCompleted:
        stdout = ""  # the probe printed no BACKEND= line

    def fake_run(cmd, **kw):
        probes.append(kw.get("timeout"))
        return _FakeCompleted()

    monkeypatch.setattr("subprocess.run", fake_run)
    with pytest.raises(RuntimeError, match="never initialized"):
        bench._wait_for_backend()
    # worst case: 3 probes x 60 s + 2 sleeps x 30 s = 240 s <= 4 min
    assert len(probes) == 3
    assert all(t <= 90 for t in probes)
    assert sum(sleeps) + sum(probes) <= 300


@pytest.mark.parametrize("how", ["sigterm", "deadline"])
def test_guards_emit_staged_json(how):
    """An external ``timeout`` sends SIGTERM first; the watchdog fires
    before an external kill budget. Either publishes the staged line."""
    trigger = ("os.kill(os.getpid(), signal.SIGTERM)\n" if how == "sigterm"
               else "")
    code = (
        "import importlib.util, os, signal, sys, time\n"
        f"spec = importlib.util.spec_from_file_location('b', {PORT_BENCH!r})\n"
        "b = importlib.util.module_from_spec(spec); spec.loader.exec_module(b)\n"
        f"b._install_emit_guards({600 if how == 'sigterm' else 2})\n"
        "b.RESULT['value'] = 42.0\n"
        + trigger +
        "time.sleep(30)\n"  # never reached
    )
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=90)
    assert time.time() - t0 < 30
    parsed = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(proc.stdout.strip().splitlines()) == 1
    assert parsed["value"] == 42.0
    assert ("signal" if how == "sigterm" else "watchdog") in parsed[
        "extras"]["partial"]
    assert proc.returncode == 0


# ------------------------------------------------------------------ sizes

def test_defaults_equal_the_jax_bench():
    jbench = _load(os.path.join(REPO, "bench.py"), "jax_bench_defaults")
    bench = _load_bench()
    for name in ("NUM_POINTS", "N_CANDIDATES", "SCENE_POINTS",
                 "BASELINE_THREADS", "BASELINE_REPEATS"):
        assert getattr(bench, name) == getattr(jbench, name), name
    # the families' keyword defaults are those constants
    kw = bench.bench_device.__kwdefaults__
    assert (kw["num_points"], kw["n_candidates"], kw["scene_points"]) == (
        jbench.NUM_POINTS, jbench.N_CANDIDATES, jbench.SCENE_POINTS)


def test_scenes_are_the_jax_bench_scenes():
    """The headline scene and the UV sphere, as bench.py builds them
    (bench.py:217-225 and :358-372), written out."""
    bench = _load_bench()
    rs = np.random.RandomState(0)
    pc = (rs.rand(20000, 3) * [0.08, 0.06, 0.05]).astype(np.float32)
    centers = (rs.rand(512, 3) * [0.08, 0.06, 0.05]).astype(np.float32)
    centers[:, 0] -= 0.03
    cands = np.zeros((512, 5, 3), np.float32)
    cands[:, 0] = centers
    cands[:, 1] = [1, 0, 0]
    cands[:, 2] = [0, 1, 0]
    cands[:, 3] = [0, 0, 1]
    got_pc, got_cands = bench.headline_scene()
    np.testing.assert_array_equal(got_pc, pc)
    np.testing.assert_array_equal(got_cands, cands)

    nu, nv, r = 64, 64, 0.05
    th = np.linspace(0.0, np.pi, nv + 1)
    ph = np.linspace(0.0, 2 * np.pi, nu, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    verts = np.stack([r * np.sin(tt) * np.cos(pp),
                      r * np.sin(tt) * np.sin(pp),
                      r * np.cos(tt)], axis=-1).reshape(-1, 3)

    def idx(i, j):
        return i * nu + (j % nu)

    tris = []
    for i in range(nv):
        for j in range(nu):
            tris.append([idx(i, j), idx(i + 1, j), idx(i, j + 1)])
            tris.append([idx(i, j + 1), idx(i + 1, j), idx(i + 1, j + 1)])
    tri_v = verts[np.asarray(tris)].astype(np.float32)
    np.testing.assert_array_equal(bench.uv_sphere(nu, nv, r), tri_v)
    origin, res = bench.voxel_grid(100, r)
    assert res == 2.2 * r / 89
    np.testing.assert_array_equal(origin, -res * 99 / 2 * np.ones(3))


# --------------------------------------------------------- whole programs

TINY = dict(
    device=dict(num_points=32, n_candidates=16, scene_points=1500,
                anchor_n=64, train_batch=4, label_attempts=16,
                label_sphere=(24, 0.005, 0.045), reps=1),
    frame=dict(face_points=150, cloud_pad_to=1024, num_points=32, n_it=1),
)
# keys of BENCH_r05.json's line that a CPU run of the port does not have:
# the reference baseline's (no checkout), the voxelizer's (GPU only, as the
# JAX package's is TPU only) and the pinned TPU-host anchor (dropped)
NOT_ON_THE_CPU = {"baseline_host_load_1min", "baseline_method",
                  "reference_torch_cpu_candidates_per_sec",
                  "voxelizer_pallas_ms_100cube_8192tri",
                  "voxelizer_pallas_speedup_vs_xla",
                  "vs_canonical_r4_baseline"}


def test_tiny_cpu_run_prints_one_complete_line(capsys, monkeypatch):
    monkeypatch.setenv("BENCH_ALLOW_CPU", "1")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")    # the probe finds none
    monkeypatch.delenv("POINTNETGPD_REFERENCE", raising=False)
    bench = _load_bench()
    monkeypatch.setattr(bench, "bench_device", functools.partial(
        bench.bench_device, **TINY["device"]))
    monkeypatch.setattr(bench, "bench_frame_pipeline", functools.partial(
        bench.bench_frame_pipeline, **TINY["frame"]))
    threads = torch.get_num_threads()
    bench.main([])
    assert torch.get_num_threads() == threads
    parsed = _line(capsys)
    assert "error" not in parsed and "partial" not in parsed["extras"]
    assert parsed["value"] > 0 and np.isfinite(parsed["value"])
    ex = parsed["extras"]
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        r05 = json.load(f)["parsed"]["extras"]
    missing = set(r05) - set(ex)
    assert missing == NOT_ON_THE_CPU, missing
    assert "vs_canonical_r4_baseline" not in ex
    assert ex["timing"] != r05["timing"]
    assert ex["backend"] == "cpu" and "CPU" in ex["device"]
    for key in set(r05) - NOT_ON_THE_CPU - {"timing", "backend"}:
        assert np.isfinite(ex[key]) and ex[key] > 0, key
    # a CPU tensor takes each kernel's plain version: nothing launches
    assert ex["launches"] == {"gpg_counts": 0, "pointnet_trunk": 0,
                              "pointnet_trunk_512": 0, "point_triangle": 0}
    assert ex["k2_launches_per_scene"] == 0
    assert set(ex["rep_ms"]) == {"matmul_anchor", "scene", "scene_bf16",
                                 "train_fp32", "train_bf16", "label_3d",
                                 "label_6d", "frame"}
    assert bench.bench_voxelizer_extra(torch.device("cpu")) is None


def test_no_gpu_and_no_cpu_flag_prints_the_error_line():
    """Without a GPU and without BENCH_ALLOW_CPU the run emits the error
    line, having imported neither JAX nor the JAX package."""
    code = (
        "import json, sys, time\n"
        "sys.modules['jax'] = None\n"          # any import of jax fails
        "time.sleep = lambda s: None\n"
        "from pointnetgpd_tpu_torch import bench\n"
        "bench.main([])\n"
        "assert not [m for m in sys.modules if m == 'pointnetgpd_tpu' or "
        "m.startswith('pointnetgpd_tpu.')]\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("BENCH_ALLOW_CPU", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=240, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    parsed = json.loads(lines[0])
    assert parsed["value"] is None
    assert "never initialized" in parsed["error"]
    assert "BENCH_ALLOW_CPU" in parsed["error"]


def test_reference_baseline_restores_the_thread_count(tmp_path, monkeypatch):
    """The baseline pins its torch threads and puts the count back, so the
    families after it run on the port's own count."""
    pkg = tmp_path / "PointNetGPD" / "model"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "pointnet.py").write_text(   # the reference's (B, C, N) layout
        "from pointnetgpd_tpu_torch.models import pointnet\n"
        "class PointNetCls(pointnet.PointNetCls):\n"
        "    def forward(self, x):\n"
        "        return super().forward(x.transpose(1, 2).contiguous())\n")
    monkeypatch.setenv("POINTNETGPD_REFERENCE", str(tmp_path))
    monkeypatch.setattr(sys, "path", list(sys.path))
    bench = _load_bench()
    threads = torch.get_num_threads()
    try:
        rate = bench.bench_reference_torch(num_points=32, n_candidates=4,
                                           scene_points=1500)
    finally:
        for name in ("model", "model.pointnet"):
            sys.modules.pop(name, None)
    assert torch.get_num_threads() == threads
    assert rate > 0 and np.isfinite(rate)
    assert bench.RESULT["extras"]["baseline_method"] == (
        "median-of-3, 8 torch threads")


# ------------------------------------------------------- parity with JAX

def test_headline_scene_matches_jax():
    """The headline family's scene through JAX ``score_candidates_fused``
    and through the port's, with the weights carried across and JAX's
    draws replayed."""
    bench = _load_bench()
    pc, cands = bench.headline_scene(scene_points=3000, n_candidates=48)
    num_points = 64
    params, state = jax.device_get(init_pointnet_cls(
        jax.random.PRNGKey(0), input_chann=3, k=3))
    model = pointnet_cls_from_state_dict(state_dict_from_jax(params, state),
                                         device="cpu")
    valid = np.ones(48, bool)
    for seed in (0, 1):
        out_j = jscorer.score_candidates_fused(
            params, state, jnp.asarray(pc), jnp.asarray(cands),
            jnp.asarray(valid), jnp.float32(0.06), jnp.float32(0.08),
            jax.random.PRNGKey(seed), num_points=num_points, repeat=1,
            min_points=10)
        out_t = bench.score_scene(
            model, torch.from_numpy(pc), torch.from_numpy(cands),
            torch.from_numpy(valid), JaxDraws.for_scorer(seed),
            num_points=num_points)
        pred_j, prob_j, cnt_j, val_j, good_j, order_j = map(np.asarray, out_j)
        pred_t, prob_t, cnt_t, val_t, good_t, order_t = (
            o.numpy() for o in out_t)
        assert val_j.sum() > 0
        np.testing.assert_array_equal(cnt_t, cnt_j)
        np.testing.assert_array_equal(val_t, val_j)
        np.testing.assert_array_equal(pred_t, pred_j)
        np.testing.assert_array_equal(order_t, order_j)
        np.testing.assert_allclose(prob_t, prob_j, rtol=0, atol=1e-5)


def test_voxelizer_dense_route_matches_jax():
    """The voxelizer family's dense route on a small UV sphere (8 x 8,
    dim 16) against JAX's ``_unsigned_distance``, within 1e-6 relative."""
    bench = _load_bench()
    tri_v = bench.uv_sphere(8, 8, 0.05)
    origin, res = bench.voxel_grid(16, 0.05)
    pts, _ = k3.blocked_grid(16, 16, 16, origin, res)
    want = np.asarray(jax.jit(jm._unsigned_distance)(jnp.asarray(pts),
                                                     jnp.asarray(tri_v)))
    got = k3.unsigned_distance_torch(torch.from_numpy(pts),
                                     torch.from_numpy(tri_v)).numpy()
    assert got.shape == want.shape == (16 * 16 * 16,)
    assert want.min() > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
