"""The harness: the import check, the run without a card, and a cell found
by name from data files alone."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmarks import run

ROOT = Path(run.ROOT)
SMALL_SCORE = dict(scene_points=5000, candidates=32, num_points=64, scenes=2,
                   check_units=2, trace_units=2)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    fake = object()
    for name in ("pointnetgpd_tpu_torch_extra", "jaxtyping", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert run.forbidden_modules() == []
    for name in ("pointnetgpd_tpu.ops", "jaxlib", "flax.linen", "jax"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert run.forbidden_modules() == ["flax.linen", "jax", "jaxlib",
                                       "pointnetgpd_tpu.ops"]


def test_a_cpu_run_loads_no_jax():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmarks import run\n"
        "bench = run.read_json(run.ROOT / 'BENCHMARK.json')\n"
        "out = run.run_cell(bench, 'pointnetgpd-1v-3class.score-batch', 7,"
        f" 0.2, False, device='cpu', overrides={SMALL_SCORE!r})\n"
        "print(json.dumps([out['correct'], run.forbidden_modules(),"
        " 'pointnetgpd_tpu_torch' in sys.modules]))\n")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert got.returncode == 0, got.stderr[-2000:]
    correct, bad, loaded = json.loads(got.stdout.strip().splitlines()[-1])
    assert correct and bad == [] and loaded


def test_a_run_without_a_card_fails_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    got = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload",
         "pointnetgpd-1v-3class.score-batch", "--seed", "4294967311",
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
        timeout=300, cwd=ROOT, env=env)
    assert got.returncode != 0
    assert got.stdout == ""


def test_a_run_outside_a_checkout_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmarks", tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    got = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, '.');"
         "from benchmarks import run; import json;"
         "b = run.read_json(run.ROOT / 'BENCHMARK.json');"
         "run.run_cell(b, 'pointnetgpd-1v-3class.score-batch', 1, 0.1,"
         " False, device='cpu')"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert got.returncode != 0
    assert "pointnetgpd_tpu_torch" in got.stderr
    assert got.stdout == ""


def test_a_new_mix_is_a_data_file_alone(tmp_path):
    """A copy of the benchmark gains a cell: a traffic file, a limits file
    and an entry in BENCHMARK.json; no existing file of the benchmark is
    edited, and the cell runs."""
    tree = tmp_path / "tree"
    shutil.copytree(ROOT / "benchmarks", tree / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tree / "benchmarks").rglob("*")
              if p.is_file()}
    mix = json.loads((ROOT / "benchmarks/traffic/score-batch.json")
                     .read_text())
    mix.update(SMALL_SCORE, candidates=48, why="a smaller scene")
    (tree / "benchmarks/traffic/score-small.json").write_text(json.dumps(mix))
    name = "pointnetgpd-1v-3class.score-small"
    shutil.copy(ROOT / "benchmarks/limits/pointnetgpd-1v-3class"
                       ".score-batch.json",
                tree / f"benchmarks/limits/{name}.json")
    bench["workloads"].append({"name": name,
                               "config": "pointnetgpd-1v-3class",
                               "traffic": "score-small", "chips": 1,
                               "why": "a smaller scene"})
    for m in bench["end_to_end"]:
        if m["name"] == "candidates_per_s":
            m["workloads"].append(name)
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(tree)!r})\n"
        "from benchmarks import run\n"
        "bench = run.read_json(run.ROOT / 'BENCHMARK.json')\n"
        f"out = run.run_cell(bench, {name!r}, 3, 0.2, False, device='cpu')\n"
        "print(json.dumps(out))\n")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         cwd=ROOT)
    assert got.returncode == 0, got.stderr[-2000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert set(out["metrics"]) == {"candidates_per_s", "setup_s"}


def test_benchmark_json_keeps_the_contract_shape():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["per_layer"]:
        assert (run.HERE / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert (run.HERE / "metrics" / f"{m['name']}.py").exists()
    for w in bench["workloads"]:
        assert (run.HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (run.HERE / "limits" / f"{w['name']}.json").exists()
        assert w["chips"] == 1


@pytest.mark.parametrize("trace", [False, True])
def test_score_cell_on_the_cpu(trace):
    bench = run.read_json(run.ROOT / "BENCHMARK.json")
    out = run.run_cell(bench, "pointnetgpd-1v-3class.score-batch",
                       2 ** 31 + 17, 0.3, trace, device="cpu",
                       overrides=SMALL_SCORE)
    assert out["correct"]
    assert list(out)[-1] == "checks"
    want = {"mfu.score", "device_idle.score"} if trace else {
        "candidates_per_s", "setup_s"}
    assert set(out["metrics"]) == want      # no K2 on the CPU: no roofline
