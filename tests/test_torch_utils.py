"""The port's ``utils`` package, public surface and install surface against
the JAX package.

- ``utils/config.py`` (a copy): ``YamlConfig`` and ``_mini_yaml`` equal to
  JAX's on the same files;
- ``utils/profiling.py``: ``StageTimer``'s summary and report in JAX's
  format, ``fetch_sync`` on tensors and containers, ``device_trace``
  writing a ``torch.profiler`` trace on the CPU;
- the module list: the port has a counterpart of every module of the JAX
  package but ``utils/cache.py`` (XLA's compilation cache; the port's
  compiled code is its kernel library, cached by ``_build.py``) and the
  three ``ops/*_pallas.py`` (``ops/{gpg_counts,pointnet_trunk,
  point_triangle}.py`` with their ``csrc/*.cu``);
- every subpackage exports the JAX one's public names, less ``EXCUSED``;
  importing every subpackage builds no kernel and imports no JAX;
- each ``pngpd-torch-*`` console script names a callable ``main`` of the
  port's module that mirrors the JAX script of the same name;
- every square root of the port goes through ``ops/fp.py`` but the sites
  listed in ``BARE_ROOTS``, each with the reason it needs no helper.
"""

import importlib
import json
import os
import re
import subprocess
import sys
import time
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

from pointnetgpd_tpu.utils import config as jconfig
from pointnetgpd_tpu.utils import profiling as jprof
from pointnetgpd_tpu_torch.utils import config as tconfig
from pointnetgpd_tpu_torch.utils import profiling as tprof

ROOT = Path(__file__).resolve().parents[1]

YAML = """\
# a reference-style config
sdf_dim: 100
sdf_padding: 5
friction_coef: 0.5   # inline comment
use_gpu: true
name: 'robotiq_85'
empty:
grasp_sampler:
  type: antipodal
  num_samples: 40
  angles: [0.0, 0.5, 1.0]
  nested:
    deep: ~
tail: -1.5e-3
"""


@pytest.mark.parametrize("use_yaml", [True, False])
def test_yaml_config_equals_jax(tmp_path, monkeypatch, use_yaml):
    path = tmp_path / "c.yaml"
    path.write_text(YAML)
    if not use_yaml:                   # the fallback parser
        monkeypatch.setitem(sys.modules, "yaml", None)
    got, want = tconfig.YamlConfig(str(path)), jconfig.YamlConfig(str(path))
    assert dict(got) == dict(want)
    assert got.grasp_sampler == want.grasp_sampler
    with pytest.raises(AttributeError):
        got.missing
    got["added"] = 3
    out_t, out_j = tmp_path / "t.yaml", tmp_path / "j.yaml"
    got.save(str(out_t))
    want["added"] = 3
    want.save(str(out_j))
    assert out_t.read_text() == out_j.read_text()
    assert dict(tconfig.YamlConfig({"a": 1})) == {"a": 1}


def test_mini_yaml_and_coerce_equal_jax(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text(YAML)
    assert tconfig._mini_yaml(str(path)) == jconfig._mini_yaml(str(path))
    for v in ("", "~", "null", "True", "false", "12", "-3.5e2", "[1, a, 2.5]",
              "[]", "'quoted'", "plain text"):
        assert tconfig._coerce(v) == jconfig._coerce(v), v


def test_stage_timer_summary_and_report_equal_jax():
    timers = [tprof.StageTimer(), jprof.StageTimer()]
    for t in timers:
        for name, total, calls in (("frame.gpg", 0.123456789, 3),
                                   ("a_stage", 2.0, 1), ("zero", 0.0, 2)):
            t.totals[name] = total
            t.counts[name] = calls
    assert timers[0].summary() == timers[1].summary()
    assert timers[0].report() == timers[1].report()
    # the context manager adds one call and the elapsed time
    t = tprof.StageTimer()
    x = torch.ones(3)
    with t.stage("s", sync={"a": [x]}):
        time.sleep(0.01)
    with t.stage("s"):
        pass
    s = t.summary()["s"]
    assert s["calls"] == 2 and s["total_s"] >= 0.01
    assert t.report().startswith("s" + " " * 29)


def test_fetch_sync_takes_tensors_and_containers():
    tprof.fetch_sync(torch.zeros(2))
    tprof.fetch_sync({"x": (None, [torch.zeros(1)])})
    tprof.fetch_sync([1, "no tensor"])
    assert tprof._first_tensor({"a": 1, "b": [torch.ones(2)]}).shape == (2,)
    assert tprof._first_tensor(3.0) is None


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    with tprof.device_trace(str(tmp_path)) as prof:
        y = torch.ones(64, 64) @ torch.ones(64, 64)
    assert float(y[0, 0]) == 64.0
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names)
    assert len(prof.key_averages()) > 0


# --------------------------------------------------------------- the surface

def _modules(pkg):
    base = ROOT / pkg
    return {str(p.relative_to(base)) for p in base.rglob("*.py")}


PALLAS = {"ops/gpg_counts_pallas.py": "ops/gpg_counts.py",
          "ops/pointnet_trunk_pallas.py": "ops/pointnet_trunk.py",
          "ops/point_triangle_pallas.py": "ops/point_triangle.py"}


def test_port_has_every_module_of_the_jax_package():
    jax_mods, port_mods = (_modules("pointnetgpd_tpu"),
                           _modules("pointnetgpd_tpu_torch"))
    missing = jax_mods - port_mods
    assert missing == {"utils/cache.py", *PALLAS}
    for pallas, port in PALLAS.items():
        assert port in port_mods
        cu = ROOT / "pointnetgpd_tpu_torch" / "csrc" / (
            Path(port).stem + ".cu")
        assert cu.is_file(), cu
    # the drivers in examples/ have theirs in the port's examples/
    drivers = {p.name for p in (ROOT / "examples").glob("*.py")}
    assert len(drivers) == 5
    assert {f"examples/{d}" for d in drivers} <= port_mods
    # no module of the port, and not chip_smoke.py or the probe it runs,
    # imports JAX or the JAX package
    bad = re.compile(r"^\s*(import jax|from jax|import pointnetgpd_tpu\b"
                     r"|from pointnetgpd_tpu[ .])", re.M)
    sources = [ROOT / "pointnetgpd_tpu_torch" / m for m in port_mods] + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "cpu_roots_probe.py"]
    assert [str(f) for f in sources if bad.search(f.read_text())] == []


# every bare root of the port outside ops/fp.py, and why it needs no fp
# helper (ROADMAP Queue C item 24): MKL's vector math, which torch.sqrt
# calls on the CPU, can run the wrong kernel on a process's first call;
# torch.linalg.norm is a reduction that takes the CPU's own square root
# (tools/cpu_roots_probe.py dispatch)
NOT_MKL = "torch.linalg.norm: a reduction with the CPU's own root, not MKL"
BARE_ROOTS = {
    "__init__.py": {"torch.sqrt(": (1, "the one-element call that runs "
                                       "MKL's CPU detection on one thread")},
    "ops/cloud.py": {"torch.linalg.norm(": (5, NOT_MKL)},
    "ops/point_triangle.py": {"torch.linalg.norm(": (2, NOT_MKL)},
    "grasping/quality.py": {"torch.linalg.norm(": (3, "float64 (the facet "
                                                      "tests), or " + NOT_MKL)},
}


def test_square_roots_go_through_ops_fp():
    pat = re.compile(r"torch\.sqrt\(|\.sqrt\(\)|torch\.rsqrt\("
                     r"|torch\.linalg\.norm\(")
    found = {}
    base = ROOT / "pointnetgpd_tpu_torch"
    for path in sorted(base.rglob("*.py")):
        rel = str(path.relative_to(base))
        if rel == "ops/fp.py":
            continue
        for line in path.read_text().splitlines():
            if line.lstrip().startswith("#"):
                continue
            for m in pat.findall(line):
                sites = found.setdefault(rel, {})
                sites[m] = sites.get(m, 0) + 1
    assert found == {rel: {m: n for m, (n, _) in sites.items()}
                     for rel, sites in BARE_ROOTS.items()}

SUBPACKAGES = ["grasping", "ops", "geometry", "inference", "models",
               "render", "database", "visualization", "learning", "utils",
               "pipelines", "robot", "parallel", "training", "cli"]


def _excused():
    from pointnetgpd_tpu_torch.models import FUNCTIONAL_NAMES

    # name in the JAX package's __all__ -> its counterpart in the port
    return {"ops": {"gpg_counts_pallas": "gpg_counts",
                    "pointnet_trunk_pallas": "pointnet_trunk"},
            "models": FUNCTIONAL_NAMES}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_cover_jax(sub):
    jmod = importlib.import_module(f"pointnetgpd_tpu.{sub}")
    tmod = importlib.import_module(f"pointnetgpd_tpu_torch.{sub}")
    want = set(getattr(jmod, "__all__", ()))
    got = set(getattr(tmod, "__all__", ()))
    excused = _excused().get(sub, {})
    assert want - got <= set(excused), sorted(want - got - set(excused))
    for name in got:
        assert hasattr(tmod, name), name
    for jname, counterpart in excused.items():
        head = counterpart.split(".")[0]
        assert hasattr(tmod, head) or importlib.util.find_spec(
            f"pointnetgpd_tpu_torch.{sub}.{head}"), counterpart


def test_subpackage_names_are_the_port_objects():
    from pointnetgpd_tpu_torch import grasping, inference, ops
    from pointnetgpd_tpu_torch.grasping import samplers, surface_window
    from pointnetgpd_tpu_torch.inference import scorer

    mts = importlib.import_module("pointnetgpd_tpu_torch.ops.mesh_to_sdf")
    assert grasping.antipodal_sample_grasps is samplers.antipodal_sample_grasps
    assert grasping.surface_window_sdf is surface_window.surface_window_sdf
    assert inference.GraspScorer is scorer.GraspScorer
    assert ops.mesh_to_sdf is mts.mesh_to_sdf


def test_importing_the_port_builds_nothing_and_imports_no_jax():
    code = (
        "import sys\n"
        f"for s in {SUBPACKAGES!r}:\n"
        "    __import__('pointnetgpd_tpu_torch.' + s)\n"
        "from pointnetgpd_tpu_torch import _build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pointnetgpd_tpu')]\n"
        "assert not bad, bad\n"
        "assert _build._LIB is None\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def test_console_scripts_name_the_ports_mains():
    with open(ROOT / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    port = {k: v for k, v in scripts.items() if k.startswith("pngpd-torch-")}
    jax_side = {k: v for k, v in scripts.items()
                if k.startswith("pngpd-") and k not in port}
    assert len(jax_side) == 7
    assert sorted(port) == sorted(k.replace("pngpd-", "pngpd-torch-", 1)
                                  for k in jax_side)
    for name, target in port.items():
        mod, func = target.split(":")
        assert target == jax_side[name.replace("pngpd-torch-", "pngpd-")
                                  ].replace("pointnetgpd_tpu.",
                                            "pointnetgpd_tpu_torch.", 1)
        assert callable(getattr(importlib.import_module(mod), func)), target


def test_port_utils_has_no_compilation_cache():
    assert importlib.util.find_spec("pointnetgpd_tpu_torch.utils.cache") \
        is None
    assert np.all([hasattr(tprof, n) for n in ("fetch_sync", "StageTimer",
                                              "device_trace")])
