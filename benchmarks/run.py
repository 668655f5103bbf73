"""Run one cell of the benchmark once and print its one JSON line.

    python3 benchmarks/run.py --workload <name> --seed <n> --seconds <s>
                              --trace <0|1>

The cell (``workloads`` in BENCHMARK.json) names a configuration
(``configs/<config>.json``, found through its ``file``) and a traffic mix
(``traffic/<traffic>.json``). The mix's ``kind`` picks its module
(``kinds/<kind>.py``), which builds inputs and weights from the seed,
warms every shape up and runs one unit of work at a time. Every metric is
read by its own file, ``metrics/<metric name>.py``; a comparison limit of a
cell is in ``limits/<workload>.json``.

Set-up (``setup_s``) runs from the start of this process to the start of
the window. The window runs units back to back for ``--seconds`` and ends
in a synchronize. With ``--trace 1`` the window runs under
``torch.profiler`` for at most the mix's ``trace_units`` units, and the
per-layer metrics are printed instead of the end-to-end ones. After the
window, once the peak memory has been read, the cell frees the program's
state and compares the window's outputs with the plain reference; each
number compared is printed beside its limit, on standard error and as the
line's last key. A run without a CUDA device, or whose process holds JAX
or the JAX package after the window, exits non-zero without a result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "pointnetgpd_tpu")


def load_file(path: Path):
    """Import a file of the benchmark by its path (names may hold dots)."""
    name = "benchmarks._loaded." + path.relative_to(HERE).as_posix() \
        .replace("/", "__").replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def cell_parts(bench: dict, workload: str):
    """(workload entry, configuration dict, traffic dict) by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return (cell, read_json(ROOT / cfg["file"]),
            read_json(HERE / "traffic" / f"{cell['traffic']}.json"))


def metrics_of(bench: dict, cell: dict, trace: bool) -> list[dict]:
    """The metrics a cell reports: an end-to-end metric where it lists the
    cell or lists none; a per-layer one where it lists the cell, or lists
    none and the cell reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def make_cell(bench: dict, workload: str, seed: int, dev, overrides=None):
    """Set-up of a cell: (workload entry, traffic, configuration, the
    kind's cell built from the seed on ``dev``, comparison limits)."""
    import torch

    cell, config, traffic = cell_parts(bench, workload)
    traffic = dict(traffic, **(overrides or {}))
    # the configurations state float32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = load_file(HERE / "kinds" / f"{traffic['kind']}.py")
    limits = read_json(HERE / "limits" / f"{workload}.json")
    return (cell, traffic, config, kind.Cell(config, traffic, seed, dev),
            limits)


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", overrides=None) -> dict:
    """One run of a cell; returns the result's dict. ``overrides`` replaces
    traffic parameters (the tests run cells at small sizes on the CPU)."""
    import torch

    dev = torch.device(device)
    cell, traffic, config, unit_cell, limits = make_cell(
        bench, workload, seed, dev, overrides)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    sync()
    setup_s = time.perf_counter() - T_START

    cap = traffic["trace_units"] if trace else None
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
        window_range = record_function("bench.window")
        window_range.__enter__()
    latencies = []
    t0 = time.perf_counter()
    units = 0
    while time.perf_counter() - t0 < seconds and (cap is None or units < cap):
        t_unit = time.perf_counter()
        if trace:
            with record_function("bench.unit"):
                unit_cell.unit(units)
        else:
            unit_cell.unit(units)
        latencies.append(time.perf_counter() - t_unit)
        units += 1
    sync()
    window_s = time.perf_counter() - t0
    tr = None
    if trace:
        window_range.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        from benchmarks.trace import Trace
        tr = Trace(prof)
        del prof
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    checks = unit_cell.check(units, limits)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    ctx = SimpleNamespace(setup_s=setup_s, window_s=window_s, units=units,
                  latencies=latencies, cell=unit_cell, trace=tr,
                  traffic=traffic, config=config)
    metrics = {}
    for m in metrics_of(bench, cell, trace):
        value = load_file(HERE / "metrics" / f"{m['name']}.py").read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": units, "failed": 0,
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": cell["chips"], "memory_peak_bytes": peak}}
    if tr is not None:
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = checks
    return out


def power_limit() -> str | None:
    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return got.splitlines()[0] if got else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = read_json(ROOT / "BENCHMARK.json")
    cell, _, _ = cell_parts(bench, args.workload)

    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"error: the cell needs {cell['chips']} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"error: JAX or the JAX package is loaded: {bad}",
              file=sys.stderr)
        return 3
    card = power_limit()
    if card:
        out["device"]["card"] = card
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
