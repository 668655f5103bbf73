"""Where one benchmark cell's unit spends its time, span by span, on the
card.

    python3 tools/span_report.py --workload <cell> --seed <n> [--out FILE]

Builds the cell as ``benchmarks/run.py`` does, times its first
``trace_units`` units with no profiler (host clock, one synchronize at the
end), then runs the same units again under ``torch.profiler`` inside the
``bench.window`` and ``bench.unit`` ranges, as a ``--trace 1`` run does,
and reads the trace with the benchmark's own reader. Prints one JSON line:
the mean unit time untraced and traced; for each program range its
intervals, host time and device-idle time per unit; the share of each
root's time its stage ranges cover; the self time of ``frame.process``;
and every idle gap of 0.5 ms or more with the innermost range open in it.
``--out`` also writes the line to a file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import run  # noqa: E402
from benchmarks.metrics._idle_in import covered_ns  # noqa: E402
from benchmarks.metrics._self import per_unit_ms, union_ns  # noqa: E402

# root -> the stage ranges directly inside it
STAGES = {
    "frame.process": ("frame.pad", "frame.upload_voxel", "frame.bbox",
                      "frame.normals", "frame.gpg", "frame.compact",
                      "frame.score", "frame.collect", "frame.finish"),
    "frame.gpg": ("gpg.seeds", "gpg.local_frames", "gpg.compact",
                  "gpg.tiles", "gpg.dy", "gpg.approach", "gpg.final",
                  "gpg.unsort"),
    "score.candidates": ("score.crop", "score.forward", "score.rank"),
    "train.step": ("train.crop", "train.fwd_bwd", "train.adam"),
    "train.fwd_bwd": ("train.forward", "train.backward"),
}
GAP_S = 0.5e-3


def coverage(tr, root, stages):
    """Share of the root's intervals that its stage ranges cover."""
    roots = tr.spans.get(root)
    if not roots:
        return None
    kids = [iv for s in stages for iv in tr.spans.get(s, [])]
    total = sum(b - a for a, b in roots)
    inside = sum(union_ns([(max(s, a), min(e, b)) for s, e in kids
                           if s < b and e > a]) for a, b in roots)
    return inside / total


def report(tr, units):
    spans = {}
    for name, ivs in sorted(tr.spans.items()):
        if not ivs:
            continue
        host = sum(b - a for a, b in ivs)
        idle = host - sum(covered_ns(a, b, tr.busy) for a, b in ivs)
        spans[name] = {"per_unit": len(ivs) / units,
                       "ms": host * 1e-6 / units,
                       "idle_ms": idle * 1e-6 / units}
    out = {"spans": spans,
           "coverage": {r: coverage(tr, r, s) for r, s in STAGES.items()
                        if r in tr.spans},
           "gaps": [g for g in tr.idle_gaps(n=10 ** 6) if g[1] >= GAP_S],
           "device_ops": tr.device_ops(),
           "window_s": tr.window_s, "busy_s": tr.busy_s}
    if "frame.process" in tr.spans:
        out["frame_other_ms"] = per_unit_ms(
            SimpleNamespace(trace=tr, units=units), "frame.process")
    return out


def card() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--units", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmarks.trace import Trace

    bench = run.read_json(ROOT / "BENCHMARK.json")
    dev = torch.device(args.device)
    _, traffic, _, cell, _ = run.make_cell(bench, args.workload, args.seed,
                                           dev)
    n = args.units or traffic["trace_units"]
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)

    sync()
    t0 = time.perf_counter()
    for i in range(n):
        cell.unit(i)
    sync()
    plain_s = (time.perf_counter() - t0) / n

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function("bench.window"):
            t0 = time.perf_counter()
            for i in range(n):
                with record_function("bench.unit"):
                    cell.unit(i)
            sync()
            traced_s = (time.perf_counter() - t0) / n
    out = {"workload": args.workload, "seed": args.seed, "units": n,
           "card": card(), "unit_ms": plain_s * 1e3,
           "traced_unit_ms": traced_s * 1e3}
    out.update(report(Trace(prof), n))
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
