"""Readings that the comparison limits are set from: the numbers compared,
for the program and for its control, over many seeds in one process.

    python3 benchmarks/calibrate.py --workload <name> --seeds 1,2,3
        --mode program|control|fault:<name>|plant:<name> --seconds <s>
        [--out FILE]

Each seed builds the cell as a run does, runs its window for ``--seconds``
at the cell's own load, and then compares: ``program`` the program's
outputs (the lower readings), ``control`` the plain reference with every
product of the PointNet in TF32 (inputs and crop in float32) put in the
program's place (the upper readings), ``fault:half_batch`` (training) the
reference with half of each batch left out of the loss, ``fault:float64``
(training) the reference in float64, ``plant:<name>`` the program with a
fault of ``faults.py`` planted. One JSON line per seed on standard output
(and appended to ``--out``). Needs a CUDA device unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from benchmarks import faults, run  # noqa: E402


def readings(workload: str, seed: int, mode: str, seconds: float,
             device: str, overrides=None) -> dict:
    import torch

    bench = run.read_json(run.ROOT / "BENCHMARK.json")
    dev = torch.device(device)
    undo = (faults.PLANTS[mode.split(":", 1)[1]]()
            if mode.startswith("plant:") else (lambda: None))
    try:
        return _readings(bench, workload, seed, mode, seconds, dev,
                         overrides)
    finally:
        undo()


def _readings(bench, workload, seed, mode, seconds, dev, overrides):
    import torch

    _, traffic, _, cell, limits = run.make_cell(bench, workload, seed, dev,
                                                overrides)
    t0 = time.perf_counter()
    units = 0
    while time.perf_counter() - t0 < seconds:
        cell.unit(units)
        units += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if mode == "program" or mode.startswith("plant:"):
        checks = cell.check(units, limits)
    elif mode == "control":
        checks = cell.control(units, limits)
    else:
        checks = cell.control(units, limits, fault=mode.split(":", 1)[1])
    detail = getattr(cell, "detail", None)
    del cell
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"workload": workload, "seed": seed, "mode": mode,
            "units": units,
            "numbers": {k: v["value"] for k, v in checks.items()},
            **({"detail": detail} if detail else {})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(args.workload, seed, args.mode,
                                   args.seconds, args.device))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
