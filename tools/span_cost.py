"""Cost of one profiler range: enter and exit of ``record_function`` and of
``utils.profiling.span``, with the profiler off and on.

    python3 tools/span_cost.py [--n 200000]

Prints one JSON line: microseconds per enter and exit, the best of five
repeats of ``n`` ranges each, and the card's name and power limit where
there is a card. The profiler-on numbers trace the CPU, and the card's
activity where CUDA is available, as the benchmark's traced runs do.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from pointnetgpd_tpu_torch.utils import profiling  # noqa: E402


def per_range_us(make, n: int, reps: int = 5) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            with make("span.cost"):
                pass
        best = min(best, time.perf_counter() - t0)
    return best / n * 1e6


def card() -> str | None:
    if not torch.cuda.is_available():
        return None
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    args = ap.parse_args(argv)
    makers = {"record_function": record_function}
    if hasattr(profiling, "span"):
        makers["span"] = profiling.span
    out = {"card": card(), "torch": torch.__version__, "n": args.n}
    for name, make in makers.items():
        per_range_us(make, 1000, reps=1)                 # warm
        out[f"{name}_off_us"] = per_range_us(make, args.n)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    n_on = max(args.n // 20, 1000)        # the profiler keeps every range
    for name, make in makers.items():
        with profile(activities=acts):
            out[f"{name}_on_us"] = per_range_us(make, n_on, reps=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
