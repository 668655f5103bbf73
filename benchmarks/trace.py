"""Reading a ``torch.profiler`` trace of the measured window.

Device work is every kernel, copy and fill the profiler saw on the card;
host ranges are the ``record_function`` labels (user annotations). The
window is the benchmark's own ``bench.window`` range. Times are seconds.
"""

from __future__ import annotations

from collections import defaultdict

WINDOW = "bench.window"


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _is_annotation(e) -> bool:
    if hasattr(e, "activity_type"):
        return e.activity_type() in ("user_annotation",
                                     "gpu_user_annotation")
    return e.is_user_annotation()


class Trace:
    def __init__(self, prof):
        events = prof.profiler.kineto_results.events()
        spans = defaultdict(list)
        device = []
        annotations = []
        for e in events:
            if _is_annotation(e):
                if not _is_device(e):
                    spans[e.name()].append((e.start_ns(), e.end_ns()))
                    annotations.append((e.start_ns(), e.end_ns(), e.name()))
            elif _is_device(e):
                # kernels, copies and fills on the card
                device.append((e.start_ns(), e.end_ns(), e.name()))
        (w0, w1), = spans.pop(WINDOW)
        self.t0, self.t1 = w0, w1
        self.window_s = (w1 - w0) * 1e-9
        self.spans = {k: [(a, b) for a, b in v if a >= w0 and b <= w1]
                      for k, v in spans.items()}
        self.device = sorted((max(a, w0), min(b, w1), n) for a, b, n in device
                             if b > w0 and a < w1)
        self.annotations = [a for a in annotations if a[2] != WINDOW]
        self.busy = self._merge()

    def _merge(self):
        out = []
        for a, b, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-9

    def span_s(self, name: str) -> float | None:
        got = self.spans.get(name)
        if not got:
            return None
        return sum(b - a for a, b in got) * 1e-9

    def device_s(self, *substrings) -> float:
        return sum(b - a for a, b, n in self.device
                   if any(s in n for s in substrings)) * 1e-9

    def device_ops(self, n: int = 10):
        tot = defaultdict(int)
        for a, b, name in self.device:
            tot[name] += b - a
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n: int = 10):
        """The longest stretches with nothing on the device, each named by
        the innermost host range open at its middle."""
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        out = []
        for length, a, b in gaps[:n]:
            mid = (a + b) // 2
            open_ = [(e - s, name) for s, e, name in self.annotations
                     if s <= mid <= e]
            label = min(open_)[1] if open_ else "outside every range"
            out.append([label, length * 1e-9])
        return out
