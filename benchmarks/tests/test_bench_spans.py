"""The readers of the program's spans: the count, idle and self-time
helpers on hand-built intervals, and every span metric of each cell
reported by a traced run on the CPU."""

from types import SimpleNamespace

import pytest

from benchmarks import run
from benchmarks.metrics import _idle_in, _self, _span_count

BENCH = run.read_json(run.ROOT / "BENCHMARK.json")
SMALL = {
    "pointnetgpd-1v-3class.frame-tabletop": dict(
        face_points=500, scenes=1, check_units=1, trace_units=1),
    "pointnetgpd-1v-3class.score-batch": dict(
        scene_points=5000, candidates=32, num_points=64, scenes=2,
        check_units=2, trace_units=2),
    "pointnetgpd-1v-2class.train-b128": dict(
        batch=8, cloud_points=5000, num_points=64, pool=3, trace_units=2),
}
NEW = {
    "pointnetgpd-1v-3class.frame-tabletop": (
        "frame.gpg_seeds_ms", "frame.gpg_local_frames_ms",
        "frame.window_normals_ms", "frame.gpg_scans_ms", "frame.crop_ms",
        "frame.forward_ms", "frame.fetch_ms", "frame.fetches",
        "frame.gpg_idle_ms", "frame.other_ms"),
    "pointnetgpd-1v-3class.score-batch": (
        "score.crop_ms", "score.forward_ms", "score.rank_ms"),
    "pointnetgpd-1v-2class.train-b128": (
        "train.forward_ms", "train.backward_ms", "train.adam_ms"),
}

MS = 1_000_000                                    # ns


def _ctx(units=2):
    """Two units: a root [0, 10] ms with children [1, 4] and [3, 6] ms
    (overlapping) and [6, 6.5] ms nested in [5, 7]; a root [20, 30] ms
    with one child [20, 30] ms at its edges. The device is busy [2, 5]
    and [8, 22] ms."""
    roots = [(0, 10 * MS), (20 * MS, 30 * MS)]
    kids = [(1 * MS, 4 * MS), (3 * MS, 6 * MS), (5 * MS, 7 * MS),
            (6 * MS, 6.5 * MS), (20 * MS, 30 * MS)]
    ann = ([(a, b, "root") for a, b in roots]
           + [(a, b, f"kid{i}") for i, (a, b) in enumerate(kids)]
           + [(-5 * MS, 40 * MS, "bench.unit")])
    trace = SimpleNamespace(spans={"root": roots, "kid0": kids[:1]},
                            busy=[[2 * MS, 5 * MS], [8 * MS, 22 * MS]],
                            annotations=ann)
    return SimpleNamespace(trace=trace, units=units)


def test_span_count_per_unit():
    ctx = _ctx()
    assert _span_count.per_unit(ctx, "root") == 1.0
    assert _span_count.per_unit(ctx, "kid0") == 0.5
    assert _span_count.per_unit(ctx, "absent") is None
    assert _span_count.per_unit(SimpleNamespace(trace=None, units=2),
                                "root") is None


def test_idle_inside_a_span():
    ctx = _ctx()
    # root 1: 10 ms less busy [2, 5] and [8, 10]; root 2: 10 ms less
    # busy [20, 22]
    assert _idle_in.per_unit_ms(ctx, "root") == pytest.approx(
        (10 - 3 - 2 + 10 - 2) / 2)
    assert _idle_in.per_unit_ms(ctx, "kid0") == pytest.approx(1 / 2)
    assert _idle_in.per_unit_ms(ctx, "absent") is None
    assert _idle_in.covered_ns(0, 1, []) == 0
    assert _idle_in.covered_ns(5 * MS, 8 * MS, ctx.trace.busy) == 0


def test_self_time_of_a_span():
    ctx = _ctx()
    # root 1: children cover [1, 7]; root 2: fully covered at its edges;
    # the enclosing bench.unit is no child
    assert _self.per_unit_ms(ctx, "root") == pytest.approx((10 - 6) / 2)
    assert _self.per_unit_ms(ctx, "absent") is None
    assert _self.union_ns([(3, 6), (1, 4), (7, 8), (7, 8)]) == 6


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_traced_cpu_run_reports_every_span_metric(workload):
    out = run.run_cell(BENCH, workload, 2 ** 31 + 29, 0.05, True,
                       device="cpu", overrides=SMALL[workload])
    assert out["correct"]
    for name in NEW[workload]:
        assert out["metrics"][name]["value"] is not None, name
    if "frame.fetches" in NEW[workload]:
        assert out["metrics"]["frame.fetches"]["value"] == 9.0
    listed = {m["name"] for m in BENCH["per_layer"]
              if workload in m.get("workloads", ())}
    assert set(NEW[workload]) <= listed
