"""PointNet++ SSG operations and K7's least work, counted from the
configuration's widths.

Model operations (2 per multiply-add; BatchNorm, ReLU, max, the gathers and
log-softmax are not counted): each set-abstraction level runs its shared
MLP on every grouped row (npoint x nsample rows, or every point of the
level that groups all), then the head. At the published widths and 1024
points a sample's forward is 1,675,035,648: SA1 408,944,640 (16,384 rows x
12,480 multiply-adds), SA2 1,080,033,280 (8,192 x 65,920), SA3 184,745,984
(128 x 721,664), the head 1,311,744.

K7's least work on a batch: each farthest-point sample's npoint - 1
passes over its cloud, 9 float32 instructions a point (three differences,
three squares, two sums and a minimum) at the card's float32 instruction
rate (half its float32 peak, which counts a fused multiply-add as two);
each ball query's bytes, the cloud and the centroids read once and the
int64 indices written once.
"""

from __future__ import annotations

from . import peaks

FP32_INSTRUCTIONS = peaks.FP32_FLOPS / 2
FPS_INSTRUCTIONS_PER_POINT = 9


def forward_flops(config: dict) -> int:
    """One sample's forward."""
    total, chann, points = 0, 0, config["num_points"]
    for sa in config["sa"]:
        rows = points if sa["npoint"] is None else sa["npoint"] * sa["nsample"]
        dims = (chann + 3,) + tuple(sa["mlp"])
        total += 2 * rows * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        chann, points = sa["mlp"][-1], sa["npoint"]
    dims = (chann,) + tuple(config["fc"]) + (config["k"],)
    return total + 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def train_flops(config: dict) -> int:
    """A training sample: its forward and a backward of twice the
    forward."""
    return 3 * forward_flops(config)


def fps_instructions(b: int, n: int, npoint: int) -> int:
    return b * max(npoint - 1, 0) * n * FPS_INSTRUCTIONS_PER_POINT


def ball_query_bytes(b: int, n: int, s: int, nsample: int) -> int:
    return b * n * 3 * 4 + b * s * 3 * 4 + b * s * nsample * 8


def k7_bound_s(config: dict, batch: int) -> float:
    """K7's least time for one batch's sampling and grouping, in s."""
    t, n = 0.0, config["num_points"]
    for sa in config["sa"]:
        if sa["npoint"] is None:
            break
        s = sa["npoint"]
        t += fps_instructions(batch, n, s) / FP32_INSTRUCTIONS
        t += ball_query_bytes(batch, n, s, sa["nsample"]) \
            / peaks.HBM_BYTES_PER_S
        n = s
    return t
