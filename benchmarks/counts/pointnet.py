"""PointNetCls operations, counted from its layer widths (2 per
multiply-add; BatchNorm, ReLU, max and softmax are not counted)."""

from __future__ import annotations


def trunk_flops_per_point(c: int = 3, widths=(64, 128, 1024)) -> int:
    """One shared MLP c -> 64 -> 128 -> 1024: 278,912 per point."""
    dims = (c,) + tuple(widths)
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def head_flops(k: int, widths=(1024, 512, 256)) -> int:
    dims = tuple(widths) + (k,)
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def forward_flops(n_points: int, k: int, c: int = 3) -> int:
    """One cloud of ``n_points`` through STN3d, the 3x3 product, the
    PointNetfeat trunk and the k-class head."""
    trunks = 2 * trunk_flops_per_point(c) * n_points
    transform = 2 * c * 3 * n_points
    return trunks + transform + head_flops(9) + head_flops(k)


def train_flops(n_points: int, k: int, c: int = 3) -> int:
    """A training sample: its forward and a backward of twice the forward."""
    return 3 * forward_flops(n_points, k, c)
