"""Fused, BN-folded PointNet trunk: shared MLP + max over points (kernel K2).

Port of ``pointnetgpd_tpu/ops/pointnet_trunk_pallas.py``. The eval-mode MLP
3 -> 64 -> 128 -> 1024 with BatchNorm folded into the weights, ReLU after
layers 1 and 2, none after layer 3, then the max over the point axis
(reference PointNetGPD/model/pointnet.py:144-149).

In the port this carries the scorer's eval forward: the STN3d trunk (whose
ReLU after layer 3 commutes with the max) and the PointNetfeat trunk both go
through ``fused_trunk``, which launches ``csrc/pointnet_trunk.cu`` for CUDA
tensors (or raises) and takes ``trunk_reference`` for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _build

launches = 0             # kernel launches (CUDA path only)


def fold_bn(w, b, scale, bias, mean, var, eps: float = 1e-5):
    """Fold eval-mode BN into a linear layer: y = (x @ W.T + b) -> BN."""
    gamma = scale / torch.sqrt(var + eps)
    return w * gamma[:, None], (b - mean) * gamma + bias


def fold_trunk_params(module):
    """A module with ``conv1..3`` (1x1 Conv1d) and ``bn1..3`` (STN3d or
    PointNetfeat) -> folded (w1, b1, w2, b2, w3, b3), weights transposed to
    (in, out)."""
    out = []
    for i in (1, 2, 3):
        conv, bn = getattr(module, f"conv{i}"), getattr(module, f"bn{i}")
        w, b = fold_bn(conv.weight[:, :, 0], conv.bias, bn.weight, bn.bias,
                       bn.running_mean, bn.running_var, bn.eps)
        out += [w.t().contiguous(), b.contiguous()]
    return tuple(out)


def trunk_reference(x, folded):
    """Plain version. x (B, N, C) -> (B, 1024)."""
    w1, b1, w2, b2, w3, b3 = folded
    h = torch.relu(x @ w1 + b1)
    h = torch.relu(h @ w2 + b2)
    h = h @ w3 + b3
    return torch.amax(h, dim=1)


def fused_trunk(x, folded):
    """x (B, N, C) post-STN points, folded from ``fold_trunk_params`` ->
    (B, 1024) global features. CUDA tensors launch the kernel."""
    if not x.is_cuda:
        return trunk_reference(x, folded)
    return _launch(x, folded)


def _launch(x, folded):
    global launches
    w1, b1, w2, b2, w3, b3 = (t.detach() for t in folded)
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"x must be (B, N, C) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    bsz, n, c = x.shape
    want = {"w1": (w1, (c, 64)), "b1": (b1, (64,)), "w2": (w2, (64, 128)),
            "b2": (b2, (128,)), "w3": (w3, (128, 1024)), "b3": (b3, (1024,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")
    if not 1 <= c <= 8:
        raise ValueError(f"the kernel takes 1..8 input channels, got {c}")
    out = torch.empty((bsz, 1024), dtype=torch.float32, device=x.device)
    if bsz == 0:
        return out
    if n == 0:
        raise ValueError("max over an empty point axis")
    x = x.contiguous()
    lib = _build.library()
    err = lib.pointnet_trunk_launch(
        x.data_ptr(), bsz, n, c, w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "pointnet_trunk_launch")
    launches += 1
    return out
