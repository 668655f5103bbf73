"""Plain PointNetCls (PointNetGPD's classifier) in float32 torch operations.

The architecture of PointNetGPD/model/pointnet.py (lianghongzhuo/PointNetGPD,
arXiv:1809.06267): STN3d (shared MLP 3 -> 64 -> 128 -> 1024, max over points,
ReLU, FC 1024 -> 512 -> 256 -> 9, plus the identity), the points multiplied
by that 3x3, the PointNetfeat trunk 3 -> 64 -> 128 -> 1024 with max-pool (no
ReLU after its third layer), and the head 1024 -> 512 -> 256 -> k with
log-softmax. Every hidden layer is linear -> BatchNorm -> ReLU. Parameters
are a dict under the reference's state_dict names.

Nothing here imports the program: weights come in as tensors, activations
are plain matmuls, BatchNorm is written out. Train mode normalizes with the
batch's mean and biased variance over every axis but the channel axis, as
``torch.nn.BatchNorm1d`` does; eval mode uses the running statistics.
"""

from __future__ import annotations

import torch

BN_EPS = 1e-5


def to_tf32(x):
    """float32 rounded to TF32's 10-bit mantissa (to nearest), the
    precision in which tensor cores take float32 operands."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return to_tf32(a) @ to_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = (to_tf32(t) for t in ctx.saved_tensors)
        g = to_tf32(g)
        ga = g @ b.transpose(-1, -2)
        if b.dim() == 2:
            gb = a.reshape(-1, a.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        else:
            gb = a.transpose(-1, -2) @ g
        return ga, gb


def _mm(a, b, tf32: bool):
    """a @ b with float32 accumulation; with ``tf32`` the operands are
    rounded to TF32 first, in the backward too (the control's
    precision)."""
    return _TF32MatMul.apply(a, b) if tf32 else a @ b


def param_shapes(k: int, c: int = 3, trunk=(64, 128, 1024),
                 fc=(512, 256)) -> list[tuple[str, tuple]]:
    """(name, shape) of every parameter and BatchNorm statistic, in one
    fixed order. Conv1d weights are (out, in, 1) as in the reference."""
    out = []

    def conv(prefix, cin, cout):
        out.extend([(f"{prefix}.weight", (cout, cin, 1)),
                    (f"{prefix}.bias", (cout,))])

    def lin(prefix, cin, cout):
        out.extend([(f"{prefix}.weight", (cout, cin)),
                    (f"{prefix}.bias", (cout,))])

    def bn(prefix, n):
        out.extend([(f"{prefix}.weight", (n,)), (f"{prefix}.bias", (n,)),
                    (f"{prefix}.running_mean", (n,)),
                    (f"{prefix}.running_var", (n,))])

    c1, c2, c3 = trunk
    f1, f2 = fc
    for pre in ("feat.stn", "feat"):
        conv(f"{pre}.conv1", c, c1)
        conv(f"{pre}.conv2", c1, c2)
        conv(f"{pre}.conv3", c2, c3)
        bn(f"{pre}.bn1", c1)
        bn(f"{pre}.bn2", c2)
        bn(f"{pre}.bn3", c3)
    lin("feat.stn.fc1", c3, f1)
    lin("feat.stn.fc2", f1, f2)
    lin("feat.stn.fc3", f2, 9)
    bn("feat.stn.bn4", f1)
    bn("feat.stn.bn5", f2)
    lin("fc1", c3, f1)
    lin("fc2", f1, f2)
    lin("fc3", f2, k)
    bn("bn1", f1)
    bn("bn2", f2)
    return out


def is_trainable(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


def _linear(p, name, x, tf32=False):
    w = p[f"{name}.weight"]
    if w.dim() == 3:
        w = w[:, :, 0]
    return _mm(x, w.t(), tf32) + p[f"{name}.bias"]


def _bn(p, name, x, train: bool):
    if train:
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(dim=axes)
        var = ((x - mean) ** 2).mean(dim=axes)
        if "_stats" in p:
            p["_stats"][name] = (mean.detach(), var.detach())
    else:
        mean = p[f"{name}.running_mean"]
        var = p[f"{name}.running_var"]
    return (x - mean) / torch.sqrt(var + BN_EPS) * p[f"{name}.weight"] \
        + p[f"{name}.bias"]


def _trunk_max(p, pre, x, train, tf32):
    h = x
    for i in (1, 2, 3):
        h = _bn(p, f"{pre}.bn{i}", _linear(p, f"{pre}.conv{i}", h, tf32),
                train)
        if i < 3:
            h = torch.relu(h)
    return h.amax(dim=-2)


def forward(p: dict, x, *, train: bool = False, tf32: bool = False):
    """x (B, N, 3) -> log-probabilities (B, k). ``tf32``: every product in
    TF32 (the control)."""
    s = torch.relu(_trunk_max(p, "feat.stn", x, train, tf32))
    for fc, bn in (("fc1", "bn4"), ("fc2", "bn5")):
        s = torch.relu(_bn(p, f"feat.stn.{bn}",
                           _linear(p, f"feat.stn.{fc}", s, tf32), train))
    trans = _linear(p, "feat.stn.fc3", s, tf32).reshape(-1, 3, 3) \
        + torch.eye(3, dtype=x.dtype, device=x.device)
    g = _trunk_max(p, "feat", _mm(x, trans, tf32), train, tf32)
    for fc, bn in (("fc1", "bn1"), ("fc2", "bn2")):
        g = torch.relu(_bn(p, bn, _linear(p, fc, g, tf32), train))
    return torch.log_softmax(_linear(p, "fc3", g, tf32), dim=-1)


def forward_blocks(p: dict, x, block: int = 64, tf32: bool = False):
    """Eval-mode ``forward`` over blocks of rows, so that the (B, N, 1024)
    activations of a large batch never live at once."""
    return torch.cat([forward(p, x[i:i + block], tf32=tf32)
                      for i in range(0, x.shape[0], block)])
