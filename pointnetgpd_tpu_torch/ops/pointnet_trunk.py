"""Fused, BN-folded PointNet trunk: shared MLP + max over points (kernel K2).

Port of ``pointnetgpd_tpu/ops/pointnet_trunk_pallas.py``. The eval-mode MLP
3 -> 64 -> 128 -> 1024 with BatchNorm folded into the weights, ReLU after
layers 1 and 2, none after layer 3, then the max over the point axis
(reference PointNetGPD/model/pointnet.py:144-149).

In the port this carries every eval-mode trunk of this shape: the scorer's
forward and the trainer's eval pass; and, at 512 output channels
(``K2_WIDTHS``), each shard of a trunk whose conv3 rows are split over two
devices (``parallel/tp.py``): the max over points is per channel, so a
shard's trunk is the kernel on its rows. The STN3d trunk (whose ReLU after layer
3 commutes with the max) and the PointNetfeat trunk both go through
``fused_trunk``, which launches ``csrc/pointnet_trunk.cu`` for CUDA tensors
(or raises) and takes ``trunk_reference`` for CPU tensors. The kernel has no
backward (nor has the Pallas one): where autograd would need one,
``fused_trunk`` raises on either device.

The kernel runs layers 2 and 3 on the tensor cores in 3xTF32: every operand
is split into a TF32 big part and a TF32 small part (``tf32_split``, as
``cvt.rna.tf32.f32`` rounds), and a product is big*big + big*small +
small*big. The weights are split once, when BN is folded
(``fold_trunk_params`` returns a ``FoldedTrunk`` that carries them as
``tensor_core``); ``trunk_3xtf32`` is the kernel's arithmetic in plain
PyTorch, for the tests.
"""

from __future__ import annotations

import torch

from .. import _build
from .fp import sqrt

launches = 0             # kernel launches (CUDA path only)
# the kernel's output widths (template instances of csrc/pointnet_trunk.cu)
K2_WIDTHS = (512, 1024)

# layer 3's K axis within each group of 8 input channels, as the kernel's A
# fragments hold them (csrc/pointnet_trunk.cu): column j takes channel
# TF32_K_ORDER[j]
TF32_K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def fold_bn(w, b, scale, bias, mean, var, eps: float = 1e-5):
    """Fold eval-mode BN into a linear layer: y = (x @ W.T + b) -> BN."""
    gamma = scale / sqrt(var + eps)
    return w * gamma[:, None], (b - mean) * gamma + bias


def tf32_round(t):
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: ``cvt.rna.tf32.f32``."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(t):
    """(big, small) TF32 parts with t ~= big + small."""
    big = tf32_round(t)
    return big, tf32_round(t - big)


def _k3_order(device):
    k = torch.arange(128, device=device)
    return 8 * (k // 8) + torch.tensor(TF32_K_ORDER, device=device)[k % 8]


# output rows per block of the kernel's weight copies: all of w2, and w3 in
# chunks of 64 output channels (csrc/pointnet_trunk.cu NC)
W2_ROWS, W3_ROWS = 128, 64


def core_matrix_order(w, rows):
    """A K-major (R, K) matrix -> (R / rows, rows / 8, K / 4, 8, 4): each
    block of ``rows`` rows in wgmma's no-swizzle K-major layout, 8-row x
    4-value core matrices with the K-adjacent ones next to each other, so
    that one contiguous copy puts a block in shared memory as the kernel
    reads it."""
    r, k = w.shape
    return w.reshape(r // rows, rows // 8, 8, k // 4, 4).permute(
        0, 1, 3, 2, 4).contiguous()


def from_core_matrix_order(t):
    """Inverse of ``core_matrix_order``: -> (R, K)."""
    n_blocks, groups, k4, _, _ = t.shape
    return t.permute(0, 1, 3, 2, 4).reshape(n_blocks * groups * 8, k4 * 4)


def tensor_core_weights(folded):
    """The kernel's operands from a folded tuple: (w1 (C, 64), b1, w2 big,
    w2 small, b2, w3 big, w3 small, b3). The parts of w2 and w3 are K-major,
    the conv weight's (out, in) orientation, in ``core_matrix_order``; w3's
    K axis is in ``TF32_K_ORDER`` within each group of 8."""
    w1, b1, w2, b2, w3, b3 = (t.detach() for t in folded)
    w2b, w2s = (core_matrix_order(t, W2_ROWS)
                for t in tf32_split(w2.t().contiguous()))
    w3b, w3s = (core_matrix_order(t, W3_ROWS) for t in tf32_split(
        w3.t()[:, _k3_order(w3.device)].contiguous()))
    return (w1.contiguous(), b1.contiguous(), w2b, w2s, b2.contiguous(),
            w3b, w3s, b3.contiguous())


class FoldedTrunk(tuple):
    """(w1, b1, w2, b2, w3, b3) with weights (in, out), and beside them the
    kernel's split operands ``tensor_core`` (``tensor_core_weights``).
    ``requires_grad``: whether a tensor it was folded from requires a
    gradient."""

    def __new__(cls, tensors, requires_grad: bool = False):
        self = super().__new__(cls, tensors)
        self.tensor_core = tensor_core_weights(self)
        self.requires_grad = requires_grad
        return self


def fold_trunk_params(module):
    """A module with ``conv1..3`` (1x1 Conv1d) and ``bn1..3`` (STN3d or
    PointNetfeat) -> folded (w1, b1, w2, b2, w3, b3), weights transposed to
    (in, out), as a ``FoldedTrunk``. The fold is computed in float32 from
    the module's parameters whatever their dtype (a bf16 model's too): K2
    computes in float32."""
    out, grad = [], False
    for i in (1, 2, 3):
        conv, bn = getattr(module, f"conv{i}"), getattr(module, f"bn{i}")
        w, b = fold_bn(*(t.float() for t in (
            conv.weight[:, :, 0], conv.bias, bn.weight, bn.bias,
            bn.running_mean, bn.running_var)), bn.eps)
        out += [w.t().contiguous(), b.contiguous()]
        grad = grad or any(t.requires_grad for t in (conv.weight, conv.bias,
                                                     bn.weight, bn.bias))
    return FoldedTrunk(out, requires_grad=grad)


def trunk_reference(x, folded):
    """Plain version. x (B, N, C) -> (B, H3), any width H3."""
    w1, b1, w2, b2, w3, b3 = folded
    h = torch.relu(x @ w1 + b1)
    h = torch.relu(h @ w2 + b2)
    h = h @ w3 + b3
    return torch.amax(h, dim=1)


def trunk_3xtf32(x, folded):
    """The kernel's arithmetic in plain PyTorch: layer 1 in fp32; layers 2
    and 3 as the three TF32 products of the split operands (each product
    of two TF32 values is exact in fp32), w3's K axis in the kernel's order;
    b3 added after the max. x (B, N, C) -> (B, 1024)."""
    w1, b1, w2b, w2s, b2, w3b, w3s, b3 = folded.tensor_core
    w2b, w2s, w3b, w3s = map(from_core_matrix_order, (w2b, w2s, w3b, w3s))
    hb, hs = tf32_split(torch.relu(x @ w1 + b1))
    h = torch.relu(b2 + hs @ w2b.t() + hb @ w2s.t() + hb @ w2b.t())
    hb, hs = tf32_split(h[..., _k3_order(h.device)])
    h = hs @ w3b.t() + hb @ w3s.t() + hb @ w3b.t()
    return torch.amax(h, dim=1) + b3


def fused_trunk(x, folded):
    """x (B, N, C) post-STN points, folded from ``fold_trunk_params`` (a
    ``FoldedTrunk``) -> (B, H3) global features, H3 in ``K2_WIDTHS``. CUDA
    tensors launch the kernel. Raises where autograd would differentiate the result: the
    kernel has no backward, and its output would come back silently
    detached."""
    if torch.is_grad_enabled() and (
            x.requires_grad or getattr(folded, "requires_grad", False)
            or any(t.requires_grad for t in folded)):
        raise RuntimeError(
            "fused_trunk (kernel K2) has no backward: run an eval-mode "
            "forward under torch.no_grad(), or train mode to differentiate")
    if not x.is_cuda:
        return trunk_reference(x, folded)
    return _launch(x, folded)


def _launch(x, folded):
    global launches
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"x must be (B, N, C) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not isinstance(folded, FoldedTrunk):
        raise TypeError("the kernel takes the FoldedTrunk of "
                        "fold_trunk_params, which carries its split weights")
    bsz, n, c = x.shape
    w1, b1, w2b, w2s, b2, w3b, w3s, b3 = folded.tensor_core
    h3 = b3.shape[0]
    if h3 not in K2_WIDTHS:
        raise ValueError(f"the kernel's output widths are {K2_WIDTHS}, got "
                         f"{h3}")
    w2_shape, w3_shape = (1, 16, 16, 8, 4), (h3 // W3_ROWS, 8, 32, 8, 4)
    want = {"w1": (w1, (c, 64)), "b1": (b1, (64,)),
            "w2 big": (w2b, w2_shape), "w2 small": (w2s, w2_shape),
            "b2": (b2, (128,)), "w3 big": (w3b, w3_shape),
            "w3 small": (w3s, w3_shape), "b3": (b3, (h3,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")
    if not 1 <= c <= 8:
        raise ValueError(f"the kernel takes 1..8 input channels, got {c}")
    out = torch.empty((bsz, h3), dtype=torch.float32, device=x.device)
    if bsz == 0:
        return out
    if n == 0:
        raise ValueError("max over an empty point axis")
    x = x.contiguous()
    lib = _build.library()
    err = lib.pointnet_trunk_launch(
        x.data_ptr(), bsz, n, c, w1.data_ptr(), b1.data_ptr(),
        w2b.data_ptr(), w2s.data_ptr(), b2.data_ptr(), w3b.data_ptr(),
        w3s.data_ptr(), b3.data_ptr(), out.data_ptr(), h3,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "pointnet_trunk_launch")
    launches += 1
    return out
