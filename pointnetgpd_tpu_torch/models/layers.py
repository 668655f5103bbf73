"""Layer helpers with the JAX package's channels-last semantics.

Port of ``pointnetgpd_tpu/models/layers.py``, eval mode only (training comes
in a later slice). The modules themselves are ``torch.nn`` Conv1d, Linear and
BatchNorm1d under the reference's names, so reference state_dicts load with
plain ``load_state_dict`` (BatchNorm eps 1e-5, torch's default); these
functions apply them to channels-last ``(..., C)`` activations the way the
JAX functions do.
"""

from __future__ import annotations

import torch
from torch import nn


def linear(layer, x):
    """1x1 Conv1d or Linear on channels-last x: (..., Cin) -> (..., Cout)."""
    w = layer.weight
    if w.dim() == 3:           # Conv1d (O, I, 1)
        w = w[:, :, 0]
    return x @ w.t() + layer.bias


def batchnorm_eval(bn: nn.BatchNorm1d, x):
    """Eval-mode BatchNorm over the last (channel) axis, in the JAX order
    ``(x - mean) * rsqrt(var + eps) * scale + bias``."""
    y = (x - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
    return y * bn.weight + bn.bias


def linear_bn_relu(layer, bn, x):
    return torch.relu(batchnorm_eval(bn, linear(layer, x)))
