"""GPD baseline classifier: LeNet-style CNN on 60x60 projection images.

Port of ``pointnetgpd_tpu/models/gpd.py`` (reference
PointNetGPD/model/gpd.py:5-31) with the reference's module names, so its
state_dict loads with plain ``load_state_dict``: Conv2d(C -> 20, 5x5) ->
maxpool 2x2 -> Conv2d(20 -> 50, 5x5) -> maxpool 2x2 -> Linear(7200 -> 500) ->
ReLU [-> dropout 0.5] -> Linear(500 -> 2) -> log_softmax, with no activation
between conv and pool (the reference's quirk). The public forward takes
NHWC images, as the JAX API does, and flattens in the reference's NCHW
order.

cuDNN runs float32 convolutions in TF32 by default; the convolutions here run
with TF32 off for their own duration (``torch.backends.cudnn.flags``), in the
forward and in the backward alike (``_StrictConv2d``: autograd runs the
backward later, outside any context the forward entered), and no global
flag is set.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _no_tf32():
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class _StrictConv2d(torch.autograd.Function):
    """A 2-D convolution at the given stride, padding, dilation and groups
    whose forward and backward both run with cuDNN's TF32 off."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation, groups):
        ctx.save_for_backward(x, weight)
        ctx.conv = (stride, padding, dilation, groups)
        with _no_tf32():
            return F.conv2d(x, weight, bias, stride, padding, dilation,
                            groups)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conv
        with _no_tf32():
            grads = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]], stride, padding,
                dilation, False, [0] * len(stride), groups,
                list(ctx.needs_input_grad[:3]))
        return (*grads, None, None, None, None)


def _conv(x, conv: nn.Conv2d):
    """``conv`` applied by ``_StrictConv2d``, with the module's own
    settings."""
    if isinstance(conv.padding, str) or conv.padding_mode != "zeros":
        raise NotImplementedError("strict convolutions take numeric zero "
                                  "padding")
    return _StrictConv2d.apply(x, conv.weight, conv.bias, list(conv.stride),
                               list(conv.padding), list(conv.dilation),
                               conv.groups)


class GPDClassifier(nn.Module):
    def __init__(self, input_chann: int = 3, dropout: bool = False):
        super().__init__()
        self.dropout = dropout
        self.conv1 = nn.Conv2d(input_chann, 20, 5)
        self.conv2 = nn.Conv2d(20, 50, 5)
        self.fc1 = nn.Linear(12 * 12 * 50, 500)
        self.fc2 = nn.Linear(500, 2)
        self.eval()

    def forward(self, x, draws=None):
        """x (B, 60, 60, C) NHWC -> log_probs (B, 2). In train mode with
        ``dropout``, the keep mask comes from ``draws.dropout_keep``."""
        x = x.permute(0, 3, 1, 2)
        x = F.max_pool2d(_conv(x, self.conv1), 2)
        x = F.max_pool2d(_conv(x, self.conv2), 2)
        x = torch.relu(self.fc1(x.reshape(x.shape[0], -1)))
        if self.dropout and self.training:
            if draws is None:
                raise ValueError("dropout in train mode needs draws")
            x = torch.where(draws.dropout_keep(x.shape).to(x.device),
                            x / 0.5, 0.0)
        return F.log_softmax(self.fc2(x), dim=-1)
