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
with TF32 off for their own duration (``torch.backends.cudnn.flags``), and
no global flag is set.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _no_tf32():
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


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
        with _no_tf32():
            x = F.max_pool2d(self.conv1(x), 2)
            x = F.max_pool2d(self.conv2(x), 2)
        x = torch.relu(self.fc1(x.reshape(x.shape[0], -1)))
        if self.dropout and self.training:
            if draws is None:
                raise ValueError("dropout in train mode needs draws")
            x = torch.where(draws.dropout_keep(x.shape).to(x.device),
                            x / 0.5, 0.0)
        return F.log_softmax(self.fc2(x), dim=-1)
