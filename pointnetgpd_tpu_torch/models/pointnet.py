"""PointNet grasp-quality classifier (eval mode), PyTorch.

Port of ``pointnetgpd_tpu/models/pointnet.py``: ``STN3d``, ``PointNetfeat``
and ``PointNetCls`` are ``nn.Module``s with the reference's module names and
Conv1d shapes (reference PointNetGPD/model/pointnet.py:8-45, 123-194), so a
reference state_dict loads with plain ``load_state_dict``. The public forward
takes channels-last ``(B, N, C)``, as the JAX API does.

Both shared-MLP trunks run through ``ops.pointnet_trunk.fused_trunk`` (the
hand-written CUDA kernel on the card, its plain version on the CPU): the
STN3d trunk as ``relu(max(.))`` (ReLU and max commute) and the PointNetfeat
trunk on ``x @ trans``. Each trunk folds its BatchNorm into the weights once
and reuses the folded tuple until one of its parameters or buffers changes;
the tuple carries beside it the kernel's 3xTF32 split of the weights
(``FoldedTrunk.tensor_core``), made in the same fold.
The FC heads and the 3x3 ``bmm`` stay plain torch.
``DualPointNetCls`` and ``PointNetDenseCls`` come in a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pointnet_trunk import fold_trunk_params, fused_trunk
from .layers import linear, linear_bn_relu


class _EvalOnly(nn.Module):
    def train(self, mode: bool = True):
        if mode:
            raise NotImplementedError(
                "the port's PointNet is eval-only in this slice")
        return super().train(False)


class _Trunk(_EvalOnly):
    """A module with ``conv1..3`` and ``bn1..3`` whose shared MLP runs
    through ``fused_trunk``."""

    _folded = None
    _folded_key = None

    def folded_trunk(self):
        """The BN-folded trunk weights and their tensor-core split (a
        ``FoldedTrunk``), recomputed only when a tensor of the trunk was
        moved, reloaded or edited in place since the last fold (keyed on
        each tensor's storage and in-place version)."""
        mods = [getattr(self, f"{kind}{i}") for i in (1, 2, 3)
                for kind in ("conv", "bn")]
        key = tuple((t.data_ptr(), t._version) for m in mods
                    for t in (*m.parameters(recurse=False),
                              *m.buffers(recurse=False)))
        if key != self._folded_key:
            with torch.no_grad():
                self._folded = fold_trunk_params(self)
            self._folded_key = key
        return self._folded


class STN3d(_Trunk):
    """Input transform network (ref pointnet.py:8-45)."""

    def __init__(self, input_chann: int = 3):
        super().__init__()
        self.conv1 = nn.Conv1d(input_chann, 64, 1)
        self.conv2 = nn.Conv1d(64, 128, 1)
        self.conv3 = nn.Conv1d(128, 1024, 1)
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, 9)
        self.bn1 = nn.BatchNorm1d(64)
        self.bn2 = nn.BatchNorm1d(128)
        self.bn3 = nn.BatchNorm1d(1024)
        self.bn4 = nn.BatchNorm1d(512)
        self.bn5 = nn.BatchNorm1d(256)
        self.eval()

    def forward(self, x):
        """x (B, N, C) -> (B, 3, 3) = fc(x) + I."""
        h = torch.relu(fused_trunk(x, self.folded_trunk()))
        h = linear_bn_relu(self.fc1, self.bn4, h)
        h = linear_bn_relu(self.fc2, self.bn5, h)
        h = linear(self.fc3, h)
        return h.reshape(-1, 3, 3) + torch.eye(3, dtype=h.dtype,
                                               device=h.device)


class PointNetfeat(_Trunk):
    """STN + shared MLP + max-pool global feature (ref pointnet.py:123-154)."""

    def __init__(self, input_chann: int = 3):
        super().__init__()
        self.stn = STN3d(input_chann)
        self.conv1 = nn.Conv1d(input_chann, 64, 1)
        self.conv2 = nn.Conv1d(64, 128, 1)
        self.conv3 = nn.Conv1d(128, 1024, 1)
        self.bn1 = nn.BatchNorm1d(64)
        self.bn2 = nn.BatchNorm1d(128)
        self.bn3 = nn.BatchNorm1d(1024)
        self.eval()

    def forward(self, x):
        """x (B, N, C) -> (global (B, 1024), trans (B, 3, 3))."""
        trans = self.stn(x)
        x = torch.bmm(x, trans)
        return fused_trunk(x, self.folded_trunk()), trans


class PointNetCls(_EvalOnly):
    """Classifier head on the global feature (ref pointnet.py:177-194)."""

    def __init__(self, num_points: int = 500, input_chann: int = 3,
                 k: int = 2):
        super().__init__()
        self.num_points = num_points
        self.feat = PointNetfeat(input_chann)
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, k)
        self.bn1 = nn.BatchNorm1d(512)
        self.bn2 = nn.BatchNorm1d(256)
        self.eval()

    @property
    def k(self) -> int:
        return self.fc3.out_features

    def forward(self, x):
        """x (B, N, C) -> (log_probs (B, k), trans (B, 3, 3))."""
        feat, trans = self.feat(x)
        h = linear_bn_relu(self.fc1, self.bn1, feat)
        h = linear_bn_relu(self.fc2, self.bn2, h)
        h = linear(self.fc3, h)
        return F.log_softmax(h, dim=-1), trans


@torch.no_grad()
def pointnet_cls_infer(model: PointNetCls, x):
    """Eval-mode forward: x (B, N, C) -> (log_probs (B, k), trans)."""
    return model(x)
