"""PointNet grasp-quality classifier family, PyTorch.

Port of ``pointnetgpd_tpu/models/pointnet.py``: ``STN3d``, ``SimpleSTN3d``,
``PointNetfeat``, ``DualPointNetfeat``, ``PointNetCls``, ``DualPointNetCls``
and ``PointNetDenseCls`` are ``nn.Module``s with the reference's module
names and Conv1d shapes (reference PointNetGPD/model/pointnet.py:8-221), so
a reference state_dict loads with plain ``load_state_dict``. The public
forward takes channels-last ``(B, N, C)``, as the JAX API does, and
``fused_maxpool=`` as ``apply_pointnet_cls`` does.

Train mode runs the reference composition (linear -> BatchNorm on the batch
statistics -> ReLU, max over points), with the conv3 -> BN -> max stages
through ``fused_maxpool.matmul_bn_max`` when ``fused_maxpool``; it never
runs K2. Eval mode runs every trunk of K2's shape (C <= 8 -> 64 -> 128 ->
1024, or 512 for a tensor-parallel shard's) through ``ops.pointnet_trunk.fused_trunk`` (the hand-written CUDA
kernel on the card, its plain version on the CPU): the STN3d trunk as
``relu(max(.))`` (ReLU and max commute), the PointNetfeat and Dual trunks on
the transformed points. Each such trunk folds its BatchNorm into the weights
once and reuses the folded tuple until one of its tensors changes (an
optimizer step or a train forward bumps their versions); the tuple carries
the kernel's 3xTF32 split of the weights (``FoldedTrunk.tensor_core``). A
trunk of another shape (SimpleSTN3d's, 128 -> 256) runs plain torch in eval
mode, as in JAX. K2 has no backward: an eval forward that autograd would
differentiate raises (``fused_trunk``).

A model cast to bfloat16 (``GraspScorer.as_dtype``) still runs its trunks
through K2, which computes in float32: the fold is taken in float32 from the
bf16 parameters, the trunk's input is handed to K2 as float32 and the
(B, 1024) result cast back to bf16 (``_Trunk.k2_max``). The rest of the
model computes in bf16, as the JAX package's bf16 scorer does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pointnet_trunk import K2_WIDTHS, fold_trunk_params, fused_trunk
from .fused_maxpool import linear_bn_max
from .layers import linear, linear_bn_relu

# (conv widths, fc widths) of STN3d and SimpleSTN3d (ref pointnet.py:8-85)
_STN_DIMS = {
    "stn3d": ((64, 128, 1024), (512, 256)),
    "simple": ((64, 128, 256), (128, 64)),
}


class _Trunk(nn.Module):
    """A module with ``conv1..3`` and ``bn1..3``: a shared MLP whose third
    layer is max-pooled over the points."""

    _folded = None
    _folded_key = None

    def _trunk_modules(self):
        return [getattr(self, f"{kind}{i}") for i in (1, 2, 3)
                for kind in ("conv", "bn")]

    def folded_trunk(self):
        """The BN-folded trunk weights and their tensor-core split (a
        ``FoldedTrunk``), recomputed only when a tensor of the trunk was
        moved, reloaded, edited in place or switched in ``requires_grad``
        since the last fold (keyed on each tensor's storage, in-place
        version and flag)."""
        key = tuple((t.data_ptr(), t._version, t.requires_grad)
                    for m in self._trunk_modules()
                    for t in (*m.parameters(recurse=False),
                              *m.buffers(recurse=False)))
        if key != self._folded_key:
            with torch.no_grad():
                self._folded = fold_trunk_params(self)
            self._folded_key = key
        return self._folded

    def _on_k2(self) -> bool:
        return (self.conv1.in_channels <= 8 and self.conv2.in_channels == 64
                and self.conv3.in_channels == 128
                and self.conv3.out_channels in K2_WIDTHS)

    def k2_max(self, x):
        """The eval-mode trunk through K2: x (B, N, C) -> (B, C3) in x's
        dtype. K2 computes in float32, so a bf16 ``x`` goes in as float32
        (exact) and the result comes back rounded to bf16."""
        if x.dtype == torch.float32:
            return fused_trunk(x, self.folded_trunk())
        return fused_trunk(x.float(), self.folded_trunk()).to(x.dtype)

    def trunk_max(self, x, *, fused_maxpool: bool = False):
        """max over points of bn3(conv3(relu(bn2(conv2(relu(bn1(conv1 x)))))))
        (no ReLU after layer 3): (B, N, C) -> (B, C3). A trunk whose
        conv3 / bn3 ``parallel.tp`` split over mp devices hands itself to
        those shards."""
        shards = self._modules.get("tp_shards")
        if shards is not None:
            return shards(self, x, fused_maxpool=fused_maxpool)
        if not self.training and self._on_k2():
            return self.k2_max(x)
        h = linear_bn_relu(self.conv1, self.bn1, x, train=self.training)
        h = linear_bn_relu(self.conv2, self.bn2, h, train=self.training)
        return linear_bn_max(self.conv3, self.bn3, h, train=self.training,
                             fused=fused_maxpool)


class STN3d(_Trunk):
    """Input transform network (ref pointnet.py:8-45); ``kind="simple"``
    gives SimpleSTN3d's widths (ref :48-85)."""

    def __init__(self, input_chann: int = 3, kind: str = "stn3d"):
        super().__init__()
        (c1, c2, c3), (f1, f2) = _STN_DIMS[kind]
        self.conv1 = nn.Conv1d(input_chann, c1, 1)
        self.conv2 = nn.Conv1d(c1, c2, 1)
        self.conv3 = nn.Conv1d(c2, c3, 1)
        self.fc1 = nn.Linear(c3, f1)
        self.fc2 = nn.Linear(f1, f2)
        self.fc3 = nn.Linear(f2, 9)
        self.bn1 = nn.BatchNorm1d(c1)
        self.bn2 = nn.BatchNorm1d(c2)
        self.bn3 = nn.BatchNorm1d(c3)
        self.bn4 = nn.BatchNorm1d(f1)
        self.bn5 = nn.BatchNorm1d(f2)
        self.eval()

    def forward(self, x, fused_maxpool: bool = False):
        """x (B, N, C) -> (B, 3, 3) = fc(x) + I."""
        h = torch.relu(self.trunk_max(x, fused_maxpool=fused_maxpool))
        h = linear_bn_relu(self.fc1, self.bn4, h, train=self.training)
        h = linear_bn_relu(self.fc2, self.bn5, h, train=self.training)
        h = linear(self.fc3, h)
        return h.reshape(-1, 3, 3) + torch.eye(3, dtype=h.dtype,
                                               device=h.device)


class SimpleSTN3d(STN3d):
    def __init__(self, input_chann: int = 3):
        super().__init__(input_chann, kind="simple")


class PointNetfeat(_Trunk):
    """STN + shared MLP + max-pool global feature (ref pointnet.py:123-154);
    with ``global_feat=False`` the (B, N, 1088) per-point features of the
    dense head."""

    def __init__(self, input_chann: int = 3, global_feat: bool = True):
        super().__init__()
        self.global_feat = global_feat
        self.stn = STN3d(input_chann)
        self.conv1 = nn.Conv1d(input_chann, 64, 1)
        self.conv2 = nn.Conv1d(64, 128, 1)
        self.conv3 = nn.Conv1d(128, 1024, 1)
        self.bn1 = nn.BatchNorm1d(64)
        self.bn2 = nn.BatchNorm1d(128)
        self.bn3 = nn.BatchNorm1d(1024)
        self.eval()

    def forward(self, x, fused_maxpool: bool = False):
        """x (B, N, C) -> (global (B, 1024) or (B, N, 1088), trans)."""
        trans = self.stn(x, fused_maxpool=fused_maxpool and self.global_feat)
        x = torch.bmm(x, trans)
        if self.global_feat:
            return self.trunk_max(x, fused_maxpool=fused_maxpool), trans
        pointfeat = linear_bn_relu(self.conv1, self.bn1, x,
                                   train=self.training)
        if not self.training and self._on_k2():
            g = self.k2_max(x)
        else:
            h = linear_bn_relu(self.conv2, self.bn2, pointfeat,
                               train=self.training)
            g = linear_bn_max(self.conv3, self.bn3, h, train=self.training,
                              fused=False)
        g = g[:, None, :].expand(-1, pointfeat.shape[1], -1)
        return torch.cat([g, pointfeat], dim=-1), trans


class DualPointNetfeat(_Trunk):
    """Two SimpleSTN3d on channels 0:3 and 3:6, then the shared MLP on the
    concatenation (ref pointnet.py:88-120)."""

    def __init__(self, input_chann: int = 6):
        super().__init__()
        self.stn1 = SimpleSTN3d(input_chann // 2)
        self.stn2 = SimpleSTN3d(input_chann // 2)
        self.conv1 = nn.Conv1d(input_chann, 64, 1)
        self.conv2 = nn.Conv1d(64, 128, 1)
        self.conv3 = nn.Conv1d(128, 1024, 1)
        self.bn1 = nn.BatchNorm1d(64)
        self.bn2 = nn.BatchNorm1d(128)
        self.bn3 = nn.BatchNorm1d(1024)
        self.eval()

    def forward(self, x, fused_maxpool: bool = False):
        """x (B, N, 6) -> (global (B, 1024), trans1 + trans2)."""
        trans1 = self.stn1(x[..., 0:3], fused_maxpool=fused_maxpool)
        trans2 = self.stn2(x[..., 3:6], fused_maxpool=fused_maxpool)
        x = torch.cat([torch.bmm(x[..., 0:3], trans1),
                       torch.bmm(x[..., 3:6], trans2)], dim=-1)
        return self.trunk_max(x, fused_maxpool=fused_maxpool), trans1 + trans2


class _ClsHead(nn.Module):
    def _head(self, feat):
        h = linear_bn_relu(self.fc1, self.bn1, feat, train=self.training)
        h = linear_bn_relu(self.fc2, self.bn2, h, train=self.training)
        return F.log_softmax(linear(self.fc3, h), dim=-1)

    def _init_head(self, k: int):
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, k)
        self.bn1 = nn.BatchNorm1d(512)
        self.bn2 = nn.BatchNorm1d(256)

    @property
    def k(self) -> int:
        return self.fc3.out_features

    def forward(self, x, fused_maxpool: bool = False):
        """x (B, N, C) -> (log_probs (B, k), trans (B, 3, 3))."""
        feat, trans = self.feat(x, fused_maxpool=fused_maxpool)
        return self._head(feat), trans


class PointNetCls(_ClsHead):
    """Classifier head on the global feature (ref pointnet.py:177-194)."""

    def __init__(self, num_points: int = 500, input_chann: int = 3,
                 k: int = 2):
        super().__init__()
        self.num_points = num_points
        self.feat = PointNetfeat(input_chann)
        self._init_head(k)
        self.eval()


class DualPointNetCls(_ClsHead):
    """Classifier on the dual-STN global feature (ref pointnet.py:157-174)."""

    def __init__(self, num_points: int = 500, input_chann: int = 6,
                 k: int = 2):
        super().__init__()
        self.num_points = num_points
        self.feat = DualPointNetfeat(input_chann)
        self._init_head(k)
        self.eval()


class PointNetDenseCls(nn.Module):
    """Per-point segmentation head on [global | point] features (ref
    pointnet.py:197-221)."""

    def __init__(self, num_points: int = 500, input_chann: int = 3,
                 k: int = 2):
        super().__init__()
        self.num_points = num_points
        self.feat = PointNetfeat(input_chann, global_feat=False)
        self.conv1 = nn.Conv1d(1088, 512, 1)
        self.conv2 = nn.Conv1d(512, 256, 1)
        self.conv3 = nn.Conv1d(256, 128, 1)
        self.conv4 = nn.Conv1d(128, k, 1)
        self.bn1 = nn.BatchNorm1d(512)
        self.bn2 = nn.BatchNorm1d(256)
        self.bn3 = nn.BatchNorm1d(128)
        self.eval()

    @property
    def k(self) -> int:
        return self.conv4.out_channels

    def forward(self, x):
        """x (B, N, C) -> (per-point log_probs (B, N, k), trans)."""
        h, trans = self.feat(x)
        for i in (1, 2, 3):
            h = linear_bn_relu(getattr(self, f"conv{i}"),
                               getattr(self, f"bn{i}"), h, train=self.training)
        return F.log_softmax(linear(self.conv4, h), dim=-1), trans


@torch.no_grad()
def pointnet_cls_infer(model, x):
    """Eval-mode forward: x (B, N, C) -> (log_probs (B, k), trans)."""
    return model(x)
