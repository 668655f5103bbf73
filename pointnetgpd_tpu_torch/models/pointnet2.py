"""PointNet++ single-scale-grouping classifier (Qi et al., arXiv:1706.02413).

Widths of ``charlesq34/pointnet2`` ``models/pointnet2_cls_ssg.py``, on
channels-last ``(B, N, 3)`` crops as the port's other models take them:

- SA1: farthest-point sampling of 512 centroids, a ball query of radius 0.2
  keeping 32 points, the grouped points centred on their centroid
  (3 channels), a shared MLP 3 -> 64 -> 64 -> 128, max over the 32;
- SA2: 128 centroids of SA1's 512, radius 0.4, 64 points, the centred xyz
  and SA1's features (131 channels), MLP 131 -> 128 -> 128 -> 256, max;
- SA3 (group all): the uncentred xyz and the features (259 channels), MLP
  259 -> 256 -> 512 -> 1024, max over all 128 points;
- the head of ``PointNetCls`` (``_ClsHead``): 1024 -> 512 -> 256 -> k with
  log-softmax.

Every MLP layer is linear -> BatchNorm -> ReLU (``layers.linear_bn_relu``:
in train mode the batch statistics over every axis but the channel axis).
The published head's dropout is left out, as the port's trainer builds
``GPDClassifier`` without its own. The model's first operation scales the
crop by ``XYZ_SCALE``, one float32 constant: the reciprocal of the training
crop box's half-diagonal at the 0.08 m grasp width (half extents w/4, w/2,
w/4), which puts the crop inside the unit ball that the published radii
assume, as ModelNet's unit-sphere clouds are.

Sampling and grouping indices come from ``ops/pointnet2_sample.py`` (K7 on
the card, its plain version on the CPU); the grouping itself, the centring
and the gathers are plain torch, so autograd differentiates them (SA2's
gather of SA1's features backward is a scatter-add). Spans: ``pn2.fps``
around each sampling, ``pn2.group`` around each ball query, gather and
centring; K7 opens ``pn2.kernel`` inside them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import pointnet2_sample as sample
from ..utils.profiling import span
from .layers import linear_bn_relu
from .pointnet import _ClsHead

# the crop box's half-diagonal at the 0.08 m grasp width: half extents
# (w/4, w/2, w/4), so w * sqrt(1/16 + 1/4 + 1/16)
XYZ_SCALE = 1.0 / (0.08 * math.sqrt(0.375))

# (npoint, radius, nsample, MLP widths) of SA1 and SA2; SA3 groups all
SSG_LAYERS = ((512, 0.2, 32, (64, 64, 128)),
              (128, 0.4, 64, (128, 128, 256)),
              (None, None, None, (256, 512, 1024)))


def _gather(points, idx):
    """points (B, N, C), idx (B, ...) int64 -> (B, ..., C)."""
    rows = torch.arange(points.shape[0], device=points.device)
    return points[rows.view((-1,) + (1,) * (idx.dim() - 1)), idx]


class SetAbstraction(nn.Module):
    """One set-abstraction level: sample ``npoint`` centroids, group up to
    ``nsample`` points within ``radius`` of each (or every point, where
    ``npoint`` is None), run the shared MLP, max over each group."""

    def __init__(self, npoint, radius, nsample, in_chann: int, widths):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        dims = (in_chann + 3,) + tuple(widths)
        self.mlp_convs = nn.ModuleList(nn.Conv1d(a, b, 1)
                                       for a, b in zip(dims[:-1], dims[1:]))
        self.mlp_bns = nn.ModuleList(nn.BatchNorm1d(b) for b in widths)

    def forward(self, xyz, feats):
        """xyz (B, N, 3), feats (B, N, C) or None -> (centroids (B, S, 3)
        or None, features (B, S, widths[-1]) or (B, widths[-1]))."""
        if self.npoint is None:
            centroids = None
            h = xyz if feats is None else torch.cat([xyz, feats], dim=-1)
        else:
            with span("pn2.fps"):
                picked = sample.farthest_point_sample(xyz, self.npoint)
            with span("pn2.group"):
                centroids = _gather(xyz, picked)
                idx = sample.ball_query(xyz, centroids, self.radius,
                                        self.nsample)
                h = _gather(xyz, idx) - centroids[:, :, None]
                if feats is not None:
                    h = torch.cat([h, _gather(feats, idx)], dim=-1)
        for conv, bn in zip(self.mlp_convs, self.mlp_bns):
            h = linear_bn_relu(conv, bn, h, train=self.training)
        return centroids, h.amax(dim=-2)


class PointNet2SSGfeat(nn.Module):
    """SA1, SA2 and SA3 of the SSG classifier: (B, N, 3) -> (B, 1024)."""

    def __init__(self):
        super().__init__()
        chann = 0
        for i, (npoint, radius, nsample, widths) in enumerate(SSG_LAYERS):
            setattr(self, f"sa{i + 1}", SetAbstraction(
                npoint, radius, nsample, chann, widths))
            chann = widths[-1]

    def forward(self, x):
        xyz = x * XYZ_SCALE
        xyz, feats = self.sa1(xyz, None)
        xyz, feats = self.sa2(xyz, feats)
        return self.sa3(xyz, feats)[1]


class PointNet2ClsSSG(_ClsHead):
    """PointNet++ SSG classifier with ``PointNetCls``'s head; the forward
    returns ``(log_probs (B, k), None)`` as the PointNet models return
    ``(log_probs, trans)``."""

    def __init__(self, k: int = 2):
        super().__init__()
        self.feat = PointNet2SSGfeat()
        self._init_head(k)
        self.eval()

    def forward(self, x, fused_maxpool: bool = False):
        """x (B, N, 3) -> (log_probs (B, k), None)."""
        if fused_maxpool:
            raise ValueError("PointNet2ClsSSG has no fused max-pool stage")
        return self._head(self.feat(x)), None
