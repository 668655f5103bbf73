"""Tensor-parallel (dp, mp) layout of PointNetCls.

Port of ``pointnetgpd_tpu/parallel/tp.py``. The model is small, so data
parallelism is the production layout; this layout shards the wide layers'
feature axis over ``mp`` (a Megatron pair):

- ``feat.conv3`` and ``feat.stn.conv3`` (1024 x 128): output rows over mp,
  with their ``bn3`` (parameters and running statistics), so each shard's
  trunk ends in 1024 / mp channels and its max over points stays sharded;
- ``fc1`` (512 x 1024): input columns over mp, so fc1 is the sum of the
  shards' partial products;
- everything else replicated; the batch over dp.

Layout of the port: dp across processes (``Trainer(n_devices=)``, one rank
each), mp over a device list within each process. The JAX package's
(dp=4, mp=2) is 4 ranks of a (1, 2) mesh; ``make_2d_mesh(8, mp=2)`` in one
process is 4 rows of 2 shards, whose rows split the batch in eval mode
(rows after the first are eval copies made when sharding).

``shard_params_tp(model, mesh)`` gives a ``TensorParallelPointNetCls``:
per dp row, a copy of the model on the row's first device that runs the
model's own forward, with only the sharded layers swapped in. Each trunk's
conv3 / bn3 becomes ``_TrunkShards`` (``_Trunk.trunk_max`` hands it the
trunk): in eval mode each shard runs the whole trunk through K2 at
1024 / mp rows (the 512-row instance at mp = 2; ``ops/pointnet_trunk.py``),
in train mode layers 1-2 run once and each shard's conv3 -> BatchNorm ->
max on its own device (K2 has no backward); the shards' pooled features
are concatenated on the row's first device. ``fc1`` becomes
``_ColumnShards``, the sum of the shards' partial products gathered there.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from types import SimpleNamespace

import torch
from torch import nn

from ..models.fused_maxpool import linear_bn_max
from ..models.layers import linear_bn_relu
from ..ops.pointnet_trunk import (K2_WIDTHS, FoldedTrunk, fold_trunk_params,
                                  fused_trunk)
from .mesh import make_mesh, on_device


@dataclass(frozen=True)
class Mesh2D:
    """Rows (dp) of devices, each row's devices one per mp shard."""

    devices: tuple

    @property
    def shape(self):
        return len(self.devices), len(self.devices[0])


def make_2d_mesh(n_devices: int | None = None, mp: int = 2,
                 device="cuda") -> Mesh2D:
    """(n / mp, mp) devices of ``make_mesh(n_devices, device)``."""
    flat = make_mesh(n_devices, device).devices
    if len(flat) % mp:
        raise ValueError(f"{len(flat)} devices not divisible by mp={mp}")
    return Mesh2D(tuple(tuple(flat[i:i + mp])
                        for i in range(0, len(flat), mp)))


def _sharded_rows(name: str) -> bool:
    parts = name.split(".")
    return parts[0] == "feat" and ("conv3" in parts or "bn3" in parts)


def tp_param_shardings(model) -> dict:
    """Per parameter and buffer name of a PointNetCls, its layout as one
    entry per dimension (``"mp"`` where that dimension is split, else
    None); ``()`` is replicated. The conv3 / fc1 Megatron pair over mp, as
    the JAX package's ``tp_param_shardings``."""
    out = {}
    for name, t in list(model.named_parameters()) + \
            list(model.named_buffers()):
        if _sharded_rows(name) and t.dim() >= 1:
            out[name] = ("mp",) + (None,) * (t.dim() - 1)
        elif name == "fc1.weight":
            out[name] = (None, "mp")
        else:
            out[name] = ()
    return out


def _fold_shard(pre, conv3, bn3, device):
    """The folded trunk of layers 1-2 of ``pre`` and one conv3 / bn3 shard,
    on ``device``."""
    f = fold_trunk_params(SimpleNamespace(
        conv1=pre.conv1, bn1=pre.bn1, conv2=pre.conv2, bn2=pre.bn2,
        conv3=conv3, bn3=bn3))
    return FoldedTrunk([t.to(device) for t in f],
                       requires_grad=f.requires_grad)


class _TrunkShards(nn.Module):
    """The mp shards of one trunk's conv3 and bn3, each on its device."""

    def __init__(self, trunk, devices):
        super().__init__()
        mp = len(devices)
        c3 = trunk.conv3.out_channels
        if c3 % mp:
            raise ValueError(f"{c3} channels do not split over mp={mp}")
        w = c3 // mp
        self.devices = tuple(devices)
        self.conv3, self.bn3 = nn.ModuleList(), nn.ModuleList()
        for j, d in enumerate(devices):
            sl = slice(j * w, (j + 1) * w)
            conv = nn.Conv1d(trunk.conv3.in_channels, w, 1)
            bn = nn.BatchNorm1d(w, eps=trunk.bn3.eps,
                                momentum=trunk.bn3.momentum)
            with torch.no_grad():
                conv.weight.copy_(trunk.conv3.weight[sl])
                conv.bias.copy_(trunk.conv3.bias[sl])
                for n in ("weight", "bias", "running_mean", "running_var"):
                    getattr(bn, n).copy_(getattr(trunk.bn3, n)[sl])
                bn.num_batches_tracked.copy_(trunk.bn3.num_batches_tracked)
            self.conv3.append(conv.to(d))
            self.bn3.append(bn.to(d))
        self._folded = [None] * mp
        self._keys = [None] * mp

    def folded(self, pre, j):
        """Shard j's folded trunk, refolded when one of its tensors moved."""
        key = tuple((t.data_ptr(), t._version, t.requires_grad)
                    for m in (pre.conv1, pre.bn1, pre.conv2, pre.bn2,
                              self.conv3[j], self.bn3[j])
                    for t in (*m.parameters(recurse=False),
                              *m.buffers(recurse=False)))
        if key != self._keys[j]:
            with torch.no_grad():
                self._folded[j] = _fold_shard(pre, self.conv3[j], self.bn3[j],
                                              self.devices[j])
            self._keys[j] = key
        return self._folded[j]

    def forward(self, trunk, x, *, fused_maxpool: bool = False):
        """The trunk's max over points (layers 1-2 of ``trunk``, then each
        shard's conv3 -> bn3 -> max) on x (B, N, C): (B, C3), the shards'
        features concatenated on x's device. Eval mode: each shard's whole
        trunk through K2."""
        if not trunk.training and trunk.conv1.in_channels <= 8 \
                and self.conv3[0].out_channels in K2_WIDTHS:
            outs = []
            for j, d in enumerate(self.devices):
                with on_device(d):
                    outs.append(fused_trunk(x.to(d).float(),
                                            self.folded(trunk, j)))
        else:
            h = linear_bn_relu(trunk.conv1, trunk.bn1, x, train=trunk.training)
            h = linear_bn_relu(trunk.conv2, trunk.bn2, h, train=trunk.training)
            outs = [linear_bn_max(self.conv3[j], self.bn3[j], h.to(d),
                                  train=trunk.training, fused=fused_maxpool)
                    for j, d in enumerate(self.devices)]
        return torch.cat([o.to(x.device) for o in outs], dim=-1).to(x.dtype)


class _ColumnShards(nn.Module):
    """A Linear whose input columns are split over the mp devices: the sum
    of the shards' partial products, gathered on the first device."""

    def __init__(self, fc, devices):
        super().__init__()
        cols = fc.in_features // len(devices)
        self.devices = tuple(devices)
        self.weight = nn.ParameterList([nn.Parameter(
            fc.weight.detach()[:, j * cols:(j + 1) * cols].clone().to(d))
            for j, d in enumerate(devices)])
        self.bias = nn.Parameter(fc.bias.detach().clone().to(devices[0]))

    def forward(self, x):
        cols = x.shape[-1] // len(self.devices)
        return sum((x[..., j * cols:(j + 1) * cols].to(d) @ w.t()).to(x.device)
                   for j, (d, w) in enumerate(zip(self.devices,
                                                  self.weight))) + self.bias


def _shard_row(model, devices):
    """A copy of ``model`` on ``devices[0]`` with its conv3 / bn3 stages and
    fc1 over the mp ``devices``."""
    row = copy.deepcopy(model).to(devices[0])
    for trunk in (row.feat.stn, row.feat):
        trunk.tp_shards = _TrunkShards(trunk, devices)
        del trunk.conv3, trunk.bn3
    row.fc1 = _ColumnShards(row.fc1, devices)
    return row


class TensorParallelPointNetCls(nn.Module):
    """PointNetCls over a ``Mesh2D``: forward(x (B, N, C), fused_maxpool)
    -> (log_probs, trans) on the mesh's first device. Eval mode splits the
    batch over the dp rows; train mode needs one row (dp across
    processes)."""

    def __init__(self, model, mesh: Mesh2D):
        super().__init__()
        self.mesh = mesh
        self.rows = nn.ModuleList([_shard_row(model, r)
                                   for r in mesh.devices])

    def forward(self, x, fused_maxpool: bool = False):
        if self.training and len(self.rows) > 1:
            raise RuntimeError("a tensor-parallel module trains on one dp "
                               "row; data parallelism runs across processes")
        dev0 = self.mesh.devices[0][0]
        if len(self.rows) == 1:
            return self.rows[0](x.to(dev0), fused_maxpool)
        outs = [row(c.to(r[0]), fused_maxpool) for row, r, c in
                zip(self.rows, self.mesh.devices, x.chunk(len(self.rows)))]
        return (torch.cat([o[0].to(dev0) for o in outs]),
                torch.cat([o[1].to(dev0) for o in outs]))

    def full_state_dict(self, grads: bool = False) -> dict:
        """The unsharded PointNetCls state dict (of the first row), on the
        CPU: the shards concatenated back. ``grads``: the parameters'
        gradients in the same layout (parameters only)."""
        row = self.rows[0]
        named = list(row.named_parameters())
        if not grads:
            named += list(row.named_buffers())
        out, parts = {}, {}
        for name, t in named:
            v = t.grad if grads else t
            v = None if v is None else v.detach().cpu()
            if ".tp_shards." in name:   # {trunk}.tp_shards.{kind}.{j}.{n}
                trunk, rest = name.split(".tp_shards.")
                kind, _, n = rest.split(".")
                parts.setdefault(f"{trunk}.{kind}.{n}", []).append(v)
            elif name.startswith("fc1.weight."):
                parts.setdefault("fc1.weight", []).append(v)
            else:
                out[name] = v
        for name, vs in parts.items():
            out[name] = (vs[0] if name.endswith("num_batches_tracked") else
                         torch.cat(vs, dim=1 if name == "fc1.weight" else 0))
        return out


def shard_params_tp(model, mesh: Mesh2D) -> TensorParallelPointNetCls:
    """``model`` (a PointNetCls) in the TP layout of ``mesh``; it keeps the
    model's train or eval mode."""
    return TensorParallelPointNetCls(model, mesh).train(model.training)
