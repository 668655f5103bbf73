"""Carry weights into the port's modules.

- ``state_dict_from_jax(params, state)``: the JAX package's param/state
  pytrees (as numpy arrays) -> the port's state_dict, for every model of
  the family (PointNetCls, DualPointNetCls, PointNetDenseCls, GPDClassifier).
  Rules mirror ``pointnetgpd_tpu/models/convert.py`` in reverse: ``w``
  (O, I) of a ``conv*`` layer -> Conv1d ``weight`` (O, I, 1), ``w`` (H, W,
  I, O) of a Conv2d -> ``weight`` (O, I, H, W), of a Linear -> ``weight``;
  ``b`` -> ``bias``; BN params ``scale``/``bias`` -> ``weight``/``bias``; BN
  state ``mean``/``var`` -> ``running_mean``/``running_var``.
- ``load_reference_checkpoint(path)``: a reference checkpoint — a pickled
  whole module (``torch.save(model)``, reference PointNetGPD/main_1v.py:178),
  a plain state_dict, an ``.npz`` of one, or a training checkpoint
  directory of the port (``training/checkpoint.py``) — as a state_dict.
- ``pointnet_cls_from_state_dict``: build a ``PointNetCls`` sized from it,
  or a ``DualPointNetCls`` for a dual state dict (two SimpleSTN3d,
  ``feat.stn1``/``feat.stn2``), the JAX package's ``dual=True`` model.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .pointnet import DualPointNetCls, PointNetCls

MODEL_FILE = "model.pt"    # the state_dict inside a training checkpoint


def state_dict_from_jax(params, state) -> dict:
    """JAX (params, state) nested dicts of arrays -> torch state_dict."""
    sd = {}

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))

    def walk(p_node, prefix):
        for name, leaf in p_node.items():
            if isinstance(leaf, dict):
                walk(leaf, prefix + (name,))
                continue
            layer = ".".join(prefix)
            if name == "w":
                w = tensor(leaf)
                if w.dim() == 4:                   # Conv2d HWIO -> OIHW
                    w = w.permute(3, 2, 0, 1).contiguous()
                elif prefix[-1].startswith("conv"):
                    w = w[:, :, None]
                sd[f"{layer}.weight"] = w
            elif name == "b":
                sd[f"{layer}.bias"] = tensor(leaf)
            elif name == "scale":
                sd[f"{layer}.weight"] = tensor(leaf)
            elif name == "bias":
                sd[f"{layer}.bias"] = tensor(leaf)
            else:
                raise ValueError(f"unrecognized param leaf {layer}.{name}")

    def walk_state(s_node, prefix):
        for name, leaf in s_node.items():
            if isinstance(leaf, dict):
                walk_state(leaf, prefix + (name,))
                continue
            layer = ".".join(prefix)
            if name == "mean":
                sd[f"{layer}.running_mean"] = tensor(leaf)
            elif name == "var":
                sd[f"{layer}.running_var"] = tensor(leaf)
                sd[f"{layer}.num_batches_tracked"] = torch.tensor(0)
            else:
                raise ValueError(f"unrecognized state leaf {layer}.{name}")

    walk(params, ())
    walk_state(state, ())
    return sd


def load_reference_checkpoint(path, ref_paths=()) -> dict:
    """A reference checkpoint file -> state_dict of CPU tensors.
    ``ref_paths`` go on ``sys.path`` so a pickled module's classes
    (``model.pointnet.PointNetCls``) resolve."""
    path = str(path)
    if os.path.isdir(path):                       # a training checkpoint
        path = os.path.join(path, MODEL_FILE)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    for p in ref_paths:
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        if obj.__class__.__name__ == "DataParallel":
            obj = obj.module
        return dict(obj.state_dict())
    if isinstance(obj, dict):
        return {k: torch.as_tensor(v) for k, v in obj.items()}
    raise TypeError(f"unsupported checkpoint object: {type(obj)}")


def is_dual_state_dict(sd: dict) -> bool:
    """Whether ``sd`` is a DualPointNetCls's (two SimpleSTN3d)."""
    return "feat.stn1.conv1.weight" in sd


def pointnet_cls_from_state_dict(sd: dict, num_points: int = 500,
                                 device="cuda"):
    """A ``PointNetCls`` (or, for a dual state dict, a ``DualPointNetCls``)
    with the class count and input channels read off ``sd``, loaded
    strictly and moved to ``device``."""
    k = int(sd["fc3.weight"].shape[0])
    c = int(sd["feat.conv1.weight"].shape[1])
    cls = DualPointNetCls if is_dual_state_dict(sd) else PointNetCls
    model = cls(num_points=num_points, input_chann=c, k=k)
    model.load_state_dict({key: torch.as_tensor(v) for key, v in sd.items()})
    return model.to(device)
