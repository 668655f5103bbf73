"""Model family: PointNet classifiers + GPD projection CNN as ``nn.Module``s,
and the PointNet++ SSG classifier, which the JAX package does not have.

The counterpart of ``pointnetgpd_tpu/models/__init__.py``. The JAX package
exports functional ``init_*`` / ``apply_*`` pairs over parameter trees; here
each model's constructor and ``forward`` are that pair, so those names have
no counterpart (``FUNCTIONAL_NAMES``). Its converters
``convert_state_dict`` / ``load_torch_checkpoint`` turn reference torch
checkpoints into JAX trees; the port loads them as they are
(``load_reference_checkpoint``, ``pointnet_cls_from_state_dict``) and
takes the JAX package's trees through ``state_dict_from_jax``.
"""

from .convert import (
    load_reference_checkpoint,
    pointnet_cls_from_state_dict,
    state_dict_from_jax,
)
from .gpd import GPDClassifier
from .pointnet import (
    DualPointNetCls,
    DualPointNetfeat,
    PointNetCls,
    PointNetDenseCls,
    PointNetfeat,
    STN3d,
    pointnet_cls_infer,
)
from .pointnet2 import PointNet2ClsSSG, PointNet2SSGfeat

# the JAX package's names whose counterpart is a module above: its
# constructor (init_*), its forward (apply_*), or loading a reference
# checkpoint as it is (convert_state_dict, load_torch_checkpoint)
FUNCTIONAL_NAMES = {
    "init_pointnet_cls": "PointNetCls",
    "apply_pointnet_cls": "PointNetCls.forward",
    "init_dual_pointnet_feat": "DualPointNetfeat",
    "apply_dual_pointnet_feat": "DualPointNetfeat.forward",
    "init_pointnet_dense_cls": "PointNetDenseCls",
    "apply_pointnet_dense_cls": "PointNetDenseCls.forward",
    "init_pointnet_feat": "PointNetfeat",
    "apply_pointnet_feat": "PointNetfeat.forward",
    "init_stn": "STN3d",
    "apply_stn": "STN3d.forward",
    "init_gpd_classifier": "GPDClassifier",
    "apply_gpd_classifier": "GPDClassifier.forward",
    "convert_state_dict": "pointnet_cls_from_state_dict",
    "load_torch_checkpoint": "load_reference_checkpoint",
}

__all__ = [
    "DualPointNetCls",
    "DualPointNetfeat",
    "GPDClassifier",
    "PointNet2ClsSSG",
    "PointNet2SSGfeat",
    "PointNetCls",
    "PointNetDenseCls",
    "PointNetfeat",
    "STN3d",
    "load_reference_checkpoint",
    "pointnet_cls_from_state_dict",
    "pointnet_cls_infer",
    "state_dict_from_jax",
]
