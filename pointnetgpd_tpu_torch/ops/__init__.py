"""Device ops: crops, cloud preprocessing, projections, voxelization; the
names of ``pointnetgpd_tpu/ops/__init__.py``. K2's fold and launch come from
``pointnet_trunk`` (the port of ``pointnet_trunk_pallas``).

``mesh_to_sdf`` here is the function, which hides its module of the same
name as an attribute of the package: reach the module with
``importlib.import_module("pointnetgpd_tpu_torch.ops.mesh_to_sdf")``."""

from .cloud import estimate_normals_knn, voxel_downsample
from .crop import (
    collect_candidate_clouds,
    collect_grasp_clouds,
    crop_closing_region,
    grasp_frame_from_config,
)
from .mesh_to_sdf import mesh_to_sdf
from .pointnet_trunk import fold_trunk_params, fused_trunk
from .projection import gpd_projection_features, project_to_image

__all__ = [s for s in dir() if not s.startswith("_")]
