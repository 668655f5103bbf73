"""Grasp model, samplers, quality metrics, collision checking.

Public surface mirrors the reference's ``dexnet.grasping`` exports
(reference: dex-net/src/dexnet/grasping/__init__.py:22-48), the same names as
``pointnetgpd_tpu/grasping/__init__.py``, on the port's torch
implementations.
"""

from .collision_checker import GraspCollisionChecker
from .evaluation import (
    evaluate_ferrari_canny,
    evaluate_force_closure,
    friction_boundary_labels,
)
from .grasp import (
    Contacts,
    close_fingers,
    configuration_from_params,
    endpoints,
    grasp_distance,
    grasp_from_contact_and_axis,
    vacuum_configuration_from_params,
    vacuum_params_from_configuration,
    grasp_from_endpoints,
    params_from_configuration,
    t_grasp_obj,
)
from .graspable_object import GraspableObject3D
from .gripper import Gripper, named_transforms
from .quality import (
    ferrari_canny_l1_force_only,
    force_closure,
    force_closure_qp,
    friction_cone,
    grasp_matrix,
    grasp_isotropy,
    min_norm_in_simplex,
    min_norm_in_simplex_batch,
    min_singular,
    partial_closure,
    wrench_in_positive_span,
    wrench_resistance,
    wrench_volume,
)
from .quality_config import (
    GraspQualityConfig,
    GraspQualityConfigFactory,
    GraspQualityFunctionFactory,
    GraspQualityResult,
)
from .random_variables import (
    GraspableObjectPoseGaussianRV,
    ParallelJawGraspPoseGaussianRV,
    ParamsGaussianRV,
)
from .robust_quality import expected_quality
from .samplers import (
    antipodal_sample_grasps,
    dedupe_grasps,
    gaussian_sample_grasps,
    gpg_sample_candidates,
    gpg_sample_grasps_sdf,
    point_sample_grasps_sdf,
    sample_grasps_stable_poses,
    sample_until,
    uniform_sample_grasps,
)
from .surface_window import (
    SurfaceWindow,
    bilateral_denoise,
    surface_information,
    surface_window_projection,
    surface_window_sdf,
)

__all__ = [s for s in dir() if not s.startswith("_")]
