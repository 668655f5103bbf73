"""Typed grasp-quality configs + user-facing quality functions.

Port of ``pointnetgpd_tpu/grasping/quality_config.py``: the config classes
are a copy, and the quality functions dispatch to the port's batched
metrics on the SDF's device. Re-design of the reference's config/function layer (reference:
dex-net/src/dexnet/grasping/grasp_quality_config.py:45-200 and
grasp_quality_function.py:50-226): required-key-validated parameter bags
(quasi-static / robust variants), a factory keyed on ``quality_type``, and
quality-function wrappers returning GraspQualityResult — but evaluation
dispatches to the batched device metrics (evaluation.py / robust_quality.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class GraspQualityConfig(dict):
    """Param bag with attribute access + required-key validation
    (grasp_quality_config.py:45-110)."""

    REQUIRED_KEYS: list = ["quality_method", "friction_coef", "num_cone_faces",
                           "soft_fingers", "quality_type"]

    def __init__(self, config: dict):
        super().__init__(config)
        self.check_valid(config)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def contains(self, key):
        return key in self

    def check_valid(self, config):
        for key in self.REQUIRED_KEYS:
            if key not in config:
                raise ValueError(f"Invalid configuration. Key {key} must be specified")


class QuasiStaticGraspQualityConfig(GraspQualityConfig):
    """(grasp_quality_config.py:112-146)."""

    REQUIRED_KEYS = ["quality_method", "friction_coef", "num_cone_faces",
                     "soft_fingers", "quality_type", "check_approach",
                     "all_contacts_required"]


class RobustQuasiStaticGraspQualityConfig(GraspQualityConfig):
    """(grasp_quality_config.py:148-182)."""

    REQUIRED_KEYS = (QuasiStaticGraspQualityConfig.REQUIRED_KEYS
                     + ["grasp_uncertainty", "obj_uncertainty",
                        "params_uncertainty", "num_quality_samples"])


class GraspQualityConfigFactory:
    """(grasp_quality_config.py:184-200)."""

    @staticmethod
    def create_config(config: dict) -> GraspQualityConfig:
        qtype = config.get("quality_type", "quasi_static")
        if qtype == "quasi_static":
            return QuasiStaticGraspQualityConfig(config)
        if qtype == "robust_quasi_static":
            # the reference's dataset config marks robust but the dataset
            # generator calls the deterministic metric directly; accept both
            # key sets (generate-dataset-canny.py:101-104 passes the robust
            # section through this factory with quasi-static evaluation)
            try:
                return RobustQuasiStaticGraspQualityConfig(config)
            except ValueError:
                return QuasiStaticGraspQualityConfig(config)
        raise ValueError(f"Quality config type {qtype} not supported")


@dataclass
class GraspQualityResult:
    """(grasp_quality_function.py:40-60)."""

    quality: float
    uncertainty: float = 0.0
    quality_config: GraspQualityConfig | None = None


class GraspQualityFunction:
    """Callable wrapper: (sdf, configs, com) -> per-grasp GraspQualityResult
    (grasp_quality_function.py:62-140)."""

    def __init__(self, sdf, center_of_mass, config: GraspQualityConfig):
        self.sdf = sdf
        self.center_of_mass = np.asarray(center_of_mass)
        self.config = config

    def __call__(self, grasp_configs):
        return self.quality(grasp_configs)

    def quality(self, grasp_configs):
        import torch

        from . import evaluation

        dev = self.sdf.data.device
        configs = torch.as_tensor(
            np.atleast_2d(np.asarray(grasp_configs)), dtype=torch.float32,
            device=dev)
        method = self.config.quality_method
        check_approach = bool(self.config.get("check_approach", False))
        if method == "force_closure":
            vals, _ = evaluation.evaluate_force_closure(
                self.sdf, configs, self.config.friction_coef,
                check_approach=check_approach)
        elif method in ("ferrari_canny_L1_force_only", "ferrari_canny_L1"):
            vals, _ = evaluation.evaluate_ferrari_canny(
                self.sdf, configs, self.center_of_mass,
                self.config.friction_coef, check_approach=check_approach,
                torque_scaling=self.config.get("torque_scaling", 1.0))
        else:
            raise ValueError(f"unsupported quality_method {method}")
        return [GraspQualityResult(float(v), quality_config=self.config)
                for v in vals.cpu().numpy()]


class RobustGraspQualityFunction(GraspQualityFunction):
    """Monte-Carlo expected quality (grasp_quality_function.py:142-226 ->
    robust_grasp_quality.py); all perturbation samples evaluate in one
    batched device call (robust_quality.py)."""

    def quality(self, grasp_configs):
        from .robust_quality import expected_quality

        grasp_configs = np.atleast_2d(np.asarray(grasp_configs))
        metric = self.config.quality_method
        if metric == "ferrari_canny_L1":
            metric = "ferrari_canny_l1_force_only"
        if metric == "ferrari_canny_L1_force_only":
            metric = "ferrari_canny_l1_force_only"
        means, stds = expected_quality(
            self.sdf, grasp_configs, self.center_of_mass, metric=metric,
            friction_coef=self.config.friction_coef,
            num_quality_samples=int(self.config.get("num_quality_samples", 25)))
        return [GraspQualityResult(float(m), float(s), self.config)
                for m, s in zip(means, stds)]


class GraspQualityFunctionFactory:
    """(grasp_quality_function.py:50-60)."""

    @staticmethod
    def create_quality_function(sdf, center_of_mass,
                                config: GraspQualityConfig):
        if config.quality_type == "quasi_static":
            return GraspQualityFunction(sdf, center_of_mass, config)
        if config.quality_type == "robust_quasi_static":
            return RobustGraspQualityFunction(sdf, center_of_mass, config)
        raise ValueError(f"Grasp quality type {config.quality_type} not supported")
