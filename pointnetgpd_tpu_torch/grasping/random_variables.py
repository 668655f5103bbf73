"""Gaussian random variables over object pose, grasp pose, and parameters.

A copy of ``pointnetgpd_tpu/grasping/random_variables.py`` (numpy only; the
port imports nothing of the JAX package). ``rng`` is any source with a
numpy-style ``randn`` (a ``numpy.random.RandomState``, or the port's
``draws.Draws``). Re-design of the reference RVs (reference:
dex-net/src/dexnet/grasping/random_variables.py:54-339) for batched
sampling: each RV draws N perturbation samples in one call so the robust
quality MC evaluates all of them in one device program. Rotation
perturbations use the exponential map (sigma_rot small angles), translation
and friction are plain Gaussians — the same uncertainty model as the
reference configs (test/config.yaml metrics.*.{grasp,obj,params}_uncertainty).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _rotations_from_axis_angles(omegas: np.ndarray) -> np.ndarray:
    """(N, 3) axis-angle vectors -> (N, 3, 3) rotations (Rodrigues)."""
    theta = np.linalg.norm(omegas, axis=1, keepdims=True)
    small = theta[:, 0] < 1e-12
    axis = np.where(small[:, None], np.array([1.0, 0, 0]), omegas /
                    np.maximum(theta, 1e-12))
    k = np.zeros((len(omegas), 3, 3))
    k[:, 0, 1], k[:, 0, 2] = -axis[:, 2], axis[:, 1]
    k[:, 1, 0], k[:, 1, 2] = axis[:, 2], -axis[:, 0]
    k[:, 2, 0], k[:, 2, 1] = -axis[:, 1], axis[:, 0]
    c = np.cos(theta)[:, :, None]
    s = np.sin(theta)[:, :, None]
    eye = np.broadcast_to(np.eye(3), (len(omegas), 3, 3))
    outer = np.einsum("ni,nj->nij", axis, axis)
    rots = c * eye + s * k + (1 - c) * outer
    rots[small] = np.eye(3)
    return rots


@dataclass
class GraspableObjectPoseGaussianRV:
    """Object-pose uncertainty: returns 4x4 perturbation transforms
    (random_variables.py:54-170; sigmas per config.yaml obj_uncertainty)."""

    sigma_trans: tuple = (0.01, 0.01, 0.01)
    sigma_rot: tuple = (0.01, 0.01, 0.01)
    sigma_scale: float = 0.0

    def sample(self, n: int, rng=None):
        rng = rng or np.random.RandomState()
        trans = rng.randn(n, 3) * np.asarray(self.sigma_trans)
        rots = _rotations_from_axis_angles(
            rng.randn(n, 3) * np.asarray(self.sigma_rot))
        scales = 1.0 + (rng.randn(n) * self.sigma_scale
                        if self.sigma_scale else np.zeros(n))
        t = np.tile(np.eye(4), (n, 1, 1))
        t[:, :3, :3] = rots * scales[:, None, None]
        t[:, :3, 3] = trans
        return t


@dataclass
class ParallelJawGraspPoseGaussianRV:
    """Grasp-pose uncertainty: perturbs 10-dim configurations
    (random_variables.py:172-273; sigmas per config.yaml grasp_uncertainty)."""

    sigma_trans: tuple = (0.005, 0.005, 0.005)
    sigma_rot: tuple = (0.001, 0.001, 0.001)

    def sample_configs(self, config: np.ndarray, n: int, rng=None):
        rng = rng or np.random.RandomState()
        config = np.asarray(config)
        out = np.tile(config, (n, 1))
        out[:, 0:3] += rng.randn(n, 3) * np.asarray(self.sigma_trans)
        rots = _rotations_from_axis_angles(
            rng.randn(n, 3) * np.asarray(self.sigma_rot))
        axes = np.einsum("nij,j->ni", rots, config[3:6])
        out[:, 3:6] = axes / np.linalg.norm(axes, axis=1, keepdims=True)
        return out


@dataclass
class ParamsGaussianRV:
    """Parameter uncertainty (friction) (random_variables.py:275-339;
    sigma per config.yaml params_uncertainty: sigma_friction_coef)."""

    sigma_friction_coef: float = 0.1

    def sample_friction(self, friction_coef: float, n: int, rng=None):
        rng = rng or np.random.RandomState()
        return np.maximum(
            friction_coef + rng.randn(n) * self.sigma_friction_coef, 1e-3)
