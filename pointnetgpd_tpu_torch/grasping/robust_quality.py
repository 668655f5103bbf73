"""Robust (Monte-Carlo) grasp quality: the expected metric under
uncertainty.

Port of ``pointnetgpd_tpu/grasping/robust_quality.py`` (reference:
dex-net/src/dexnet/grasping/robust_grasp_quality.py:85-166): every
perturbation sample of every grasp evaluates in one batched call, then the
Gaussian model's mean and spread are taken per grasp.
"""

from __future__ import annotations

import numpy as np
import torch

from ..draws import Draws
from .evaluation import evaluate_ferrari_canny, evaluate_force_closure
from .random_variables import (
    ParallelJawGraspPoseGaussianRV,
    ParamsGaussianRV,
)


def expected_quality(
    sdf,
    configs,
    center_of_mass,
    *,
    metric: str = "ferrari_canny_l1_force_only",
    friction_coef: float = 0.5,
    num_quality_samples: int = 25,
    grasp_rv: ParallelJawGraspPoseGaussianRV | None = None,
    params_rv: ParamsGaussianRV | None = None,
    num_samples_loa: int = 40,
    rng=None,
):
    """(mean (G,), std (G,)) of the metric under grasp-pose and friction
    uncertainty for (G, 10) configs, on the SDF's device. ``rng``: any
    source with ``randn``: a ``numpy.random.RandomState`` (the JAX
    package's default is ``RandomState(0)``) or a ``draws.Draws`` (the
    default, ``Draws(0)``). Object-pose uncertainty folds into grasp-pose
    uncertainty, as in the JAX package (robust_grasp_quality.py:95-105)."""
    rng = rng or Draws(0)
    grasp_rv = grasp_rv or ParallelJawGraspPoseGaussianRV()
    params_rv = params_rv or ParamsGaussianRV()
    configs = np.asarray(configs)
    g = configs.shape[0]
    n = num_quality_samples
    all_configs = np.concatenate([
        grasp_rv.sample_configs(c, n, rng) for c in configs])
    frictions = np.concatenate([
        params_rv.sample_friction(friction_coef, n, rng) for _ in range(g)])
    dev = sdf.data.device
    cfg = torch.as_tensor(all_configs, dtype=torch.float32, device=dev)
    mu = torch.as_tensor(frictions, dtype=torch.float32, device=dev)
    if metric == "ferrari_canny_l1_force_only":
        quals, _ = evaluate_ferrari_canny(
            sdf, cfg, torch.as_tensor(center_of_mass, dtype=torch.float32,
                                      device=dev),
            mu, num_samples=num_samples_loa)
    elif metric == "force_closure":
        quals, _ = evaluate_force_closure(sdf, cfg, mu,
                                          num_samples=num_samples_loa)
    else:
        raise ValueError(f"unknown metric {metric}")
    quals = quals.cpu().numpy().astype(np.float64).reshape(g, n)
    return quals.mean(axis=1), quals.std(axis=1)
