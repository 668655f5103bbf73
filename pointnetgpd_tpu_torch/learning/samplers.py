"""Discrete adaptive samplers / multi-armed bandits (reference:
dex-net/src/dexnet/learning/discrete_adaptive_samplers.py:125-503).

``GaussianUniformAllocationMean`` is the main-path consumer: robust grasp
quality's MC mean over perturbation samples (robust_grasp_quality.py:158).

The port's own copy of ``pointnetgpd_tpu/learning/samplers.py`` (numpy only).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from .models import BetaBernoulliModel, GaussianModel
from .policies import (
    ThompsonSelectionPolicy,
    UCBSelectionPolicy,
    UniformSelectionPolicy,
)


@dataclass
class AdaptiveSamplingResult:
    """(discrete_adaptive_samplers.py:42-122 analogue)."""

    best_candidates: list
    best_pred_means: np.ndarray
    best_pred_vars: np.ndarray
    total_time: float
    checkpt_times: list
    iters: list
    indices: list
    vals: list
    models: list


class DiscreteAdaptiveSampler:
    """Generic sample -> evaluate -> update loop
    (discrete_maximize, discrete_adaptive_samplers.py:125-247)."""

    def __init__(self, objective, candidates, model, selection_policy):
        self.objective_ = objective
        self.candidates_ = list(candidates)
        self.model_ = model
        self.selection_policy_ = selection_policy
        self.selection_policy_.set_model(model)

    def discrete_maximize(self, termination_condition, snapshot_rate: int = 100,
                          rng=None):
        rng = rng or np.random.RandomState()
        start = time.time()
        k = 0
        cur_val = prev_val = None
        iters, indices, vals, models, times = [], [], [], [], []
        while not termination_condition(k, cur_val=cur_val, prev_val=prev_val,
                                        model=self.model_):
            idx = self.selection_policy_.choose_next(rng)
            prev_val = cur_val
            cur_val = self.objective_(self.candidates_[idx])
            self.model_.update(idx, cur_val)
            if k % snapshot_rate == 0:
                models.append(self.model_.snapshot())
                times.append(time.time() - start)
                iters.append(k)
            indices.append(idx)
            vals.append(cur_val)
            k += 1
        models.append(self.model_.snapshot())
        times.append(time.time() - start)
        iters.append(k)

        best_idx, best_means, best_vars = self.model_.max_prediction()
        best_candidates = [self.candidates_[int(i)] for i in best_idx]
        return AdaptiveSamplingResult(
            best_candidates, best_means, best_vars, time.time() - start,
            times, iters, indices, vals, models)


# ---------------------------------------------------------------------------
# Beta-Bernoulli bandits (discrete_adaptive_samplers.py:249-306)
# ---------------------------------------------------------------------------

class BetaBernoulliBandit(DiscreteAdaptiveSampler):
    def __init__(self, objective, candidates, policy, alpha_prior=1.0,
                 beta_prior=1.0):
        model = BetaBernoulliModel(len(candidates), alpha_prior, beta_prior)
        super().__init__(objective, candidates, model, policy)


class UniformAllocationMean(BetaBernoulliBandit):
    def __init__(self, objective, candidates, alpha_prior=1.0, beta_prior=1.0):
        super().__init__(objective, candidates, UniformSelectionPolicy(),
                         alpha_prior, beta_prior)


class ThompsonSampling(BetaBernoulliBandit):
    def __init__(self, objective, candidates, alpha_prior=1.0, beta_prior=1.0):
        super().__init__(objective, candidates, ThompsonSelectionPolicy(),
                         alpha_prior, beta_prior)


class GittinsIndex98(BetaBernoulliBandit):
    """Gittins-index bandit for gamma=0.98 — indices COMPUTED by the
    calibration method (learning/gittins.py) instead of the reference's
    hardcoded table (discrete_adaptive_samplers.py:287-306)."""

    def __init__(self, objective, candidates, alpha_prior=1.0, beta_prior=1.0):
        from .policies import BetaBernoulliGittinsIndex98Policy

        super().__init__(objective, candidates,
                         BetaBernoulliGittinsIndex98Policy(),
                         alpha_prior, beta_prior)


# ---------------------------------------------------------------------------
# Gaussian bandits (discrete_adaptive_samplers.py:308-361)
# ---------------------------------------------------------------------------

class GaussianBandit(DiscreteAdaptiveSampler):
    def __init__(self, objective, candidates, policy):
        model = GaussianModel(len(candidates))
        super().__init__(objective, candidates, model, policy)


class GaussianUniformAllocationMean(GaussianBandit):
    def __init__(self, objective, candidates):
        super().__init__(objective, candidates, UniformSelectionPolicy())


class GaussianThompsonSampling(GaussianBandit):
    def __init__(self, objective, candidates):
        super().__init__(objective, candidates, ThompsonSelectionPolicy())


class GaussianUCBSampling(GaussianBandit):
    def __init__(self, objective, candidates):
        super().__init__(objective, candidates, UCBSelectionPolicy())


# ---------------------------------------------------------------------------
# Correlated (CCBP) bandits (discrete_adaptive_samplers.py:376-503)
# ---------------------------------------------------------------------------

class CorrelatedBetaBernoulliBandit(DiscreteAdaptiveSampler):
    """Bandit over a CorrelatedBetaBernoulliModel: one pull informs every
    kernel-near candidate (discrete_adaptive_samplers.py:376-413).
    ``candidate_features`` are the kernel inputs (defaults to the candidates
    themselves when they are numeric vectors)."""

    def __init__(self, objective, candidates, policy, kernel=None,
                 candidate_features=None, tolerance=1e-4, alpha_prior=1.0,
                 beta_prior=1.0, p=0.95):
        from .models import CorrelatedBetaBernoulliModel

        feats = candidates if candidate_features is None else candidate_features
        model = CorrelatedBetaBernoulliModel(
            feats, kernel=kernel, tolerance=tolerance,
            alpha_prior=alpha_prior, beta_prior=beta_prior, p=p)
        super().__init__(objective, candidates, model, policy)


class CorrelatedThompsonSampling(CorrelatedBetaBernoulliBandit):
    def __init__(self, objective, candidates, **kw):
        super().__init__(objective, candidates, ThompsonSelectionPolicy(),
                         **kw)


class CorrelatedBayesUCB(CorrelatedBetaBernoulliBandit):
    def __init__(self, objective, candidates, horizon=1000, c=6, **kw):
        from .policies import BetaBernoulliBayesUCBPolicy

        super().__init__(objective, candidates,
                         BetaBernoulliBayesUCBPolicy(horizon=horizon, c=c),
                         **kw)


class CorrelatedGittins(CorrelatedBetaBernoulliBandit):
    """CCBP bandit with the computed Gittins-index policy (fractional
    posteriors interpolate into the index table)."""

    def __init__(self, objective, candidates, **kw):
        from .policies import BetaBernoulliGittinsIndex98Policy

        super().__init__(objective, candidates,
                         BetaBernoulliGittinsIndex98Policy(), **kw)
