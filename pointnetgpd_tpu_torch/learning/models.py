"""Bayesian reward models for discrete bandits (reference:
dex-net/src/dexnet/learning/models.py:36-487): Bernoulli (MLE), Beta-Bernoulli
(conjugate), and independent Gaussian models with snapshots.

The port's own copy of ``pointnetgpd_tpu/learning/models.py`` (numpy only).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Snapshot:
    best_pred_ind: int
    num_obs: np.ndarray


@dataclass
class BernoulliSnapshot(Snapshot):
    means: np.ndarray


@dataclass
class BetaBernoulliSnapshot(Snapshot):
    alphas: np.ndarray
    betas: np.ndarray


@dataclass
class GaussianSnapshot(Snapshot):
    means: np.ndarray
    variances: np.ndarray
    sample_vars: np.ndarray


class DiscreteModel:
    """Interface: predict(i) -> (mean, var); update(i, value); sample()."""

    def num_vars(self):
        return self.num_vars_

    def max_prediction(self):
        """(best indices, best means, best vars) over all candidates."""
        means, variances = self.predict_all()
        best = np.max(means)
        idx = np.where(means == best)[0]
        return idx, means[idx], variances[idx]

    def predict(self, index):
        means, variances = self.predict_all()
        return means[index], variances[index]

    def predict_all(self):
        raise NotImplementedError

    def update(self, index, value):
        raise NotImplementedError

    def sample(self, rng=None):
        raise NotImplementedError

    def snapshot(self):
        raise NotImplementedError


class BernoulliModel(DiscreteModel):
    """MLE Bernoulli means (models.py:121-199)."""

    def __init__(self, num_vars: int, mean_prior: float = 0.5):
        self.num_vars_ = num_vars
        self.means_ = mean_prior * np.ones(num_vars)
        self.num_obs_ = np.zeros(num_vars)

    def predict_all(self):
        n = np.maximum(self.num_obs_, 1)
        return self.means_, self.means_ * (1 - self.means_) / n

    def update(self, index, value):
        n = self.num_obs_[index]
        self.means_[index] = (self.means_[index] * n + value) / (n + 1)
        self.num_obs_[index] += 1

    def sample(self, rng=None):
        return self.means_

    def snapshot(self):
        best = self.max_prediction()[0][0]
        return BernoulliSnapshot(int(best), self.num_obs_.copy(),
                                 self.means_.copy())


class BetaBernoulliModel(DiscreteModel):
    """Conjugate Beta-Bernoulli posterior per candidate (models.py:202-315)."""

    def __init__(self, num_vars: int, alpha_prior: float = 1.0,
                 beta_prior: float = 1.0):
        self.num_vars_ = num_vars
        self.alphas_ = alpha_prior * np.ones(num_vars)
        self.betas_ = beta_prior * np.ones(num_vars)
        self.num_obs_ = np.zeros(num_vars)

    @property
    def posterior_alphas(self):
        return self.alphas_

    @property
    def posterior_betas(self):
        return self.betas_

    def predict_all(self):
        a, b = self.alphas_, self.betas_
        means = a / (a + b)
        variances = a * b / ((a + b) ** 2 * (a + b + 1))
        return means, variances

    def update(self, index, value):
        self.alphas_[index] += value
        self.betas_[index] += 1.0 - value
        self.num_obs_[index] += 1

    def sample(self, rng=None):
        rng = rng or np.random
        return rng.beta(self.alphas_, self.betas_)

    def snapshot(self):
        best = self.max_prediction()[0][0]
        return BetaBernoulliSnapshot(int(best), self.num_obs_.copy(),
                                     self.alphas_.copy(), self.betas_.copy())


class GaussianModel(DiscreteModel):
    """Independent Gaussian mean estimation (models.py:317-420): running mean
    + sample variance per candidate; predictive variance = s^2 / n."""

    def __init__(self, num_vars: int):
        self.num_vars_ = num_vars
        self.means_ = np.zeros(num_vars)
        self.squared_means_ = np.zeros(num_vars)
        self.num_obs_ = np.zeros(num_vars)

    @property
    def means(self):
        return self.means_

    @property
    def sample_vars(self):
        return np.maximum(self.squared_means_ - self.means_ ** 2, 0.0)

    @property
    def variances(self):
        return self.sample_vars / np.maximum(self.num_obs_, 1)

    def predict_all(self):
        return self.means_, self.variances

    def update(self, index, value):
        n = self.num_obs_[index]
        self.means_[index] = (self.means_[index] * n + value) / (n + 1)
        self.squared_means_[index] = (
            self.squared_means_[index] * n + value ** 2) / (n + 1)
        self.num_obs_[index] += 1

    def sample(self, rng=None, stop=False):
        rng = rng or np.random
        std = np.sqrt(self.variances)
        return self.means_ + std * rng.randn(self.num_vars_)

    def snapshot(self):
        best = self.max_prediction()[0][0]
        return GaussianSnapshot(int(best), self.num_obs_.copy(),
                                self.means_.copy(), self.variances.copy(),
                                self.sample_vars.copy())


class SquaredExponentialKernel:
    """k(x, y) = exp(-||x - y||^2 / (2 l^2)) over candidate feature vectors
    (the reference's CCBP kernel, supplied there by autolab_core;
    models.py:423-487 consumer)."""

    def __init__(self, length_scale: float = 1.0):
        # pick length_scale ~ the candidate-feature spacing: a scale much
        # larger than the feature range correlates EVERY arm and blends all
        # posteriors toward the population mean
        self.length_scale = float(length_scale)

    def __call__(self, x, y):
        d2 = np.sum((np.asarray(x, float) - np.asarray(y, float)) ** 2)
        return float(np.exp(-d2 / (2.0 * self.length_scale ** 2)))

    def vector(self, x, ys):
        """k(x, y_i) for all rows y_i — the vectorized within-radius lookup."""
        d2 = np.sum((np.asarray(ys, float) - np.asarray(x, float)) ** 2,
                    axis=1)
        return np.exp(-d2 / (2.0 * self.length_scale ** 2))

    def matrix(self, ys):
        ys = np.asarray(ys, float)
        d2 = np.sum((ys[:, None] - ys[None]) ** 2, axis=-1)
        return np.exp(-d2 / (2.0 * self.length_scale ** 2))


class CorrelatedBetaBernoulliModel(BetaBernoulliModel):
    """Continuous Correlated Beta Process: one observation updates every
    candidate within the kernel's tolerance radius, weighted by the kernel
    (reference: models.py:423-487 CorrelatedBetaBernoulliModel).

    Re-design: the reference walks a nearest-neighbor structure and loops the
    neighbors per update; ``k >= tolerance`` IS the within-error-radius test
    for a monotone kernel, so the update is one vectorized kernel row —
    alphas += value * k, betas += (1 - value) * k, zeroed below tolerance.
    ``snapshot`` predicts by the lower confidence bound at level ``p``
    (models.py lcb_prediction), not the posterior mean.
    """

    def __init__(self, candidate_features, kernel=None, tolerance: float = 1e-2,
                 alpha_prior: float = 1.0, beta_prior: float = 1.0,
                 p: float = 0.95):
        feats = np.asarray(candidate_features, float)
        if feats.ndim == 1:
            feats = feats[:, None]
        super().__init__(len(feats), alpha_prior, beta_prior)
        self.features_ = feats
        self.kernel_ = kernel or SquaredExponentialKernel()
        self.tolerance_ = float(tolerance)
        self.p_ = float(p)

    def update(self, index, value):
        if not 0.0 <= value <= 1.0:
            raise ValueError("values must be within [0, 1]")
        k = self.kernel_.vector(self.features_[index], self.features_)
        k = np.where(k >= self.tolerance_, k, 0.0)
        self.alphas_ += value * k
        self.betas_ += (1.0 - value) * k
        self.num_obs_[index] += 1

    def lcb_prediction(self, p: float | None = None):
        """(best indices, means, vars) ranked by the Beta lower confidence
        bound at level p."""
        import scipy.stats as ss

        p = self.p_ if p is None else p
        lcb, _ = ss.beta.interval(p, self.alphas_, self.betas_)
        idx = np.where(lcb == np.max(lcb))[0]
        means, variances = self.predict_all()
        return idx, means[idx], variances[idx]

    def snapshot(self):
        best = self.lcb_prediction()[0][0]
        return BetaBernoulliSnapshot(int(best), self.num_obs_.copy(),
                                     self.alphas_.copy(), self.betas_.copy())
