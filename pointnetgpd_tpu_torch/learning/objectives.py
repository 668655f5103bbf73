"""Objective functions for adaptive sampling (reference:
dex-net/src/dexnet/learning/objectives.py:33-380).

The port's own copy of ``pointnetgpd_tpu/learning/objectives.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np


class Objective:
    """Callable objective; subclasses implement ``evaluate``."""

    def __call__(self, *args, **kwargs):
        return self.evaluate(*args, **kwargs)

    def evaluate(self, x):
        raise NotImplementedError

    def check_valid_input(self, x):
        pass


class MinimizationObjective(Objective):
    """Negates a wrapped objective so maximizers minimize it."""

    def __init__(self, objective: Objective):
        self.objective_ = objective

    def evaluate(self, x):
        return -self.objective_(x)


class NonDeterministicObjective(Objective):
    """Evaluates a deterministic objective on a sample from candidate.sample()."""

    def __init__(self, det_objective: Objective):
        self.det_objective_ = det_objective

    def evaluate(self, x):
        x_val = x.sample() if hasattr(x, "sample") else x
        return self.det_objective_.evaluate(x_val)


class RandomBinaryObjective(Objective):
    """Bernoulli draw with the candidate's value as success probability
    (objectives.py — used by the bandit convergence tests)."""

    def __init__(self, rng=None):
        self.rng = rng or np.random.RandomState()

    def evaluate(self, x):
        self.check_valid_input(x)
        return int(self.rng.rand() < float(x))

    def check_valid_input(self, x):
        v = float(x)
        if not 0.0 <= v <= 1.0:
            raise ValueError("Binary objective value must be in [0, 1]")


class RandomContinuousObjective(Objective):
    """Gaussian noise around the candidate's value."""

    def __init__(self, noise: float = 0.1, rng=None):
        self.noise = noise
        self.rng = rng or np.random.RandomState()

    def evaluate(self, x):
        return float(x) + self.noise * self.rng.randn()


class DifferentiableObjective(Objective):
    """Objective with gradient/hessian (objectives.py:63-87)."""

    def gradient(self, x):
        raise NotImplementedError

    def hessian(self, x):
        raise NotImplementedError


class MaximizationObjective(DifferentiableObjective):
    """Pass-through wrapper (objectives.py:89-117); solvers maximize by
    default, so evaluate/gradient/hessian forward unchanged."""

    def __init__(self, objective: Objective):
        self.objective_ = objective

    def evaluate(self, x):
        return self.objective_(x)

    def gradient(self, x):
        return self.objective_.gradient(x)

    def hessian(self, x):
        return self.objective_.hessian(x)


class ZeroOneObjective(Objective):
    """Thresholded 0/1 value: 1 iff x >= b (objectives.py:175-193)."""

    def __init__(self, b: float = 0.0):
        self.b_ = b

    def evaluate(self, x):
        return int(float(x) >= self.b_)


class IdentityObjective(Objective):
    """Returns x (objectives.py:195-204)."""

    def evaluate(self, x):
        return float(x)


class LeastSquaresObjective(DifferentiableObjective):
    """0.5 ||Ax - b||^2 with closed-form gradient/hessian
    (objectives.py:232-267)."""

    def __init__(self, a, b):
        self.a_ = np.asarray(a, float)
        self.b_ = np.asarray(b, float)
        if self.a_.shape[0] != self.b_.shape[0]:
            raise ValueError("A and b must have the same number of rows")

    def check_valid_input(self, x):
        x = np.asarray(x)
        if x.shape[0] != self.a_.shape[1]:
            raise ValueError("x must match the number of columns of A")

    def evaluate(self, x):
        self.check_valid_input(x)
        r = self.a_ @ np.asarray(x, float) - self.b_
        return 0.5 * float(r @ r)

    def gradient(self, x):
        self.check_valid_input(x)
        return self.a_.T @ (self.a_ @ np.asarray(x, float) - self.b_)

    def hessian(self, x):
        return self.a_.T @ self.a_


class LogisticCrossEntropyObjective(DifferentiableObjective):
    """Negative log-likelihood of logistic regression with closed-form
    gradient/hessian (objectives.py:269-305; the reference's gradient and
    hessian carry a stray ridge term — here they are the exact NLL
    derivatives, verified against finite differences in tests)."""

    def __init__(self, x_mat, y):
        self.x_ = np.asarray(x_mat, float)
        self.y_ = np.asarray(y, float)

    def _mu(self, beta):
        return 1.0 / (1.0 + np.exp(-self.x_ @ np.asarray(beta, float)))

    def evaluate(self, beta):
        mu = np.clip(self._mu(beta), 1e-12, 1 - 1e-12)
        return -float(np.sum(self.y_ * np.log(mu)
                             + (1 - self.y_) * np.log(1 - mu)))

    def gradient(self, beta):
        return -self.x_.T @ (self.y_ - self._mu(beta))

    def hessian(self, beta):
        mu = self._mu(beta)
        return self.x_.T @ (self.x_ * (mu * (1 - mu))[:, None])


class CrossEntropyLoss(Objective):
    """Mean cross entropy vs fixed true probabilities
    (objectives.py:307-327)."""

    def __init__(self, true_p):
        self.true_p_ = np.asarray(true_p, float)
        self.n_ = self.true_p_.shape[0]

    def check_valid_input(self, est_p):
        if np.asarray(est_p).shape[0] != self.n_:
            raise ValueError("must supply the same number of datapoints")

    def evaluate(self, est_p):
        self.check_valid_input(est_p)
        p = np.clip(np.asarray(est_p, float), 1e-12, 1 - 1e-12)
        return -float(np.mean(self.true_p_ * np.log(p)
                              + (1 - self.true_p_) * np.log(1 - p)))


class SquaredErrorLoss(Objective):
    """Mean squared error vs fixed true values (objectives.py:329-349)."""

    def __init__(self, true_p):
        self.true_p_ = np.asarray(true_p, float)
        self.n_ = self.true_p_.shape[0]

    def evaluate(self, est_p):
        est_p = np.asarray(est_p, float)
        if est_p.shape[0] != self.n_:
            raise ValueError("must supply the same number of datapoints")
        return float(np.mean((self.true_p_ - est_p) ** 2))


class WeightedSquaredErrorLoss(Objective):
    """Weight-normalized squared error (objectives.py:351-378)."""

    def __init__(self, true_p):
        self.true_p_ = np.asarray(true_p, float)
        self.n_ = self.true_p_.shape[0]

    def evaluate(self, est_p, weights=None):
        est_p = np.asarray(est_p, float)
        if est_p.shape[0] != self.n_:
            raise ValueError("must supply the same number of datapoints")
        w = np.ones(self.n_) if weights is None else np.asarray(weights, float)
        return float(np.sum(w * (self.true_p_ - est_p) ** 2) / np.sum(w))


class CCBPLogLikelihood(Objective):
    """Mean Beta log-density of the true probabilities under CCBP posterior
    (alphas, betas) (objectives.py:380-420)."""

    def __init__(self, true_p):
        self.true_p_ = np.asarray(true_p, float)
        self.n_ = self.true_p_.shape[0]

    def evaluate(self, alphas, betas=None):
        import scipy.stats as ss

        if betas is None:
            alphas, betas = alphas
        alphas = np.asarray(alphas, float)
        betas = np.asarray(betas, float)
        if alphas.shape[0] != self.n_ or betas.shape[0] != self.n_:
            raise ValueError("must supply the same number of datapoints")
        return float(np.mean(ss.beta.logpdf(self.true_p_, alphas, betas)))
