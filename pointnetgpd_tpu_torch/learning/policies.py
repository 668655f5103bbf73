"""Candidate-selection policies for discrete bandits (reference:
dex-net/src/dexnet/learning/discrete_selection_policies.py:38-148).

The port's own copy of ``pointnetgpd_tpu/learning/policies.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np


class DiscreteSelectionPolicy:
    def __init__(self):
        self.model_ = None

    def set_model(self, model):
        self.model_ = model

    def choose_next(self, rng=None):
        raise NotImplementedError


class UniformSelectionPolicy(DiscreteSelectionPolicy):
    """Round-robin / uniform-random allocation."""

    def choose_next(self, rng=None):
        rng = rng or np.random
        return int(rng.randint(self.model_.num_vars()))


class MaxDiscreteSelectionPolicy(DiscreteSelectionPolicy):
    """Greedy: candidate with the highest predicted mean."""

    def choose_next(self, rng=None):
        means, _ = self.model_.predict_all()
        return int(np.argmax(means))


class ThompsonSelectionPolicy(DiscreteSelectionPolicy):
    """Sample from the posterior, pick the argmax."""

    def choose_next(self, rng=None):
        return int(np.argmax(self.model_.sample(rng)))


class UCBSelectionPolicy(DiscreteSelectionPolicy):
    """Upper confidence bound: mean + beta * std. Also stands in for the
    reference's table-driven BetaBernoulliGittinsIndex98Policy
    (discrete_selection_policies.py — the hardcoded 1998 Gittins table);
    UCB is the standard index approximation (documented deviation)."""

    def __init__(self, beta: float = 2.0):
        super().__init__()
        self.beta = beta

    def choose_next(self, rng=None):
        means, variances = self.model_.predict_all()
        return int(np.argmax(means + self.beta * np.sqrt(variances)))


class BetaBernoulliBayesUCBPolicy(DiscreteSelectionPolicy):
    """Bayes-UCB (Kaufmann et al.): pick the arm with the largest
    1 - 1/(t log(n)^c) Beta quantile (reference:
    discrete_selection_policies.py BetaBernoulliBayesUCBPolicy)."""

    def __init__(self, horizon: int = 1000, c: int = 6):
        super().__init__()
        self.t_ = 1
        self.horizon_ = horizon
        self.c_ = c

    def choose_next(self, rng=None):
        import scipy.stats as ss

        rng = rng or np.random
        gamma = 1.0 - 1.0 / (self.t_ * np.log(self.horizon_) ** self.c_)
        _, ucbs = ss.beta.interval(gamma, self.model_.posterior_alphas,
                                   self.model_.posterior_betas)
        best = np.where(ucbs == np.max(ucbs))[0]
        self.t_ += 1
        return int(best[rng.choice(len(best))]) if hasattr(rng, "choice") \
            else int(best[0])


class GaussianUCBPolicy(UCBSelectionPolicy):
    """GP-UCB over a GaussianModel: mean + beta * std
    (discrete_selection_policies.py:148-173; same rule as
    UCBSelectionPolicy, with the reference's beta=1 default)."""

    def __init__(self, beta: float = 1.0):
        super().__init__(beta=beta)


class BetaBernoulliGittinsIndex98Policy(DiscreteSelectionPolicy):
    """True Gittins-index policy for gamma=0.98: picks the arm with the
    highest COMPUTED Gittins index of its Beta posterior (reference:
    discrete_selection_policies.py BetaBernoulliGittinsIndex98Policy, which
    hardcodes a 1998 table — here the indices come from the calibration
    method in learning/gittins.py, validated against published gamma=0.9
    values to ~1e-3). Fractional posteriors (CCBP kernel updates)
    interpolate bilinearly."""

    def __init__(self, gamma: float = 0.98):
        super().__init__()
        self.gamma_ = gamma

    def choose_next(self, rng=None):
        from .gittins import gittins_index

        rng = rng or np.random
        idx = gittins_index(self.model_.posterior_alphas,
                            self.model_.posterior_betas, gamma=self.gamma_)
        best = np.where(idx == np.max(idx))[0]
        return int(best[rng.choice(len(best))])
