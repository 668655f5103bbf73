"""Solver interface hierarchy (reference:
dex-net/src/dexnet/learning/solvers.py:36-131): Solver / SamplingSolver /
DiscreteSamplingSolver top out the adaptive samplers; TopKSolver returns the
K best candidates.

The port's own copy of ``pointnetgpd_tpu/learning/solvers.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np


class Solver:
    def __init__(self, objective):
        self.objective_ = objective

    def solve(self, **kwargs):
        raise NotImplementedError


class SamplingSolver(Solver):
    """Base for solvers that optimize by sampling the candidate space."""


class DiscreteSamplingSolver(SamplingSolver):
    """(solvers.py:62-116): partition candidates, maximize per partition,
    return the global best."""

    def __init__(self, objective, candidates):
        super().__init__(objective)
        self.candidates_ = list(candidates)
        self.num_candidates_ = len(self.candidates_)

    def discrete_maximize(self, candidates, termination_condition):
        raise NotImplementedError

    def partition(self, k: int):
        """Split candidates into K roughly equal partitions."""
        size = int(np.ceil(self.num_candidates_ / k))
        return [self.candidates_[i * size:(i + 1) * size] for i in range(k)]

    def solve(self, termination_condition=None, k: int = 1):
        from .termination import MaxIterTerminationCondition

        termination_condition = termination_condition or \
            MaxIterTerminationCondition(1000)
        best_candidates = []
        for partition in self.partition(k):
            if partition:
                best_candidates.append(
                    self.discrete_maximize(partition, termination_condition))
        return best_candidates


class TopKSolver(Solver):
    """(solvers.py:118-131): exhaustive evaluation, top-K by objective."""

    def top_K_solve(self, k: int, candidates):
        vals = [self.objective_(c) for c in candidates]
        order = np.argsort(vals)[::-1][:k]
        return [candidates[int(i)] for i in order]


class OptimizationSolver(Solver):
    """Constrained-solver base: feasibility of g_i(x) <= eps_i and
    |h_j(x)| <= eps_e (solvers.py:131 — the reference only defines the
    feasibility check; concrete optimizers subclass it)."""

    def __init__(self, objective, ineq_constraints=None, eq_constraints=None,
                 eps_i: float = 1e-2, eps_e: float = 1e-2):
        super().__init__(objective)
        self.ineq_constraints_ = ineq_constraints
        self.eq_constraints_ = eq_constraints
        self.eps_i_ = eps_i
        self.eps_e_ = eps_e

    def is_feasible(self, x) -> bool:
        try:
            self.objective_.check_valid_input(x)
        except ValueError:
            return False
        for g in self.ineq_constraints_ or []:
            if np.any(np.asarray(g(x)) > self.eps_i_):
                return False
        for h in self.eq_constraints_ or []:
            if np.any(np.abs(np.asarray(h(x))) > self.eps_e_):
                return False
        return True
