"""Termination conditions for adaptive sampling (reference:
dex-net/src/dexnet/learning/termination_conditions.py:29-125).

The port's own copy of ``pointnetgpd_tpu/learning/termination.py`` (numpy only).
"""

from __future__ import annotations


class TerminationCondition:
    def __call__(self, k, cur_val=None, prev_val=None, model=None):
        raise NotImplementedError


class MaxIterTerminationCondition(TerminationCondition):
    def __init__(self, max_iters: int):
        self.max_iters_ = max_iters

    def __call__(self, k, cur_val=None, prev_val=None, model=None):
        return k >= self.max_iters_


class ThresholdTerminationCondition(TerminationCondition):
    """Stop when the current objective value exceeds a threshold."""

    def __init__(self, thresh: float):
        self.thresh_ = thresh

    def __call__(self, k, cur_val=None, prev_val=None, model=None):
        return cur_val is not None and cur_val > self.thresh_


class ProgressTerminationCondition(TerminationCondition):
    """Stop when improvement falls below eps."""

    def __init__(self, eps: float):
        self.eps_ = eps

    def __call__(self, k, cur_val=None, prev_val=None, model=None):
        if cur_val is None or prev_val is None:
            return False
        return abs(cur_val - prev_val) < self.eps_


class OrTerminationCondition(TerminationCondition):
    def __init__(self, conditions):
        self.conditions_ = conditions

    def __call__(self, *a, **kw):
        return any(c(*a, **kw) for c in self.conditions_)


class AndTerminationCondition(TerminationCondition):
    def __init__(self, conditions):
        self.conditions_ = conditions

    def __call__(self, *a, **kw):
        return all(c(*a, **kw) for c in self.conditions_)


class ConfidenceTerminationCondition(TerminationCondition):
    """Stop when the model's best-prediction variance drops below eps
    (termination_conditions.py:91-105)."""

    def __init__(self, eps: float):
        self.eps_ = eps

    def __call__(self, k, cur_val=None, prev_val=None, model=None):
        if model is None:
            return False
        _, _, max_var = model.max_prediction()
        return float(max_var[0]) < self.eps_
