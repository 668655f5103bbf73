"""Faults planted in the program, for the calibration of the limits and for
the tests: each wraps one function of the program where its caller looks
it up, and returns a function that takes the fault out again."""

from __future__ import annotations

import torch


def _swap(module, name: str, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    return lambda: setattr(module, name, orig)


def half_sampler():
    """The frame's sampler drops the second half of its valid frames."""
    from pointnetgpd_tpu_torch.robot import node

    def make(fn):
        def wrapped(*a, **kw):
            cand = fn(*a, **kw)
            keep = torch.cumsum(cand.valid.long(), 0) <= cand.valid.sum() // 2
            return cand._replace(valid=cand.valid & keep)
        return wrapped
    return _swap(node, "gpg_sample_candidates", make)


def reversed_ranking_of(fn):
    """``score_candidates_fused`` with its ranking turned over where it is
    produced: the good candidates listed worst first."""
    def wrapped(*a, **kw):
        pred, prob, counts, valid, good, order = fn(*a, **kw)
        n = int(good.sum())
        order = torch.cat([order[:n].flip(0), order[n:]])
        return pred, prob, counts, valid, good, order
    return wrapped


def reversed_ranking():
    """The scorer ranks its good candidates worst first."""
    from pointnetgpd_tpu_torch.inference import scorer

    return _swap(scorer, "score_candidates_fused",
                 reversed_ranking_of)


PLANTS = {"half_sampler": half_sampler,
          "reversed_ranking": reversed_ranking}
