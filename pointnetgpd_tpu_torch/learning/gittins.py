"""Computed Gittins indices for Beta-Bernoulli bandits.

The reference ships a hardcoded table of Gittins indices for gamma=0.98
(reference: discrete_adaptive_samplers.py:287-306 GittinsIndex98 +
discrete_selection_policies.py BetaBernoulliGittinsIndex98Policy). Instead of
copying a table, we COMPUTE the indices by the classic calibration method
(Gittins & Jones): the index of state (alpha, beta) is the standing reward
``lam`` of a known arm that makes the decision maker indifferent between
retiring to it and continuing with the unknown Bernoulli arm.

For a fixed ``lam``, the optimal value satisfies the Bellman equation

    V(a, b) = max( lam / (1 - gamma),
                   p (1 + gamma V(a+1, b)) + (1 - p) gamma V(a, b+1) ),
    p = a / (a + b),

solved by backward induction over the triangle a + b <= horizon with the
myopic tail ``max(lam, p) / (1 - gamma)`` at the truncation boundary (the
truncation error decays like gamma^horizon). Sweeping a lambda grid and
recording, per state, the first lambda at which retirement weakly dominates
gives the index to grid resolution; linear interpolation between the two
bracketing grid points refines it.

Everything is vectorized per anti-diagonal, so the full table costs
O(grid * horizon^2) numpy work (well under a second for the defaults).

The port's own copy of ``pointnetgpd_tpu/learning/gittins.py`` (numpy only).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=8)
def gittins_index_table(gamma: float = 0.98, max_pulls: int = 80,
                        horizon: int = 400, grid: int = 512) -> np.ndarray:
    """(max_pulls, max_pulls) array: entry [a-1, b-1] is the Gittins index of
    Beta(a, b) for integer a, b >= 1 with a + b <= max_pulls + 1; NaN outside
    the computed triangle."""
    lams = np.linspace(0.0, 1.0, grid)
    n_states = max_pulls  # indices computed for a + b <= max_pulls + 1
    table_lo = np.full((n_states, n_states), np.nan)
    table_hi = np.full((n_states, n_states), np.nan)

    # retire[g] tracks, per state, whether retirement dominates at lams[g]
    prev_retired = None
    for g, lam in enumerate(lams):
        retire_val = lam / (1.0 - gamma)
        # backward induction over diagonals s = a + b, from horizon down to 2
        # V_diag[i] = V(a=i+1, b=s-i-1) for the current diagonal s
        s = horizon
        a = np.arange(1, s)
        p = a / float(s)
        v_next = np.maximum(lam, p) / (1.0 - gamma)  # tail at s = horizon
        retired_now = np.full((n_states, n_states), False)
        for s in range(horizon - 1, 1, -1):
            a = np.arange(1, s)
            p = a / float(s)
            # V(a+1, b) is v_next[a] (same position index on diagonal s+1);
            # V(a, b+1) is v_next[a-1] -> shifted view
            cont = p * (1.0 + gamma * v_next[1:]) + (1.0 - p) * gamma * v_next[:-1]
            v = np.maximum(retire_val, cont)
            if s <= max_pulls + 1:
                aa = a - 1
                bb = s - a - 1
                retired_now[aa, bb] = retire_val >= cont
            v_next = v
        if prev_retired is not None:
            newly = retired_now & ~prev_retired
            table_lo[newly] = lams[g - 1]
            table_hi[newly] = lam
        else:
            table_lo[retired_now] = 0.0
            table_hi[retired_now] = 0.0
        prev_retired = retired_now

    # midpoint of the bracketing grid cell; states never retired (index ~ 1)
    table = 0.5 * (table_lo + table_hi)
    never = np.isnan(table_lo) & (prev_retired is not None)
    # mark the computed triangle: a + b <= max_pulls + 1
    aa, bb = np.meshgrid(np.arange(1, n_states + 1),
                         np.arange(1, n_states + 1), indexing="ij")
    in_tri = aa + bb <= max_pulls + 1
    table[never & in_tri] = 1.0
    table[~in_tri] = np.nan
    return table


def gittins_index(alphas, betas, gamma: float = 0.98,
                  max_pulls: int = 80) -> np.ndarray:
    """Gittins indices for (possibly fractional) Beta(alpha, beta) posteriors
    via bilinear interpolation of the integer table; states beyond the table
    fall back to the posterior mean (the index converges to the mean as
    alpha + beta grows)."""
    table = gittins_index_table(gamma=gamma, max_pulls=max_pulls)
    alphas = np.asarray(alphas, float)
    betas = np.asarray(betas, float)
    mean = alphas / (alphas + betas)

    a = np.clip(alphas, 1.0, max_pulls - 1.0)
    b = np.clip(betas, 1.0, max_pulls - 1.0)
    ia, ib = np.floor(a).astype(int), np.floor(b).astype(int)
    fa, fb = a - ia, b - ib
    ia -= 1  # table rows are alpha-1
    ib -= 1

    def at(i, j):
        return table[np.clip(i, 0, max_pulls - 1), np.clip(j, 0, max_pulls - 1)]

    v = ((1 - fa) * (1 - fb) * at(ia, ib) + fa * (1 - fb) * at(ia + 1, ib)
         + (1 - fa) * fb * at(ia, ib + 1) + fa * fb * at(ia + 1, ib + 1))
    out_of_table = (alphas + betas > max_pulls) | ~np.isfinite(v)
    return np.where(out_of_table, mean, v)
