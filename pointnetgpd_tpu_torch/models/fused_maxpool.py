"""Fused linear -> BatchNorm(train) -> max over points, without the (B, N, C)
activation.

Port of ``pointnetgpd_tpu/models/fused_maxpool.py`` (its header derives the
algebra). ``matmul_bn_max`` is a ``torch.autograd.Function``:

- forward: a loop over 128-point tiles computes h = x @ w^T + b one tile at
  a time and keeps per (batch, channel) the running max/argmax and
  min/argmin of h, and per channel (count, mean, M2) in float64, from
  float64 tile sums, merged by Chan's parallel-variance rule. BN is the
  affine map y = a h + k with a = gamma * rsqrt(var + eps), so
  max_n y = a max_n h + k for a >= 0 and a min_n h + k for a < 0;
- backward: the closed form of the JAX custom VJP (``:152-192``): the max
  routes each (batch, channel) cotangent to one point, and the BN coupling
  through the batch mean and variance collapses to the (F, F) forms
  ``W^T diag(u2) W`` and ``P = sum x x^T``; ``db = 0`` exactly,
  ``dgamma = t_vec``, ``dbeta = s_g``.

The batch mean and biased variance it also returns are not differentiable
(BN buffer semantics). One process is a group of one: the same arithmetic
runs with or without a group. Inside ``parallel.dist.batch_group(group)``
they are the group's whole batch's: the forward merges the ranks' (count, mean, M2)
by two all-reduces (the global mean from the sums, then the sums of
squared deviations from it), and the backward all-reduces ``s_g`` and
``t_vec`` before the BN coupling uses them, as SyncBatchNorm's backward
does; ``dgamma`` and ``dbeta`` stay the rank's own sums, which the
trainer's gradient all-reduce adds up (the statistics are summed in
float64). It is plain torch: the JAX op is a ``lax.scan`` and a
``custom_vjp``, not a Pallas kernel.
"""

from __future__ import annotations

import torch

from ..ops.fp import rsqrt
from ..parallel.dist import active_group, all_reduce_, world_size
from .layers import BN_EPS, batchnorm, linear, update_running_stats

_TILE = 128


def _stream_extrema_stats(x, w, b):
    """One pass over N-tiles: per (B, C) max/argmax/min/argmin of
    h = x @ w^T + b (first index on ties) and the per-channel mean and
    biased variance, merged in float64 from float64 tile sums. Returns
    (hmax, amax, hmin, amin, mean, var)."""
    bsz, n, _ = x.shape
    c = w.shape[0]
    hmax = hmin = amax = amin = None
    cnt = 0.0
    mean = torch.zeros((c,), dtype=torch.float64, device=x.device)
    m2 = torch.zeros((c,), dtype=torch.float64, device=x.device)
    wt = w.t()
    for off in range(0, n, _TILE):
        h = x[:, off:off + _TILE] @ wt + b                  # (B, T, C)
        t_max, t_amax = torch.max(h, dim=1)
        t_min, t_amin = torch.min(h, dim=1)
        if hmax is None:
            hmax, amax, hmin, amin = t_max, t_amax + off, t_min, t_amin + off
        else:
            better = t_max > hmax
            hmax = torch.where(better, t_max, hmax)
            amax = torch.where(better, t_amax + off, amax)
            worse = t_min < hmin
            hmin = torch.where(worse, t_min, hmin)
            amin = torch.where(worse, t_amin + off, amin)
        hf = h.float()
        n_t = float(h.shape[0] * h.shape[1])
        mean_t = hf.sum(dim=(0, 1), dtype=torch.float64) / n_t
        m2_t = torch.square(hf - mean_t.float()).sum(dim=(0, 1)).double()
        tot = cnt + n_t
        delta = mean_t - mean
        mean = mean + delta * (n_t / tot)
        m2 = m2 + m2_t + torch.square(delta) * (cnt * n_t / tot)
        cnt = tot
    return hmax, amax, hmin, amin, mean, m2 / max(cnt, 1.0)


def _group_stats(mean, var, n: float, group):
    """The group's (mean, biased var), float32, from each rank's (float64)
    over n values: the global mean from the summed sums, then the summed
    squared deviations from it (Chan's merge, with no sum of squares). With
    no group, the rank's own."""
    n_tot = n * world_size(group)
    mean_g = all_reduce_(mean * n, group) / n_tot
    m2 = all_reduce_(var * n + torch.square(mean - mean_g) * n, group)
    return mean_g.float(), (m2 / n_tot).float()


class MatmulBnMax(torch.autograd.Function):
    """max over axis 1 of BatchNorm_train(x @ w^T + b), with the batch
    (mean, biased var) for the running-stat update."""

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, group=None):
        hmax, amax, hmin, amin, mean, var = _stream_extrema_stats(x, w, b)
        ctx.group = group
        mean, var = _group_stats(mean, var, float(x.shape[0] * x.shape[1]),
                                 group)
        a = gamma.float() * rsqrt(var + BN_EPS)
        pos = a >= 0
        h_sel = torch.where(pos, hmax.float(), hmin.float())
        idx = torch.where(pos, amax, amin)                    # (B, C)
        m = a * (h_sel - mean) + beta.float()
        ctx.save_for_backward(x, w, b, gamma, mean, var, h_sel, idx)
        ctx.mark_non_differentiable(mean, var)
        return m.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, w, b, gamma, mean, var, h_sel, idx = ctx.saved_tensors
        bsz, n, f = x.shape
        m_tot = float(bsz * n) * world_size(ctx.group)
        gf = g.float()
        r = rsqrt(var + BN_EPS)
        a = gamma.float() * r
        s_g = gf.sum(dim=0)                                   # (C,)
        t_vec = (gf * ((h_sel - mean) * r)).sum(dim=0)        # (C,)
        # the BN coupling runs through the whole batch's sums
        st = all_reduce_(torch.stack([s_g, t_vec]), ctx.group)
        u1 = a * st[0] / m_tot
        u2 = a * r * st[1] / m_tot
        wf, bf, xf = w.float(), b.float(), x.float()
        gather = idx[..., None].expand(-1, -1, f)             # (B, C, F)

        # dL/dx: sparse scatter + constant row + rank-structured quadratic
        contrib = (a * gf)[..., None] * wf[None]              # (B, C, F)
        dx = torch.zeros((bsz, n, f), dtype=torch.float32, device=x.device)
        dx.scatter_add_(1, gather, contrib)
        const_row = (u1 + u2 * (bf - mean)) @ wf              # (F,)
        q = (wf * u2[:, None]).t() @ wf                       # (F, F)
        dx = dx - const_row - xf @ q

        # dL/dw
        x_sel = torch.gather(xf, 1, gather)                   # (B, C, F)
        dw = a[:, None] * torch.einsum("bc,bcf->cf", gf, x_sel)
        sx = xf.sum(dim=(0, 1))                               # (F,)
        p_mat = torch.einsum("bnf,bng->fg", xf, xf)           # (F, F)
        dw = (dw - torch.outer(u1 + u2 * (bf - mean), sx)
              - u2[:, None] * (wf @ p_mat))
        db = torch.zeros_like(b)     # BN absorbs the conv bias exactly
        return (dx.to(x.dtype), dw.to(w.dtype), db, t_vec.to(gamma.dtype),
                s_g.to(gamma.dtype), None)


def matmul_bn_max(x, w, b, gamma, beta):
    """x (B, N, F), w (C, F), b, gamma, beta (C,) -> (m (B, C) in x's dtype,
    mean (C,) float32, biased var (C,) float32); the statistics are the
    active ``batch_group``'s whole batch's."""
    return MatmulBnMax.apply(x, w, b, gamma, beta, active_group())


def linear_bn_max(layer, bn, x, *, train: bool, fused: bool):
    """linear -> batchnorm -> max over the point axis (B, N, Cin) ->
    (B, C): the streamed op above when ``fused and train`` (BN's running
    statistics updated from its batch statistics), the reference-shaped
    composition otherwise."""
    if not (fused and train):
        return batchnorm(bn, linear(layer, x), train=train).amax(dim=1)
    w = layer.weight
    if w.dim() == 3:
        w = w[:, :, 0]
    m, mean, var = matmul_bn_max(x, w, layer.bias, bn.weight, bn.bias)
    update_running_stats(bn, mean, var, x.shape[0] * x.shape[1]
                         * world_size(active_group()))
    return m
