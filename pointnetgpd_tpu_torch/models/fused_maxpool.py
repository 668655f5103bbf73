"""Fused linear -> BatchNorm(train) -> max over points, without the (B, N, C)
activation.

Port of ``pointnetgpd_tpu/models/fused_maxpool.py`` (its header derives the
algebra). ``matmul_bn_max`` is a ``torch.autograd.Function``:

- forward: a loop over 128-point tiles computes h = x @ w^T + b one tile at
  a time and keeps per (batch, channel) the running max/argmax and
  min/argmin of h, and per channel float32 (count, mean, M2) merged by
  Chan's parallel-variance rule. BN is the affine map y = a h + k with
  a = gamma * rsqrt(var + eps), so max_n y = a max_n h + k for a >= 0 and
  a min_n h + k for a < 0;
- backward: the closed form of the JAX custom VJP (``:152-192``): the max
  routes each (batch, channel) cotangent to one point, and the BN coupling
  through the batch mean and variance collapses to the (F, F) forms
  ``W^T diag(u2) W`` and ``P = sum x x^T``; ``db = 0`` exactly,
  ``dgamma = t_vec``, ``dbeta = s_g``.

The batch mean and biased variance it also returns are not differentiable
(BN buffer semantics). It is plain torch: the JAX op is a ``lax.scan`` and a
``custom_vjp``, not a Pallas kernel.
"""

from __future__ import annotations

import torch

from .layers import BN_EPS, batchnorm, linear, update_running_stats

_TILE = 128


def _stream_extrema_stats(x, w, b):
    """One pass over N-tiles: per (B, C) max/argmax/min/argmin of
    h = x @ w^T + b (first index on ties) and the per-channel float32 mean
    and biased variance. Returns (hmax, amax, hmin, amin, mean, var)."""
    bsz, n, _ = x.shape
    c = w.shape[0]
    hmax = hmin = amax = amin = None
    cnt = 0.0
    mean = torch.zeros((c,), dtype=torch.float32, device=x.device)
    m2 = torch.zeros((c,), dtype=torch.float32, device=x.device)
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
        mean_t = hf.sum(dim=(0, 1)) / n_t
        m2_t = torch.square(hf - mean_t).sum(dim=(0, 1))
        tot = cnt + n_t
        delta = mean_t - mean
        mean = mean + delta * (n_t / tot)
        m2 = m2 + m2_t + torch.square(delta) * (cnt * n_t / tot)
        cnt = tot
    return hmax, amax, hmin, amin, mean, m2 / max(cnt, 1.0)


class MatmulBnMax(torch.autograd.Function):
    """max over axis 1 of BatchNorm_train(x @ w^T + b), with the batch
    (mean, biased var) for the running-stat update."""

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta):
        hmax, amax, hmin, amin, mean, var = _stream_extrema_stats(x, w, b)
        a = gamma.float() * torch.rsqrt(var + BN_EPS)
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
        m_tot = float(bsz * n)
        gf = g.float()
        r = torch.rsqrt(var + BN_EPS)
        a = gamma.float() * r
        s_g = gf.sum(dim=0)                                   # (C,)
        t_vec = (gf * ((h_sel - mean) * r)).sum(dim=0)        # (C,)
        u1 = a * s_g / m_tot
        u2 = a * r * t_vec / m_tot
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
                s_g.to(gamma.dtype))


def matmul_bn_max(x, w, b, gamma, beta):
    """x (B, N, F), w (C, F), b, gamma, beta (C,) -> (m (B, C) in x's dtype,
    mean (C,) float32, biased var (C,) float32)."""
    return MatmulBnMax.apply(x, w, b, gamma, beta)


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
    update_running_stats(bn, mean, var, x.shape[0] * x.shape[1])
    return m
