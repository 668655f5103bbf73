"""Plain training steps of PointNetCls: crop, train-mode forward, masked NLL
loss, backward by autograd, and Adam written out.

PointNetGPD/main_1v.py:59-110: the loss is the NLL of the log-softmax
outputs over the samples that count (a sample whose crop holds fewer than
``min_points`` points, or whose label was dropped, has weight 0), divided by
the number that count; Adam (beta1 0.9, beta2 0.999, eps 1e-8) at the
configured learning rate. BatchNorm normalizes with the batch's statistics.
"""

from __future__ import annotations

import torch

from . import crop, pointnet

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


def crop_batch(grasps, clouds, transforms, perm, windows, *, num_out: int,
               min_points: int):
    """Each sample's crop of its own cloud, visited in the shared shuffle
    ``perm``. Returns (points (B, num_out, 3), valid (B,))."""
    centers, rows, half = crop.training_frames(grasps, transforms)
    pts, _, valid = crop.crop(clouds[:, perm], centers, rows, -half, half,
                              windows, num_out, min_points)
    return pts, valid


def loss_fn(params, x, labels, weights, tf32=False):
    logp = pointnet.forward(params, x, train=True, tf32=tf32)
    nll = -logp.gather(1, labels[:, None].long())[:, 0]
    return (nll * weights).sum() / weights.sum().clamp(min=1.0)


@torch.no_grad()
def adam_step(params: dict, grads: dict, m: dict, v: dict, t: int,
              lr: float):
    """Update ``t`` (counted from 1) of Adam, in place on ``params`` and the
    moments ``m`` and ``v``."""
    c1, c2 = 1 - BETA1 ** t, 1 - BETA2 ** t
    for k, g in grads.items():
        m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
        v[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
        denom = (v[k] / c2).sqrt() + ADAM_EPS
        params[k].sub_(lr * (m[k] / c1) / denom)


def gradients(params: dict, x, labels, weights, tf32=False):
    """(loss, gradients by name) of the trainable leaves of ``params``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()
              if pointnet.is_trainable(k)}
    loss = loss_fn(dict(params, **leaves), x, labels, weights, tf32)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def run_steps(params: dict, batches, *, lr, tf32: bool = False):
    """Train ``params`` (a dict of leaf tensors, changed in place) from
    fresh Adam moments on the cropped ``batches`` [(x, labels, weights),
    ...]; ``lr(t)`` is update t's learning rate (t from 0). Returns (losses,
    the first step's gradients by name). ``tf32``: the products in TF32
    (the control)."""
    trainable = {k: v for k, v in params.items() if pointnet.is_trainable(k)}
    m = {k: torch.zeros_like(v) for k, v in trainable.items()}
    v = {k: torch.zeros_like(p) for k, p in trainable.items()}
    losses, first = [], None
    for t, (x, labels, weights) in enumerate(batches):
        loss, grads = gradients(params, x, labels, weights, tf32)
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        adam_step(trainable, grads, m, v, t + 1, lr(t))
        losses.append(loss)
    return losses, first
