"""Training: loss, optimizer schedule, and the train and eval steps.

Port of ``pointnetgpd_tpu/training/train.py`` (reference
PointNetGPD/main_1v.py:59-110): NLL loss on the model's log_softmax outputs,
Adam(lr) with the reference's intended StepLR (halved every 30 epochs, with
persistent moments), invalid samples masked by a per-sample weight instead
of dropped.

Data parallelism (``group``, a ``torch.distributed`` process group; JAX
``train.py:10-13``, ``:74-78``): each rank holds its rows of the global
batch. BatchNorm's statistics are the global batch's
(``parallel.dist.batch_group``), the loss divides by the global weight sum,
so the global loss is the sum of the ranks' losses, and the ranks'
gradients are summed before the Adam step. Accuracy, ``valid_frac`` and the
eval sums are global. With no group a step is the one-device step.

- ``make_fused_train_step``: the closing-region crop
  (``collect_grasp_clouds_batched``), forward, backward and the Adam step in
  one call. Every train step is a ``utils.profiling.span`` ``train.step``
  holding ``train.crop`` (where it crops), ``train.fwd_bwd`` (itself
  ``train.forward``, the forward and the loss, then ``train.backward``) and
  ``train.adam``. ``compute_dtype`` (bfloat16): the
  forward and backward run on cast copies of the inputs and parameters,
  while the master parameters, their gradients, Adam's moments, BatchNorm's
  statistics and the loss stay float32. ``remat``: the forward runs again in
  the backward (``torch.utils.checkpoint``) instead of keeping its
  activations; the rerun leaves BatchNorm's running statistics as the first
  run set them. ``fused_maxpool``: the conv3 -> BN -> max stages through
  ``models/fused_maxpool.py``.
- ``make_eval_step``: the eval-mode forward under ``no_grad``, where the
  trunks run kernel K2 on the card.
- The GPD baseline's steps (reference main_1v_gpd.py, main_fullv_gpd.py):
  per sample the crop, k-NN normals within the crop and projection images,
  then the CNN; the model has no BatchNorm. Inside ``train.crop`` the
  features open ``gpd.crop``, ``gpd.normals`` and one ``gpd.project`` per
  projection order (3 at 12 channels, 1 at 3).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..inference.gpd_scorer import gpd_features
from ..parallel.dist import all_reduce_, batch_group, world_size
from ..ops.crop import (collect_grasp_clouds_batched,
                        collect_grasp_clouds_percloud)
from ..utils.profiling import span


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Any            # LambdaLR: StepLR over epochs
    step: int = 0             # updates taken


def step_lr(base_lr: float, step_size: int = 30, gamma: float = 0.5):
    """StepLR(epoch) == base_lr * gamma**(epoch // step_size)."""

    def schedule(epoch):
        return base_lr * (gamma ** (epoch // step_size))

    return schedule


@dataclass(frozen=True)
class AdamStepLR:
    """Adam whose learning rate for update t (0-based) is
    lr * gamma**((t // steps_per_epoch) // step_size), as optax's count
    gives it to the JAX package's schedule."""

    lr: float = 0.005
    step_size: int = 30
    gamma: float = 0.5
    steps_per_epoch: int = 1

    def factor(self, t: int) -> float:
        return self.gamma ** ((t // self.steps_per_epoch) // self.step_size)

    def init(self, params):
        opt = torch.optim.Adam(params, lr=self.lr)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, self.factor)


def make_optimizer(lr: float = 0.005, step_size: int = 30, gamma: float = 0.5,
                   steps_per_epoch: int = 1) -> AdamStepLR:
    """Adam with the reference's intended StepLR decay."""
    return AdamStepLR(lr, step_size, gamma, steps_per_epoch)


def init_train_state(model, tx: AdamStepLR) -> TrainState:
    opt, sched = tx.init(model.parameters())
    return TrainState(model, opt, sched, 0)


def _weight_sum(weights, group=None):
    """max(sum of the weights over the group's whole batch, 1)."""
    return torch.clamp(all_reduce_(weights.sum(), group), min=1.0)


def masked_nll_loss(log_probs, labels, weights, group=None):
    """F.nll_loss over valid samples only (weights in {0, 1}). Over a
    group, this rank's share of the global loss: its samples' sum over the
    global weight sum, so the ranks' losses and gradients add up to the
    global ones."""
    per_sample = -torch.gather(log_probs, 1, labels[:, None].long())[:, 0]
    return (per_sample * weights).sum() / _weight_sum(weights, group)


def _metrics(loss, logp, labels, weights, group=None):
    pred = logp.argmax(dim=-1)
    correct = ((pred == labels) * weights).sum().detach()
    sums = all_reduce_(torch.stack([loss.detach().float(), correct.float(),
                                    weights.sum().float()]), group)
    return {"loss": sums[0], "acc": sums[1] / torch.clamp(sums[2], min=1.0),
            "valid_frac": sums[2] / (weights.shape[0] * world_size(group))}


@torch.no_grad()
def sum_gradients(model, group):
    """Sum every parameter's gradient over the group, in one flat
    all-reduce."""
    if group is None:
        return
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1).float() for p in params])
    all_reduce_(flat, group)
    off = 0
    for p in params:
        p.grad.copy_(flat[off:off + p.numel()].view_as(p.grad))
        off += p.numel()


@contextlib.contextmanager
def _kept_bn_buffers(model):
    """Restore every buffer of ``model`` on exit: the rerun forward of
    ``remat`` must not move BatchNorm's running statistics again."""
    saved = [(b, b.clone()) for b in model.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)


def _forward(model, x, *, compute_dtype=None, remat=False,
             fused_maxpool=False):
    """The train-mode forward: log_probs in float32."""

    def fwd(x):
        if compute_dtype is None:
            return model(x, fused_maxpool=fused_maxpool)[0]
        params = {n: p.to(compute_dtype) for n, p in model.named_parameters()}
        return torch.func.functional_call(
            model, params, (x.to(compute_dtype),),
            {"fused_maxpool": fused_maxpool})[0]

    if remat:
        logp = checkpoint(fwd, x, use_reentrant=False, context_fn=lambda: (
            contextlib.nullcontext(), _kept_bn_buffers(model)))
    else:
        logp = fwd(x)
    return logp.float()


def _backward(state: TrainState, loss, group=None):
    with span("train.backward"):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        sum_gradients(state.model, group)


def _adam(state: TrainState):
    with span("train.adam"):
        state.optimizer.step()
        state.scheduler.step()
    state.step += 1


def make_train_step():
    """Train step on pre-cropped clouds: (state, clouds (B, N, C), labels,
    weights) -> (state, metrics)."""

    def train_step(state: TrainState, clouds, labels, weights):
        with span("train.step"):
            state.model.train()
            with span("train.fwd_bwd"):
                with span("train.forward"):
                    logp = _forward(state.model, clouds)
                    loss = masked_nll_loss(logp, labels, weights)
                _backward(state, loss)
            _adam(state)
            return state, _metrics(loss, logp, labels, weights)

    return train_step


def make_eval_step(group=None):
    """Masked eval on pre-cropped clouds: (model, clouds, labels, weights)
    -> {"loss_sum", "correct", "count"} (over the group's whole batch),
    under ``no_grad`` (K2 on the card, on each rank's rows)."""

    @torch.no_grad()
    def eval_step(model, clouds, labels, weights):
        model.eval()
        logp = model(clouds)[0]
        return _eval_sums(logp, labels, weights, group)

    return eval_step


def _eval_sums(logp, labels, weights, group=None):
    per_sample = -torch.gather(logp.float(), 1, labels[:, None].long())[:, 0]
    correct = ((logp.argmax(dim=-1) == labels) * weights).sum()
    sums = all_reduce_(torch.stack([(per_sample * weights).sum(),
                                    correct.float(), weights.sum().float()]),
                       group)
    return {"loss_sum": sums[0], "correct": sums[1], "count": sums[2]}


def make_fused_train_step(*, num_points: int, min_point_limit: int = 50,
                          compute_dtype=None, remat: bool = False,
                          fused_maxpool: bool = False, group=None):
    """The fused train step: (state, grasps (B, >=8), clouds (B, P, 3),
    transforms (B, 4, 4), labels (B,), label_weights (B,), draws) ->
    (state, metrics). ``label_weights`` masks samples the host rejected
    (skip-band scores); the crop's validity is ANDed in. Over a ``group``
    the arrays are this rank's rows and ``draws`` its ``ShardDraws``."""

    def train_step(state: TrainState, grasps, clouds, transforms, labels,
                   label_weights, draws):
        with span("train.step"):
            with span("train.crop"):
                cropped, _, crop_valid = collect_grasp_clouds_batched(
                    grasps, clouds, transforms, draws, num_out=num_points,
                    min_point_limit=min_point_limit)
                weights = label_weights * crop_valid.to(label_weights.dtype)
            state.model.train()
            with span("train.fwd_bwd"), batch_group(group):
                with span("train.forward"):
                    logp = _forward(state.model, cropped,
                                    compute_dtype=compute_dtype, remat=remat,
                                    fused_maxpool=fused_maxpool)
                    loss = masked_nll_loss(logp, labels, weights, group)
                _backward(state, loss, group)
            _adam(state)
            return state, _metrics(loss, logp, labels, weights, group)

    return train_step


def make_gpd_feature_fn(*, num_points: int, project_chann: int = 3,
                        min_point_limit: int = 50, knn_k: int = 30):
    """Per-sample GPD features: (grasps, clouds, transforms, draws) ->
    (features (B, 60, 60, C), crop validity (B,)): the crop of each sample
    on its own cloud (span ``gpd.crop``), k-NN normals within the crop and
    projection images (``gpd_features``: ``gpd.normals``, ``gpd.project``)."""

    def features(grasps, clouds, transforms, draws):
        with span("gpd.crop"):
            pts, _, valid = collect_grasp_clouds_percloud(
                grasps, clouds, transforms, draws, num_out=num_points,
                min_point_limit=min_point_limit)
        return gpd_features(pts, grasps[:, 6], project_chann=project_chann,
                            knn_k=knn_k), valid

    return features


def make_gpd_eval_step(*, num_points: int, project_chann: int = 3,
                       min_point_limit: int = 50, knn_k: int = 30,
                       group=None):
    """Masked eval of the GPD baseline: (model, grasps, clouds, transforms,
    labels, label_weights, draws) -> {"loss_sum", "correct", "count"}."""
    features = make_gpd_feature_fn(num_points=num_points,
                                   project_chann=project_chann,
                                   min_point_limit=min_point_limit,
                                   knn_k=knn_k)

    @torch.no_grad()
    def eval_step(model, grasps, clouds, transforms, labels, label_weights,
                  draws):
        feats, crop_valid = features(grasps, clouds, transforms, draws)
        weights = label_weights * crop_valid.to(label_weights.dtype)
        model.eval()
        logp = model(feats)
        return _eval_sums(logp, labels, weights, group)

    return eval_step


def make_gpd_train_step(*, num_points: int, project_chann: int = 3,
                        min_point_limit: int = 50, knn_k: int = 30,
                        group=None):
    """Train step of the GPD projection-CNN baseline (reference
    main_1v_gpd.py: GPDClassifier on 60x60 projections, Adam + StepLR,
    persistent optimizer). As in the JAX package, normals are estimated
    within the cropped neighborhood, not on the full cloud
    (dataset.py:93-95)."""
    features = make_gpd_feature_fn(num_points=num_points,
                                   project_chann=project_chann,
                                   min_point_limit=min_point_limit,
                                   knn_k=knn_k)

    def train_step(state: TrainState, grasps, clouds, transforms, labels,
                   label_weights, draws):
        with span("train.step"):
            with span("train.crop"):
                with torch.no_grad():
                    feats, crop_valid = features(grasps, clouds, transforms,
                                                 draws)
                weights = label_weights * crop_valid.to(label_weights.dtype)
            state.model.train()
            with span("train.fwd_bwd"):
                with span("train.forward"):
                    logp = state.model(feats, draws)
                    loss = masked_nll_loss(logp, labels, weights, group)
                _backward(state, loss, group)
            _adam(state)
            return state, _metrics(loss, logp, labels, weights, group)

    return train_step
