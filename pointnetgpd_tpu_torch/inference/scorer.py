"""Batched grasp-candidate scorer: crop + resample + forward + vote + rank.

Port of ``pointnetgpd_tpu/inference/scorer.py``. The deployed reference
applies softmax on top of the model's log_softmax output (main_test.py:65-66);
that quirk is kept, as is the vote's tie break toward the smallest class
(``scipy.stats.mode``, main_test.py:93). Random numbers come from a
``draws.Draws``-like object. The model is a ``PointNetCls`` or, for dual
checkpoints (the JAX scorer's ``dual=True``), a ``DualPointNetCls`` that
scores (G, P, 6) clouds through ``score_clouds``. ``as_dtype`` casts the
model (bf16: every trunk still runs K2 in float32, see
``models/pointnet.py``).

``mesh`` (a ``parallel.mesh.Mesh``; JAX ``:158-194``): the candidate axis is
split over the mesh's shards and the model replicated, one copy per device.
``pad_to`` follows JAX's rule (``max(pad_to, n)`` where n divides it, else
``pad_to * n``), since the padded count decides the crop's strategy and the
shape of the draws. Each shard crops, resamples and scores its candidates in
a thread of its own (K2 launches once per trunk per shard); every draw is
made once for the whole padded batch and split (``ShardDraws``), so the
shards' results, gathered once onto the first device and ranked there, are
the single-device results.

Spans (``utils.profiling.span``): ``score.candidates`` around a fused call,
``score.crop``, ``score.forward`` and ``score.rank`` inside it, and
``score.fetch`` around each device-to-host copy of ``collect_scores``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import copy

import numpy as np
import torch
import torch.nn.functional as F

from ..draws import Draws
from ..models.convert import (is_dual_state_dict, load_reference_checkpoint,
                              pointnet_cls_from_state_dict)
from ..ops.crop import collect_candidate_clouds
from ..parallel import mesh as pmesh
from ..utils.profiling import span


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:     # numpy has no bfloat16
            tree = tree.float()
        with span("score.fetch"):
            return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


@dataclass
class PendingScore:
    """A dispatched scene score: the device tensors and the caller's extras
    that ``collect_scores`` copies to the host in one go."""

    out: Any                   # device tuple (None for 0 candidates)
    extra_fetch: Any           # caller tensors copied with it (or None)
    g: int                     # real (unpadded) candidate count


@torch.no_grad()
def score_cloud_batch(model, clouds, valid, draws, *, num_points: int = 500,
                      repeat: int = 1):
    """Score (G, P, 3) candidate clouds with repeat-voting: each candidate
    is resampled ``repeat`` times to ``num_points`` points (uniform with
    replacement, kinect2grasp.py:472-478), scored in one forward, and
    majority-voted. Returns (pred (G,), prob (G, k), votes (G, repeat))."""
    g, p_in, _ = clouds.shape
    idx = draws.resample(g * repeat, num_points, p_in).to(clouds.device)
    rep = clouds.repeat_interleave(repeat, dim=0)
    batch = rep[torch.arange(g * repeat, device=clouds.device)[:, None],
                idx.long()]
    # the model's precision from here on (bf16 after as_dtype); the
    # geometry stays float32
    batch = batch.to(model.fc3.weight.dtype)
    logp, _ = model(batch.contiguous())
    probs = F.softmax(logp, dim=-1)          # reference quirk (main_test:66)
    k_cls = probs.shape[-1]
    probs = probs.reshape(g, repeat, k_cls)
    votes = torch.argmax(probs, dim=-1)
    counts = F.one_hot(votes, k_cls).sum(dim=1)
    pred = torch.argmax(counts, dim=-1)      # ties -> smallest class
    agree = (votes == pred[:, None]).to(probs.dtype)
    denom = torch.clamp(agree.sum(dim=1), min=1.0)
    prob = torch.einsum("gr,grk->gk", agree, probs) / denom[:, None]
    pred = torch.where(valid, pred, 0)
    prob = torch.where(valid[:, None], prob, 0.0)
    return pred, prob, votes


@torch.no_grad()
def crop_and_score(model, pc, cand_frames, valid_in, hand_depth, width,
                   draws, *, num_points: int = 500, repeat: int = 1,
                   min_points: int = 50, crop_recenter: bool = False,
                   batch: int | None = None):
    """Crop + resample + forward + vote: (pred, prob, counts, valid).
    ``batch``: the whole batch's candidate count, for a shard."""
    with span("score.crop"):
        clouds, counts, valid = collect_candidate_clouds(
            cand_frames[:, 0], cand_frames[:, 1], cand_frames[:, 2],
            cand_frames[:, 3], pc, hand_depth, width, draws,
            num_out=num_points, min_point_limit=min_points,
            recenter=crop_recenter, batch=batch)
        valid = valid & valid_in
    with span("score.forward"):
        pred, prob, _ = score_cloud_batch(model, clouds, valid, draws,
                                          num_points=num_points,
                                          repeat=repeat)
    return pred, prob, counts, valid


def rank_candidates(pred, prob, counts, valid):
    """-> (pred, prob, counts, valid, good, order), where ``order`` ranks
    candidates by best-class probability, descending, with invalid or
    not-good candidates last."""
    best_class = prob.shape[-1] - 1
    score = prob[:, best_class]
    good = (pred == best_class) & valid
    order = torch.argsort(torch.where(good, -score, torch.inf), stable=True)
    return pred, prob, counts, valid, good, order


@torch.no_grad()
def score_candidates_fused(model, pc, cand_frames, valid_in, hand_depth,
                           width, draws, *, num_points: int = 500,
                           repeat: int = 1, min_points: int = 50,
                           crop_recenter: bool = False):
    """The whole per-frame scoring pipeline: crop + resample + forward +
    vote + rank. Returns (pred, prob, counts, valid, good, order)."""
    with span("score.candidates"):
        scored = crop_and_score(
            model, pc, cand_frames, valid_in, hand_depth, width, draws,
            num_points=num_points, repeat=repeat, min_points=min_points,
            crop_recenter=crop_recenter)
        with span("score.rank"):
            return rank_candidates(*scored)


def dispatch_padded(score, pc, candidates, valid, extra_fetch, *,
                    pad_to: int, device):
    """The scorers' front half. Puts the scene cloud and the (G, 5, 3)
    candidates on ``device``, pads the candidate axis with unit frames (the
    crop's normalize stays well-defined) to ``max(round_up(G, pad_to),
    pad_to)`` as the JAX package pads it, since the padded count picks the
    crop's strategy and shapes the draws, and builds ``valid_in``, false on
    the padding and wherever ``valid`` is. ``score(pc, frames, valid_in)``
    enqueues the scoring; for 0 candidates nothing is enqueued. Returns a
    ``PendingScore``."""
    if isinstance(candidates, torch.Tensor):
        cand = candidates.reshape(-1, 5, 3).to(device, torch.float32)
    else:
        cand = torch.from_numpy(np.asarray(candidates, np.float32)
                                .reshape(-1, 5, 3)).to(device)
    g = cand.shape[0]
    if g == 0:
        return PendingScore(out=None, extra_fetch=extra_fetch, g=0)
    g_pad = max(_round_up(g, pad_to), pad_to)
    pad_frame = torch.zeros((g_pad - g, 5, 3), device=device)
    pad_frame[:, 1, 0] = 1.0
    pad_frame[:, 2, 1] = 1.0
    pad_frame[:, 3, 2] = 1.0
    cand_p = torch.cat([cand, pad_frame])
    valid_in = torch.arange(g_pad, device=device) < g
    if valid is not None:
        v = torch.as_tensor(np.asarray(valid, bool) if not isinstance(
            valid, torch.Tensor) else valid).to(device, torch.bool)
        valid_in = valid_in & torch.cat(
            [v, torch.zeros((g_pad - g,), dtype=torch.bool, device=device)])
    if isinstance(pc, torch.Tensor):
        pc_d = pc.to(device, torch.float32)
    else:
        pc_d = torch.from_numpy(np.asarray(pc, np.float32)).to(device)
    return PendingScore(out=score(pc_d, cand_p, valid_in),
                        extra_fetch=extra_fetch, g=g)


def collect_scores(pending: PendingScore, k: int):
    """The scorers' back half: copy a dispatched ``k``-class result (and
    the caller's extras) to the host and cut it to the real candidates;
    ``score`` is the best class's probability and ``good_indices`` the good
    candidates in ranked order. Returns the dict, or (dict, extras)."""
    g = pending.g
    if pending.out is None:              # 0 candidates: nothing ran
        pred, prob = np.zeros((0,), np.int64), np.zeros((0, k), np.float32)
        counts, valid = np.zeros((0,), np.int64), np.zeros((0,), bool)
        order = np.zeros((0,), np.int64)
    else:
        pred, prob, counts, valid, good, order = _to_host(pending.out)
        pred, prob, counts = pred[:g], prob[:g], counts[:g]
        valid, good = valid[:g], good[:g]
        order = order[(order < g) & good[np.minimum(order, g - 1)]][:g]
    result = {
        "pred": pred,
        "prob": prob,
        "score": prob[:, k - 1],
        "counts": counts,
        "valid": valid,
        "good_indices": order,
    }
    if pending.extra_fetch is not None:
        return result, _to_host(pending.extra_fetch)
    return result


@dataclass
class GraspScorer:
    """Loaded model + padding policy. Candidate counts vary per frame; the
    candidate axis is padded to a multiple of ``pad_to`` as in the JAX
    package, whose results depend on it (the crop strategy switches on the
    padded count). With a ``mesh`` the scorer's device is the mesh's first
    device."""

    model: Any
    k: int = 3
    num_points: int = 500
    repeat: int = 1
    pad_to: int = 64
    min_points: int = 50
    crop_recenter: bool = False
    device: Any = "cuda"
    mesh: Any = None

    def __post_init__(self):
        if self.mesh is not None:
            n = self.mesh.size
            # candidate padding must tile evenly over the mesh
            self.pad_to = max(self.pad_to, n) if self.pad_to % n == 0 \
                else self.pad_to * n
            self.device = self.mesh.first
        self.device = torch.device(self.device)
        self.model = self.model.to(self.device).eval()
        self._models = (pmesh.replicate(self.model, self.mesh)
                        if self.mesh is not None else None)

    def _sharded(self, fn, draws, *batched, shared=()):
        """``fn(model, *shard's rows of batched, *shared, draws)`` on every
        shard of the mesh, in threads; the draws split per shard. Returns
        each shard's output."""
        mesh = self.mesh
        rv = pmesh.Rendezvous(mesh.size)
        chunks = [pmesh.shard_batch(t, mesh) for t in batched]
        on_dev = [pmesh.replicate(t, mesh) for t in shared]

        def shard(s, model, shard_draws):
            return fn(model, *(c[s] for c in chunks),
                      *(t[s] for t in on_dev), shard_draws)

        return pmesh.run_shards(mesh, shard, self._models,
                                pmesh.thread_draws(draws, mesh, rv),
                                rendezvous=rv)

    @classmethod
    def from_checkpoint(cls, path, ref_paths=(), device="cuda", dual=None,
                        **kw):
        """Reference checkpoint (pickled module, state_dict, .npz or a
        training checkpoint directory of the port). The model is a
        DualPointNetCls where the state dict is a dual one; ``dual`` (True
        or False), where given, must agree with it."""
        sd = load_reference_checkpoint(path, ref_paths)
        if dual is not None and bool(dual) != is_dual_state_dict(sd):
            raise ValueError(f"dual={dual} was requested but the checkpoint "
                             f"is {'' if not dual else 'not '}a dual model's")
        model = pointnet_cls_from_state_dict(sd, device=device)
        if kw.setdefault("k", model.k) != model.k:
            raise ValueError(f"checkpoint is {model.k}-class but "
                             f"k={kw['k']} was requested")
        return cls(model=model, device=device, **kw)

    def as_dtype(self, dtype) -> "GraspScorer":
        """A copy whose model is cast to ``dtype`` (``torch.bfloat16``
        halves the parameters and activations; its trunks still run K2 in
        float32). Exact checkpoint parity needs float32."""
        return GraspScorer(model=copy.deepcopy(self.model).to(dtype),
                           k=self.k, num_points=self.num_points,
                           repeat=self.repeat, pad_to=self.pad_to,
                           min_points=self.min_points,
                           crop_recenter=self.crop_recenter,
                           device=self.device, mesh=self.mesh)

    def score_clouds(self, clouds, valid=None, seed: int = 0, draws=None):
        """(G, P, C) cropped candidate clouds in the gripper frame (C = 3,
        or 6 for a dual model) -> (pred (G,), prob (G, k), votes
        (G, repeat)) as numpy arrays. The candidate axis is padded to
        ``pad_to`` as the JAX package pads it; the result comes to the host
        in one copy. ``draws`` replaces the resample draws (default
        ``Draws(seed)``)."""
        dev = self.device
        clouds = torch.as_tensor(np.asarray(clouds, np.float32) if not
                                 isinstance(clouds, torch.Tensor) else clouds)
        g = clouds.shape[0]
        g_pad = max(_round_up(g, self.pad_to), self.pad_to)
        clouds_p = torch.zeros((g_pad,) + tuple(clouds.shape[1:]),
                               dtype=torch.float32, device=dev)
        clouds_p[:g] = clouds.to(dev, torch.float32)
        valid_p = torch.zeros((g_pad,), dtype=torch.bool, device=dev)
        valid_p[:g] = True if valid is None else torch.as_tensor(
            np.asarray(valid, bool) if not isinstance(valid, torch.Tensor)
            else valid).to(dev)
        draws = draws or Draws(seed, dev)
        kw = dict(num_points=self.num_points, repeat=self.repeat)
        if self.mesh is None:
            pred, prob, votes = score_cloud_batch(self.model, clouds_p,
                                                  valid_p, draws, **kw)
        else:
            pred, prob, votes = pmesh.gather(self._sharded(
                lambda m, c, v, d: score_cloud_batch(m, c, v, d, **kw),
                draws, clouds_p, valid_p), dev)
        # one device -> host copy: every output is exact in float64
        k = prob.shape[1]
        host = torch.cat([pred[:g, None].double(), prob[:g].double(),
                          votes[:g].double()], dim=1).cpu().numpy()
        return (host[:, 0].astype(np.int64), host[:, 1:1 + k].astype(
            np.float32), host[:, 1 + k:].astype(np.int64))

    def score_candidates(self, pc, candidates, hand_depth, width,
                         seed: int = 0, valid=None, extra_fetch=None,
                         draws=None):
        """Scene cloud + (G, 5, 3) GPG candidates -> dict with pred / prob /
        score per candidate and the ranked ``good_indices``
        (kinect2grasp.py:500-514); with ``extra_fetch``, (dict, extras)."""
        return self.collect(self.dispatch_candidates(
            pc, candidates, hand_depth, width, seed=seed, valid=valid,
            extra_fetch=extra_fetch, draws=draws))

    def dispatch_candidates(self, pc, candidates, hand_depth, width,
                            seed: int = 0, valid=None, extra_fetch=None,
                            draws=None):
        """Enqueue the scoring on the device and return a ``PendingScore``
        without copying anything to the host."""
        kw = dict(num_points=self.num_points, repeat=self.repeat,
                  min_points=self.min_points, crop_recenter=self.crop_recenter)
        hd, w = float(hand_depth), float(width)

        def score(pc_d, cand_p, valid_in):
            d = draws or Draws(seed, self.device)
            if self.mesh is None:
                return score_candidates_fused(self.model, pc_d, cand_p,
                                              valid_in, hd, w, d, **kw)
            return rank_candidates(*pmesh.gather(self._sharded(
                lambda m, c, v, p, ds: crop_and_score(
                    m, p, c, v, hd, w, ds, batch=cand_p.shape[0], **kw),
                d, cand_p, valid_in, shared=(pc_d,)), self.device))

        return dispatch_padded(score, pc, candidates, valid, extra_fetch,
                               pad_to=self.pad_to, device=self.device)

    def collect(self, pending: PendingScore):
        """Copy the result (and the caller's extras) to the host and
        postprocess; returns the dict, or (dict, extras)."""
        return collect_scores(pending, self.k)
