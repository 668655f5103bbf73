"""The data-parallel train step on the ranks of a process group, as a check.

``run_step_ranks`` writes a spec, starts ``world`` ranks
(``parallel.dist.spawn``) that each run ``step_rank`` on their rows of the
spec's global batches, and returns what each rank saw. The tests and
``chip_smoke.py`` hold these results against the one-process step on the
same global batch and draws.

A spec is a dict:

- ``device``: the ranks' device (``"cpu"``, ``"cuda:0"``: every rank on it,
  or ``"cuda"``: rank r on card r);
- ``cases``: a list of dicts, each ``name``, ``gpd`` (bool), ``model``
  (the module, as the one-process step starts from it), ``batch`` (the
  global (grasps, clouds, transforms, labels, weights) as numpy arrays),
  ``num_points``, ``min_point_limit``, ``fused_maxpool``,
  ``compute_dtype`` (optional, the fused step's), ``lr``, and the
  draws: ``tape`` (a ``RecordDraws.tape`` of the one-process step, replayed
  on each rank; every count a rank gathers must equal the recorded one) or
  ``seed`` (``Draws(seed)`` on the rank's device); ``eval_seed``
  (optional): first one eval pass of the model on the same global batch,
  cropped with ``Draws(eval_seed)``; ``steps`` (default 1): steps taken,
  the first one reported; ``time_steps`` (default 0): then further steps,
  timed on the host clock between device synchronizations.

Each rank returns, per case: the loss and metrics, the summed gradients,
the buffers and parameters after the first step, the eval pass's sums
with the K2 launches this rank made in it, and ms per timed step. Every rank
steps over the process group, a group of one included (its collectives run
on the backend all the same).
"""

from __future__ import annotations

import copy
import os
import tempfile
import time

import numpy as np
import torch


class RecordDraws:
    """Wraps a draws source and records every call and its result."""

    def __init__(self, base, tape=None):
        self.base = base
        self.tape = [] if tape is None else tape

    def _call(self, name, *args):
        out = getattr(self.base, name)(*args)
        self.tape.append((name, tuple(a.detach().cpu() if isinstance(
            a, torch.Tensor) else a for a in args), _cpu(out)))
        return out

    def __getattr__(self, name):
        if name in ("crop_perm", "crop_windows", "crop_keys", "crop_ranks",
                    "resample"):
            return lambda *a: self._call(name, *a)
        raise AttributeError(name)

    def per_sample(self, n):
        self.tape.append(("per_sample", (n,), None))
        return RecordDraws(self.base.per_sample(n), self.tape)


class ReplayDraws:
    """Replays a ``RecordDraws`` tape, call for call; raises where a call
    or its arguments differ from the recorded ones."""

    def __init__(self, tape, device):
        self.tape, self.i, self.device = tape, 0, torch.device(device)

    def _next(self, name, args):
        want, want_args, out = self.tape[self.i]
        self.i += 1
        got = tuple(a.detach().cpu() if isinstance(a, torch.Tensor) else a
                    for a in args)
        same = len(got) == len(want_args) and all(
            torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            for a, b in zip(got, want_args))
        if want != name or not same:
            raise RuntimeError(f"draw {self.i - 1}: {name}{got} asked, "
                               f"{want}{want_args} recorded")
        return _to(out, self.device)

    def __getattr__(self, name):
        if name in ("crop_perm", "crop_windows", "crop_keys", "crop_ranks",
                    "resample"):
            return lambda *a: self._next(name, a)
        raise AttributeError(name)

    def per_sample(self, n):
        self._next("per_sample", (n,))
        return self


def _cpu(x):
    if isinstance(x, tuple):
        return tuple(_cpu(t) for t in x)
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def _to(x, dev):
    if isinstance(x, tuple):
        return tuple(_to(t, dev) for t in x)
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def _device(spec_device, rank):
    dev = torch.device(spec_device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def step_rank(rank, world, spec_path, out_dir):
    """One rank: every case of the spec on this rank's rows."""
    import torch.distributed as dist

    from ..draws import Draws
    from ..training import train as ttrain
    from . import dist as pdist

    spec = torch.load(spec_path, weights_only=False)
    dev = _device(spec["device"], rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = dist.group.WORLD
    results = []
    for case in spec["cases"]:
        model = copy.deepcopy(case["model"]).to(dev)
        state = ttrain.init_train_state(
            model, ttrain.make_optimizer(case.get("lr", 0.005)))
        kw = dict(num_points=case["num_points"],
                  min_point_limit=case["min_point_limit"], group=group)
        step = (ttrain.make_gpd_train_step(**kw) if case["gpd"] else
                ttrain.make_fused_train_step(
                    fused_maxpool=case.get("fused_maxpool", False),
                    compute_dtype=case.get("compute_dtype"), **kw))
        base = (ReplayDraws(case["tape"], dev) if "tape" in case
                else Draws(case["seed"], dev))
        draws = pdist.group_draws(base, group, dev)
        b = case["batch"][0].shape[0] // world
        rows = [torch.as_tensor(np.asarray(a)[rank * b:(rank + 1) * b]).to(
            dev) for a in case["batch"]]
        rows[3], rows[4] = rows[3].long(), rows[4].float()
        ev = (_eval_rows(state.model, rows, case, group, dev)
              if "eval_seed" in case else None)
        state, metrics = step(state, *rows, draws)
        out = {"name": case["name"],
               "metrics": {k: float(v) for k, v in metrics.items()},
               "grads": {n: p.grad.detach().cpu().clone()
                         for n, p in state.model.named_parameters()},
               "params": {n: p.detach().cpu().clone()
                          for n, p in state.model.named_parameters()},
               "buffers": {n: v.detach().cpu().clone()
                           for n, v in state.model.named_buffers()}}
        if ev is not None:
            out["eval"] = ev
        for _ in range(case.get("steps", 1) - 1):
            state, _ = step(state, *rows, draws)
        n_time = case.get("time_steps", 0)
        if n_time:
            _sync(dev)
            dist.barrier(group)
            t0 = time.perf_counter()
            for _ in range(n_time):
                state, metrics = step(state, *rows, draws)
            float(metrics["loss"])
            _sync(dev)
            out["ms"] = (time.perf_counter() - t0) * 1e3 / n_time
        results.append(out)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def _eval_rows(model, rows, case, group, dev):
    """The trainer's eval pass on this rank's rows: (sums, K2 launches)."""
    from ..draws import Draws
    from ..ops import pointnet_trunk as k2
    from ..ops.crop import collect_grasp_clouds_batched
    from ..training import train as ttrain
    from . import dist as pdist

    draws = pdist.group_draws(Draws(case["eval_seed"], dev), group, dev)
    cropped, _, valid = collect_grasp_clouds_batched(
        *rows[:3], draws, num_out=case["num_points"],
        min_point_limit=case["min_point_limit"])
    n0 = k2.launches
    sums = ttrain.make_eval_step(group)(model, cropped, rows[3],
                                        rows[4] * valid.float())
    return ({k: float(v) for k, v in sums.items()}, k2.launches - n0)


def run_step_ranks(spec, world: int, backend: str, timeout: float = 300.0):
    """Run ``spec`` on ``world`` ranks; returns each rank's results (a list
    per rank, in rank order)."""
    from .dist import spawn

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spec.pt")
        torch.save(spec, path)
        spawn(step_rank, world, backend, args=(path, tmp), timeout=timeout)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
