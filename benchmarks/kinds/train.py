"""Training in a closed loop: one unit is one call of the program's fused
train step (crop of each sample's closing region, train-mode PointNet,
masked NLL loss, backward, Adam) on the next batch of the mix's pool.

Set-up builds the one train state, drives it through its first steps
(through the window's own call, on different batches) and hands it to the
window. The reference follows those first steps from the same weights, on
the same batches and draws: the first step's loss (the later steps' losses
swing by rounding under Adam, PERF.md), the first gradient as Adam got it
(its first moment after one step over 1 - beta1) and the change of the
parameters over the steps, both by the worst leaf.

After the window the state is copied (parameters and Adam's moments) and
one more step runs through the same call: the window's path, after all of
its steps. The reference takes that step from the copy (the window's steps
it cannot follow: Adam's rounding compounds over hundreds of them), and the
step's loss, its gradient (from the first moment's change) and its change
of the parameters are compared as above, the change by the median leaf: it
is nine tenths the momentum both sides share, so its worst leaf only echoes
the gradient's (PERF.md).

Leaves whose reference gradient, taken in float64, is under a thousandth
of the median leaf's are left out: they move under Adam by rounding alone
(the biases that a BatchNorm cancels; in float32 their rounding noise can
pass the thousandth).
"""

from __future__ import annotations

import torch

from .. import generate, program, weights
from ..counts.pointnet import train_flops
from ..draws import UnitDraws
from ..reference import pointnet
from ..reference import train as ref_train


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from pointnetgpd_tpu_torch.training.train import (
            init_train_state, make_fused_train_step, make_optimizer)

        self.t, self.seed, self.dev = traffic, seed, device
        t = traffic
        self.params = weights.make(config, seed, device)
        model = program.pointnet_cls(config, self.params, device, train=True)
        self.state = init_train_state(model, make_optimizer(
            t["lr"], t["lr_step_size"], t["lr_gamma"], t["steps_per_epoch"]))
        self.step_fn = make_fused_train_step(
            num_points=t["num_points"], min_point_limit=t["min_points"])
        self.batches = generate.grasp_batches(t, seed, device)
        self.items_per_unit = t["batch"]
        self.flops_per_unit = t["batch"] * train_flops(t["num_points"],
                                                       config["k"])
        named = dict(model.named_parameters())
        start = {n: p.detach().clone() for n, p in named.items()}
        self.losses = []
        for s in range(t["checked_steps"]):
            self.losses.append(self._step(s)["loss"])
            if s == 0:
                self.grad_norms = {n: g.norm() for n, g in
                                   self._first_moments(named).items()}
        self.change_norms = {n: (p.detach() - start[n]).norm()
                             for n, p in named.items()}

    def _first_moments(self, named, before=None):
        """Each leaf's gradient as Adam got it in its last update, from its
        first moment (and the one ``before`` it); a leaf the optimizer got
        no gradient for reads 0."""
        opt = self.state.optimizer
        out = {}
        for n, p in named.items():
            m = opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
            m0 = before[n] if before else 0.0
            out[n] = (m - ref_train.BETA1 * m0) / (1 - ref_train.BETA1)
        return out

    def _step(self, s: int):
        b = self.batches[s % len(self.batches)]
        return self.step_fn(self.state, *b, UnitDraws(self.seed, s,
                                                      self.dev))[1]

    def lr(self, s: int) -> float:
        """Update s's learning rate (StepLR over epochs of the pool)."""
        t = self.t
        return t["lr"] * t["lr_gamma"] ** ((s // t["steps_per_epoch"])
                                           // t["lr_step_size"])

    def flops_done(self, units: int) -> float:
        return units * self.flops_per_unit

    def unit(self, i: int):
        self._step(i + self.t["checked_steps"])

    def _after_window(self, units: int, run: bool = True):
        """Copy the state the window left, then (``run``) take one more
        step through the window's call. Returns (step index, the copy, the
        program's (loss, gradient norms, change norms) or None)."""
        s = self.t["checked_steps"] + units
        named = dict(self.state.model.named_parameters())
        opt = self.state.optimizer
        copy = {"params": {n: p.detach().clone() for n, p in named.items()},
                "m": {}, "v": {}}
        for n, p in named.items():
            st = opt.state.get(p, {})
            copy["m"][n] = st.get("exp_avg", torch.zeros_like(p)).clone()
            copy["v"][n] = st.get("exp_avg_sq", torch.zeros_like(p)).clone()
        got = None
        if run:
            loss = float(self._step(s)["loss"])
            grads = self._first_moments(named, copy["m"])
            got = (loss, {n: float(g.norm()) for n, g in grads.items()},
                   {n: float((p.detach() - copy["params"][n]).norm())
                    for n, p in named.items()})
        del self.state, self.step_fn
        program.free_cuda()
        return s, copy, got

    def _batch(self, s: int, fault=None):
        """Step s's batch cropped by the reference: (x, labels, weights)."""
        t = self.t
        grasps, clouds, transforms, labels, w = \
            self.batches[s % len(self.batches)]
        d = UnitDraws(self.seed, s, self.dev)
        perm = d.crop_perm(clouds.shape[1])
        x, valid = ref_train.crop_batch(
            grasps, clouds, transforms, perm,
            lambda c: d.crop_windows(c, t["num_points"]),
            num_out=t["num_points"], min_points=t["min_points"])
        w = w * valid.float()
        if fault == "half_batch":
            w = torch.where(torch.arange(w.shape[0], device=w.device)
                            < w.shape[0] // 2, w, 0.0)
        if fault == "float64":
            x = x.double()
        return x, labels, w

    def reference(self, *, tf32: bool = False, fault=None):
        """(losses, first gradients' norms, changes' norms) of the checked
        steps, plain. ``tf32``: every product in TF32, inputs in float32
        (the control); ``fault`` plants a fault of the calibration
        (``half_batch``) or runs the steps in float64 (``float64``, a
        witness of the float32 steps' own rounding)."""
        t = self.t
        dtype = torch.float64 if fault == "float64" else torch.float32
        params = {k: v.to(dtype).clone() for k, v in self.params.items()}
        start = {k: v.clone() for k, v in params.items()}
        batches = [self._batch(s, fault) for s in range(t["checked_steps"])]
        losses, grads = ref_train.run_steps(params, batches, lr=self.lr,
                                            tf32=tf32)
        names = [n for n in params if pointnet.is_trainable(n)]
        return (losses, {n: float(grads[n].norm()) for n in names},
                {n: float((params[n] - start[n]).norm()) for n in names})

    def reference_after(self, s: int, copy: dict, *, tf32: bool = False,
                        fault=None):
        """(loss, gradient norms, change norms) of step s taken by the
        reference from the copy of the program's state."""
        dtype = torch.float64 if fault == "float64" else torch.float32
        params = {k: v.to(dtype).clone() for k, v in copy["params"].items()}
        m = {k: v.to(dtype).clone() for k, v in copy["m"].items()}
        v = {k: x.to(dtype).clone() for k, x in copy["v"].items()}
        start = {k: x.clone() for k, x in params.items()}
        loss, grads = ref_train.gradients(params, *self._batch(s, fault),
                                          tf32=tf32)
        ref_train.adam_step(params, grads, m, v, s + 1, self.lr(s))
        return (loss, {n: float(g.norm()) for n, g in grads.items()},
                {n: float((params[n] - start[n]).norm()) for n in grads})

    def moved(self, s: int, params: dict) -> list[str]:
        """Leaves whose gradient at ``params`` on step s's batch, taken by
        the reference in float64, is at least a thousandth of the median
        leaf's."""
        p64 = {k: v.double() for k, v in params.items()}
        x, labels, w = self._batch(s, "float64")
        _, grads = ref_train.gradients(p64, x, labels, w)
        norms = {n: float(g.norm()) for n, g in grads.items()}
        med = float(torch.tensor(list(norms.values())).median())
        return [n for n, g in norms.items() if g >= 1e-3 * med]

    def control(self, units: int, limits: dict, fault=None) -> dict:
        """The check with the reference in TF32 (or, with ``fault``, in
        float32 with that fault planted) in the program's place."""
        s, copy, _ = self._after_window(units, run=False)
        tf32 = fault is None
        first = self.reference(tf32=tf32, fault=fault)
        after = self.reference_after(s, copy, tf32=tf32, fault=fault)
        return self.compare(first, after, self.reference(),
                            self.reference_after(s, copy),
                            self.moved(0, self.params),
                            self.moved(s, copy["params"]), limits)

    def check(self, units: int, limits: dict) -> dict:
        first = ([float(x) for x in self.losses],
                 {n: float(v) for n, v in self.grad_norms.items()},
                 {n: float(v) for n, v in self.change_norms.items()})
        s, copy, after = self._after_window(units)
        return self.compare(first, after, self.reference(),
                            self.reference_after(s, copy),
                            self.moved(0, self.params),
                            self.moved(s, copy["params"]), limits)

    def compare(self, first, after, r_first, r_after, moved, moved_after,
                limits):
        """The numbers compared over the leaves ``moved`` (the first steps)
        and ``moved_after`` (the step after the window); ``self.detail``
        keeps every checked step's loss gap and the worst leaves, for the
        calibration."""
        losses, grads, changes = first
        r_losses, r_grads, r_changes = r_first
        # the first step's loss: the later ones swing by rounding (PERF.md)
        steps = [abs(a - b) / abs(b) for a, b in zip(losses, r_losses)]
        a_loss, a_grads, a_changes = after
        ra_loss, ra_grads, ra_changes = r_after
        rows = {
            "grad": _by_leaf(grads, r_grads, moved),
            "update": _by_leaf(changes, r_changes, moved),
            "after_grad": _by_leaf(a_grads, ra_grads, moved_after),
            "after_update": _by_leaf(a_changes, ra_changes, moved_after)}
        values = (("loss_gap", steps[0]),
                  ("grad_gap", rows["grad"][0][1]),
                  ("update_gap", rows["update"][0][1]),
                  ("after_loss_gap", abs(a_loss - ra_loss) / abs(ra_loss)),
                  ("after_grad_gap", rows["after_grad"][0][1]),
                  ("after_update_median_gap",
                   _median_gap(a_changes, ra_changes, moved_after)))
        self.detail = {"loss_steps": steps, **rows,
                       "left_out": sorted(set(r_grads) - set(moved)),
                       "left_out_after": sorted(set(ra_grads)
                                                - set(moved_after))}
        return {name: {"value": v, "limit": limits[name]}
                for name, v in values}


def _median_gap(prog, ref, names):
    """The median over leaves of |prog - ref| / max(ref, the median leaf's
    ref)."""
    med = float(torch.tensor([ref[n] for n in names]).median())
    return float(torch.tensor([abs(prog[n] - ref[n]) / max(ref[n], med)
                               for n in names]).median())


def _by_leaf(prog, ref, names):
    """Leaves by |prog - ref| / max(ref, the median leaf's ref), the worst
    first: [[name, gap, ref], ...] (four) and ["median leaf", median]."""
    med = float(torch.tensor([ref[n] for n in names]).median())
    gaps = sorted(((abs(prog[n] - ref[n]) / max(ref[n], med), n)
                   for n in names), reverse=True)
    return [[n, g, ref[n]] for g, n in gaps[:4]] + [["median leaf", med]]
