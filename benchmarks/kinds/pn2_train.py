"""Training the PointNet++ SSG classifier in a closed loop: one unit is one
call of the program's fused train step (``make_fused_train_step``, as
``cli.train --variant 1v_pn2`` builds it: the crop of each sample's closing
region, the train-mode ``PointNet2ClsSSG`` with its sampling and grouping
on K7, masked NLL, backward, Adam) on the next batch of the mix's pool.

Inputs as the training kind's (``generate.grasp_batches``); weights uniform
in +-1/sqrt(fan_in) from the seed, as torch initializes them, and the
BatchNorm scales and shifts as ``weights.make`` draws them.

The check is the training kind's (``kinds/train.py``: the first step's
loss, its gradient and the change over the checked steps, then the step
after the window from a copy of the program's state), against
``reference/pointnet2.py`` on the reference's own crop, plus
``sample_mismatch``: the program's FPS and ball-query indices, recorded as
the checked steps and the step after the window ran, that differ from the
reference's on the crop the program's model took. The recording wraps the
program's sampling functions around those steps only, never in the window.

``control`` puts the reference in the program's place: every MLP product
in TF32 (no ``fault``), or in float32 with a planted fault: its sampling
with ``fps_random_start`` (each FPS starts at a random index) or
``pad_zero`` (the ball query pads with index 0), or ``float64`` (the
witness of float32's own rounding).
"""

from __future__ import annotations

import contextlib
import math

import torch

from benchmarks import generate
from benchmarks.counts.pointnet2 import train_flops
from benchmarks.draws import generator
from benchmarks.kinds import train as train_kind
from benchmarks.reference import pointnet as ref_pointnet
from benchmarks.reference import pointnet2 as ref
from benchmarks.reference import train as ref_train

FAULTS = ref.FAULTS + ("float64",)


def make_weights(config: dict, seed: int, device) -> dict:
    """name -> float32 tensor from a single draw of the seed: linear and
    convolution weights and biases uniform in +-1/sqrt(fan_in), BatchNorm
    scales and running variances in [0.5, 1.5), shifts and running means in
    [-0.1, 0.1)."""
    shapes = ref.param_shapes(config)
    u = torch.rand(sum(math.prod(s) for _, s in shapes),
                   generator=generator(device, seed, "pn2_weights"),
                   device=device)
    out, off, fan = {}, 0, 1
    for name, shape in shapes:
        n = math.prod(shape)
        x = u[off:off + n].reshape(shape)
        off += n
        kind = name.rsplit(".", 1)[1]
        if ".mlp_bns." in name or name.startswith("bn"):
            v = 0.5 + x if kind in ("weight", "running_var") \
                else (x - 0.5) * 0.2
        else:
            if kind == "weight":
                fan = math.prod(shape[1:])
            v = (x * 2 - 1) / math.sqrt(fan)
        out[name] = v.contiguous()
    return out


class Cell(train_kind.Cell):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from pointnetgpd_tpu_torch.models.pointnet2 import PointNet2ClsSSG
        from pointnetgpd_tpu_torch.ops import pointnet2_sample
        from pointnetgpd_tpu_torch.training.train import (
            init_train_state, make_fused_train_step, make_optimizer)

        self.t, self.c, self.seed, self.dev = traffic, config, seed, device
        t = traffic
        self.sampling = pointnet2_sample
        self.params = make_weights(config, seed, device)
        with torch.device(device):
            model = PointNet2ClsSSG(k=config["k"])
        missing, unexpected = model.load_state_dict(self.params,
                                                    strict=False)
        if unexpected or any(not m.endswith("num_batches_tracked")
                             for m in missing):
            raise RuntimeError(f"weights do not fit the program's model: "
                               f"missing {missing}, unexpected {unexpected}")
        self.state = init_train_state(model.train(), make_optimizer(
            t["lr"], t["lr_step_size"], t["lr_gamma"], t["steps_per_epoch"]))
        self.step_fn = make_fused_train_step(
            num_points=t["num_points"], min_point_limit=t["min_points"])
        self.batches = generate.grasp_batches(t, seed, device)
        self.items_per_unit = t["batch"]
        self.flops_per_unit = t["batch"] * train_flops(config)
        self.recorded, self._ref_idx = {}, {}
        named = dict(model.named_parameters())
        start = {n: p.detach().clone() for n, p in named.items()}
        self.losses = []
        for s in range(t["checked_steps"]):
            with self._recording(s):
                self.losses.append(self._step(s)["loss"])
            if s == 0:
                self.grad_norms = {n: g.norm() for n, g in
                                   self._first_moments(named).items()}
        self.change_norms = {n: (p.detach() - start[n]).norm()
                             for n, p in named.items()}

    @contextlib.contextmanager
    def _recording(self, s: int):
        """Keep step s's crop (the model's input) and every index its
        sampling and grouping returned, in call order."""
        mod, model = self.sampling, self.state.model
        got = self.recorded[s] = {"fps": [], "ball": []}
        fps, ball = mod.farthest_point_sample, mod.ball_query

        def kept(fn, key):
            def wrapped(*a, **kw):
                out = fn(*a, **kw)
                got[key].append(out.clone())
                return out
            return wrapped

        hook = model.register_forward_pre_hook(
            lambda m, args: got.__setitem__("x", args[0].detach().clone()))
        mod.farthest_point_sample = kept(fps, "fps")
        mod.ball_query = kept(ball, "ball")
        try:
            yield
        finally:
            mod.farthest_point_sample, mod.ball_query = fps, ball
            hook.remove()

    def _after_window(self, units: int, run: bool = True):
        if not run:
            return super()._after_window(units, run)
        with self._recording(self.t["checked_steps"] + units):
            return super()._after_window(units, run)

    def _steps(self, s_after: int):
        return list(range(self.t["checked_steps"])) + [s_after]

    def _indices(self, s: int, fault=None) -> dict:
        """Step s's indices by the reference on its own crop (``fault``
        planted where it is a sampling fault). Kept per (step, fault)."""
        key = (s, fault if fault in ref.FAULTS else None)
        if key not in self._ref_idx:
            x = self._batch(s)[0]
            gen = generator(self.dev, self.seed, s, "pn2_fault")
            self._ref_idx[key] = ref.sample(x, self.c, key[1], gen)
        return self._ref_idx[key]

    def _batches(self, steps, fault):
        return [self._batch(s, fault) + (self._indices(s, fault),)
                for s in steps]

    def reference(self, *, tf32: bool = False, fault=None):
        """(losses, first gradients' norms, changes' norms) of the checked
        steps, plain."""
        dtype = torch.float64 if fault == "float64" else torch.float32
        params = {k: v.to(dtype).clone() for k, v in self.params.items()}
        start = {k: v.clone() for k, v in params.items()}
        batches = self._batches(range(self.t["checked_steps"]), fault)
        losses, grads = ref.run_steps(params, batches, self.c, lr=self.lr,
                                      tf32=tf32)
        names = [n for n in params if ref_pointnet.is_trainable(n)]
        return (losses, {n: float(grads[n].float().norm()) for n in names},
                {n: float((params[n] - start[n]).float().norm())
                 for n in names})

    def reference_after(self, s: int, copy: dict, *, tf32: bool = False,
                        fault=None):
        """(loss, gradient norms, change norms) of step s taken by the
        reference from the copy of the program's state."""
        dtype = torch.float64 if fault == "float64" else torch.float32
        params = {k: v.to(dtype).clone() for k, v in copy["params"].items()}
        m = {k: v.to(dtype).clone() for k, v in copy["m"].items()}
        v = {k: x.to(dtype).clone() for k, x in copy["v"].items()}
        start = {k: x.clone() for k, x in params.items()}
        (x, labels, w, idx), = self._batches([s], fault)
        loss, grads = ref.gradients(params, x, labels, w, self.c, idx,
                                    tf32=tf32)
        ref_train.adam_step(params, grads, m, v, s + 1, self.lr(s))
        return (loss, {n: float(g.float().norm()) for n, g in grads.items()},
                {n: float((params[n] - start[n]).float().norm())
                 for n in grads})

    def moved(self, s: int, params: dict) -> list[str]:
        """Leaves whose float64 reference gradient at ``params`` on step s's
        batch is at least a thousandth of the median leaf's."""
        p64 = {k: v.double() for k, v in params.items()}
        (x, labels, w, idx), = self._batches([s], "float64")
        _, grads = ref.gradients(p64, x, labels, w, self.c, idx)
        norms = {n: float(g.norm()) for n, g in grads.items()}
        med = float(torch.tensor(list(norms.values())).median())
        return [n for n, g in norms.items() if g >= 1e-3 * med]

    def _sample_mismatch(self, steps, got) -> int:
        """Index entries of ``got`` (step -> {"x", "fps", "ball"}) that
        differ from the reference's on the same crop; a missing or
        misshapen tensor counts all of its entries."""
        bad = 0
        for s in steps:
            rec = got[s]
            want = ref.sample(rec["x"], self.c)
            names = sorted(k for k in want if k.endswith(".fps"))
            for kind in ("fps", "ball"):
                keys = [n.replace(".fps", f".{kind}") for n in names]
                for i, k in enumerate(keys):
                    w = want[k]
                    g = rec[kind][i] if i < len(rec[kind]) else None
                    if g is None or g.shape != w.shape:
                        bad += w.numel()
                    else:
                        bad += int((g.to(w.device) != w).sum())
        return bad

    def _compare(self, first, after, r_first, r_after, s, copy, got,
                 limits):
        out = self.compare(first, after, r_first, r_after,
                           self.moved(0, self.params),
                           self.moved(s, copy["params"]), limits)
        return dict(out, sample_mismatch={
            "value": self._sample_mismatch(self._steps(s), got),
            "limit": limits["sample_mismatch"]})

    def control(self, units: int, limits: dict, fault=None) -> dict:
        """The check with the reference in the program's place: its MLP
        products in TF32 (no ``fault``), or in float32 with the fault
        planted; a sampling fault's indices stand for the program's."""
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; faults: {FAULTS}")
        s, copy, _ = self._after_window(units, run=False)
        got = {}
        for i in self._steps(s):
            idx = self._indices(i, fault)
            got[i] = {"x": self._batch(i)[0],
                      "fps": [v for k, v in sorted(idx.items())
                              if k.endswith(".fps")],
                      "ball": [v for k, v in sorted(idx.items())
                               if k.endswith(".ball")]}
        tf32 = fault is None
        return self._compare(
            self.reference(tf32=tf32, fault=fault),
            self.reference_after(s, copy, tf32=tf32, fault=fault),
            self.reference(), self.reference_after(s, copy), s, copy, got,
            limits)

    def check(self, units: int, limits: dict) -> dict:
        first = ([float(x) for x in self.losses],
                 {n: float(v) for n, v in self.grad_norms.items()},
                 {n: float(v) for n, v in self.change_norms.items()})
        s, copy, after = self._after_window(units)
        return self._compare(first, after, self.reference(),
                             self.reference_after(s, copy), s, copy,
                             self.recorded, limits)

