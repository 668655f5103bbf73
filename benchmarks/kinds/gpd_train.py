"""Training the GPD baseline in a closed loop: one unit is one call of the
program's GPD train step (``make_gpd_train_step``, as ``cli.train
--variant fullv_gpd`` builds it: per sample the crop of its own cloud,
k-NN normals within the crop, the projection images, the CNN, masked NLL,
backward, Adam) on the next batch of the mix's pool.

Inputs: each sample's cloud holds ``cloud_points`` points spread over the
six faces of a box by area (sides drawn in ``box_side_m``, turned by a
random rotation), standing in for a merged multi-view cloud; grasps follow
``generate.grasp_batches``: centred at the cloud's mean plus Gaussian
noise, random axis and approach angle, the 2-class label bands. Weights are
uniform in +-1/sqrt(fan_in) from the seed, as torch initializes them.

The check holds the two halves of the step apart. The features: the
program's own feature function (the one its step calls) under the same
draws, on every step whose features the reference trains on (the checked
steps and the step after the window), against
``reference/gpd.py``'s crop, float64 normals and projection walk:
``features_gap`` is the share of their cells (size x size x channels, over
the samples whose crop is valid on either side) more than 1e-5 apart. A
point near a voxel face or a near tie among its neighbours moves a cell or
two; a wrong order, sign or image moves hundreds. The training: as the
training kind's (``kinds/train.py``), the first step's loss, its gradient
and the change over the checked steps, then the step after the window from
a copy of the program's state, with the reference's CNN, loss and Adam
trained on the program's features of those steps. The features' own
disagreement (near ties decided apart in float32) would otherwise move the
loss and the gradients by more than TF32 does (PERF.md).

``control`` puts the reference in the program's place, its features
standing for the program's: every convolution and product in TF32 (no
``fault``), or in float32 with a planted fault: ``half_batch`` (half of
each batch left out of the loss), ``unflipped`` (normals not turned toward
the camera), ``swapped_orders`` (the second and third projection orders
swapped) or ``float64`` (the witness of float32's own rounding).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmarks.counts.gpd import train_flops
from benchmarks.draws import UnitDraws, generator
from benchmarks.generate import random_rotations
from benchmarks.kinds import train as train_kind
from benchmarks.reference import gpd as ref

FEATURE_TOL = 1e-5
FAULTS = ("half_batch", "unflipped", "swapped_orders", "float64")


class GPDDraws(UnitDraws):
    """``UnitDraws`` with the per-sample crop's draws: selection keys and
    ranks, each row drawn for its sample alone."""

    def crop_keys(self, g: int, p_len: int):
        return self._rand("crop_keys", g, p_len)

    def crop_ranks(self, count, num_out: int):
        return self._below("crop_ranks", count, (count.shape[0], num_out))

    def per_sample(self, n: int):
        return self


def _norm(t) -> float:
    """The norm of ``t`` taken in float32, as the program's are: the float64
    witness is judged by its values, not by a more exact norm (on the CPU a
    float32 norm of fc1's 3.6 million weights is off by 1e-4 relative)."""
    return float(t.float().norm())


def box_clouds(t: dict, seed: int, s: int, device):
    """(B, P, 3) points on the six faces of a box per sample, spread by
    area: sides uniform in ``box_side_m``, a uniform random rotation."""
    b, p = t["batch"], t["cloud_points"]
    gen = generator(device, seed, "box_clouds", s)
    lo, hi = t["box_side_m"]
    sides = lo + (hi - lo) * torch.rand((b, 3), generator=gen, device=device)
    # faces 2a and 2a + 1 are normal to axis a, of area of the other two
    area = torch.stack([sides[:, 1] * sides[:, 2], sides[:, 0] * sides[:, 2],
                        sides[:, 0] * sides[:, 1]], 1).repeat_interleave(2, 1)
    cum = torch.cumsum(area, 1)
    u = torch.rand((b, p), generator=gen, device=device) * cum[:, -1:]
    face = torch.clamp(torch.searchsorted(cum, u), max=5)
    pts = (torch.rand((b, p, 3), generator=gen, device=device) - 0.5) \
        * sides[:, None]
    axis = face // 2
    sign = (face % 2).to(pts.dtype) * 2 - 1
    side = torch.gather(sides, 1, axis)
    pts.scatter_(2, axis[..., None], (sign * side / 2)[..., None])
    rot = random_rotations(b, gen, device)
    return (pts @ rot).contiguous()


def grasp_batches(t: dict, seed: int, device):
    """[(grasps (B, 12), clouds (B, P, 3), transforms (B, 4, 4), labels
    (B,), weights (B,)), ...] of the pool, in ``generate.grasp_batches``'
    form."""
    b = t["batch"]
    out = []
    for s in range(t["pool"]):
        clouds = box_clouds(t, seed, s, device)
        gen = generator(device, seed, "gpd_grasps", s)
        grasps = torch.zeros((b, 12), device=device)
        grasps[:, 0:3] = clouds.mean(dim=1) + torch.randn(
            (b, 3), generator=gen, device=device) * t["center_sigma_m"]
        axes = torch.randn((b, 3), generator=gen, device=device)
        grasps[:, 3:6] = axes / axes.norm(dim=1, keepdim=True)
        grasps[:, 6] = t["width_m"]
        grasps[:, 7] = (torch.rand((b,), generator=gen, device=device)
                        * 2 - 1) * np.pi
        lo, hi = t["friction_score_range"]
        grasps[:, 10] = lo + (hi - lo) * torch.rand((b,), generator=gen,
                                                    device=device)
        grasps[:, 11] = torch.rand((b,), generator=gen, device=device)
        score = grasps[:, 10] + grasps[:, 11] * 0.01
        labels = torch.where(score >= t["thresh_bad"], 0, 1)
        weights = ((score >= t["thresh_bad"])
                   | (score <= t["thresh_good"])).float()
        transforms = torch.eye(4, device=device).expand(b, 4, 4).contiguous()
        out.append((grasps, clouds, transforms, labels, weights))
    return out


def make_weights(config: dict, seed: int, device) -> dict:
    """name -> float32 tensor, uniform in +-1/sqrt(fan_in), from a single
    draw of the seed."""
    shapes = ref.param_shapes(config["input_chann"], config["conv"],
                              config["fc"], config["k"], config["image_size"])
    u = torch.rand(sum(math.prod(s) for _, s in shapes),
                   generator=generator(device, seed, "gpd_weights"),
                   device=device)
    out, off, fan = {}, 0, 1
    for name, shape in shapes:
        n = math.prod(shape)
        if name.endswith("weight"):
            fan = math.prod(shape[1:])
        out[name] = ((u[off:off + n] * 2 - 1) / math.sqrt(fan)) \
            .reshape(shape).contiguous()
        off += n
    return out


class Cell(train_kind.Cell):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from pointnetgpd_tpu_torch.models.gpd import GPDClassifier
        from pointnetgpd_tpu_torch.training.train import (
            init_train_state, make_gpd_feature_fn, make_gpd_train_step,
            make_optimizer)

        self.t, self.c, self.seed, self.dev = traffic, config, seed, device
        t, c = traffic, config
        self.params = make_weights(config, seed, device)
        with torch.device(device):
            model = GPDClassifier(c["input_chann"], dropout=c["dropout"])
        model.load_state_dict(self.params)
        self.state = init_train_state(model, make_optimizer(
            t["lr"], t["lr_step_size"], t["lr_gamma"], t["steps_per_epoch"]))
        kw = dict(num_points=t["num_points"], project_chann=c["input_chann"],
                  min_point_limit=t["min_points"], knn_k=c["knn_k"])
        self.step_fn = make_gpd_train_step(**kw)
        self.features_fn = make_gpd_feature_fn(**kw)
        self.batches = grasp_batches(t, seed, device)
        self.items_per_unit = t["batch"]
        self.flops_per_unit = t["batch"] * train_flops(config)
        self._ref = {}
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

    def _draws(self, s: int):
        return GPDDraws(self.seed, s, self.dev)

    def _step(self, s: int):
        b = self.batches[s % len(self.batches)]
        return self.step_fn(self.state, *b, self._draws(s))[1]

    def _crop(self, s: int):
        """Step s's crops by the reference: (points, counts, valid)."""
        grasps, clouds, transforms, _, _ = self.batches[s % len(self.batches)]
        d = self._draws(s).per_sample(grasps.shape[0])
        keys = d.crop_keys(grasps.shape[0], ref.key_width(clouds.shape[1]))
        return ref.crop(grasps, clouds, transforms, keys,
                        lambda n: d.crop_ranks(n, self.t["num_points"]),
                        num_out=self.t["num_points"],
                        min_points=self.t["min_points"])

    def _ref_features(self, s: int, fault=None):
        """Step s's features by the reference, with a feature fault
        planted: (features, crop validity). Kept per (step, fault)."""
        key = (s, fault if fault in ("unflipped", "swapped_orders") else None)
        if key not in self._ref:
            c = self.c
            pts, _, valid = self._crop(s)
            nrm = ref.normals(pts, k=c["knn_k"], flip=fault != "unflipped")
            orders = ref.ORDERS
            if fault == "swapped_orders":
                orders = (orders[0], orders[2], orders[1])
            grasps = self.batches[s % len(self.batches)][0]
            feats = ref.features(pts, nrm, grasps[:, 6],
                                 chann=c["input_chann"], orders=orders,
                                 size=c["image_size"], margin=c["margin"],
                                 voxel_point_num=c["voxel_point_num"])
            self._ref[key] = (feats, valid)
        return self._ref[key]

    def _program_features(self, s: int):
        """Step s's features by the program's own feature function, under
        step s's draws: (features, crop validity)."""
        grasps, clouds, transforms, _, _ = self.batches[s % len(self.batches)]
        with torch.no_grad():
            return self.features_fn(grasps, clouds, transforms,
                                    self._draws(s))

    def _batch(self, s: int, fault=None):
        """Step s's batch as the CNN trains on it, from the features under
        test (``self.feats``): (features, labels, weights)."""
        _, _, _, labels, w = self.batches[s % len(self.batches)]
        x, valid = self.feats[s]
        w = w * valid.float()
        if fault == "half_batch":
            w = torch.where(torch.arange(w.shape[0], device=w.device)
                            < w.shape[0] // 2, w, 0.0)
        if fault == "float64":
            x = x.double()
        return x, labels, w

    def reference(self, *, tf32: bool = False, fault=None):
        """(losses, first gradients' norms, changes' norms) of the checked
        steps, plain."""
        dtype = torch.float64 if fault == "float64" else torch.float32
        params = {k: v.to(dtype).clone() for k, v in self.params.items()}
        start = {k: v.clone() for k, v in params.items()}
        batches = [self._batch(s, fault)
                   for s in range(self.t["checked_steps"])]
        losses, grads = ref.run_steps(params, batches, lr=self.lr, tf32=tf32)
        return (losses, {n: _norm(g) for n, g in grads.items()},
                {n: _norm(params[n] - start[n]) for n in params})

    def reference_after(self, s: int, copy: dict, *, tf32: bool = False,
                        fault=None):
        """(loss, gradient norms, change norms) of step s taken by the
        reference from the copy of the program's state."""
        dtype = torch.float64 if fault == "float64" else torch.float32
        params = {k: v.to(dtype).clone() for k, v in copy["params"].items()}
        m = {k: v.to(dtype).clone() for k, v in copy["m"].items()}
        v = {k: x.to(dtype).clone() for k, x in copy["v"].items()}
        start = {k: x.clone() for k, x in params.items()}
        loss, grads = ref.gradients(params, *self._batch(s, fault),
                                    tf32=tf32)
        ref.adam_step(params, grads, m, v, s + 1, self.lr(s))
        return (loss, {n: _norm(g) for n, g in grads.items()},
                {n: _norm(params[n] - start[n]) for n in grads})

    def moved(self, s: int, params: dict) -> list[str]:
        """Leaves whose float64 reference gradient at ``params`` on step s's
        batch is at least a thousandth of the median leaf's."""
        p64 = {k: v.double() for k, v in params.items()}
        _, grads = ref.gradients(p64, *self._batch(s, "float64"))
        norms = {n: float(g.norm()) for n, g in grads.items()}
        med = float(torch.tensor(list(norms.values())).median())
        return [n for n, g in norms.items() if g >= 1e-3 * med]

    def _features_gap(self, steps) -> float:
        """Share of the feature cells of ``steps`` over 1e-5 from the
        reference's, over the samples valid on either side."""
        off = total = 0
        for s in steps:
            (feats, valid), (r_feats, r_valid) = self.feats[s], \
                self._ref_features(s)
            rows = valid | r_valid
            diff = (feats[rows].float() - r_feats[rows]).abs() > FEATURE_TOL
            off, total = off + int(diff.sum()), total + diff.numel()
        return off / max(total, 1)

    def _compare(self, first, after, r_first, r_after, s, copy, limits):
        """The training kind's numbers, then ``features_gap`` over every
        step the reference trains on."""
        out = self.compare(first, after, r_first, r_after,
                           self.moved(0, self.params),
                           self.moved(s, copy["params"]), limits)
        _, counts, _ = self._crop(0)
        self.detail.update(
            crops_under_num_points=float(
                (counts < self.t["num_points"]).float().mean()),
            crops_under_min_points=float(
                (counts < self.t["min_points"]).float().mean()))
        return dict(out, features_gap={
            "value": self._features_gap(self._steps(s)),
            "limit": limits["features_gap"]})

    def _steps(self, s_after: int):
        return list(range(self.t["checked_steps"])) + [s_after]

    def control(self, units: int, limits: dict, fault=None) -> dict:
        """The check with the reference in the program's place: its
        features (with ``fault`` planted if it is a feature fault) stand for
        the program's, and its CNN runs in TF32 (no ``fault``) or in float32
        with the fault planted."""
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; faults: {FAULTS}")
        s, copy, _ = self._after_window(units, run=False)
        self.feats = {i: self._ref_features(i, fault)
                      for i in self._steps(s)}
        tf32 = fault is None
        return self._compare(
            self.reference(tf32=tf32, fault=fault),
            self.reference_after(s, copy, tf32=tf32, fault=fault),
            self.reference(), self.reference_after(s, copy), s, copy,
            limits)

    def check(self, units: int, limits: dict) -> dict:
        first = ([float(x) for x in self.losses],
                 {n: float(v) for n, v in self.grad_norms.items()},
                 {n: float(v) for n, v in self.change_norms.items()})
        s, copy, after = self._after_window(units)
        self.feats = {i: self._program_features(i) for i in self._steps(s)}
        return self._compare(first, after, self.reference(),
                             self.reference_after(s, copy), s, copy, limits)
