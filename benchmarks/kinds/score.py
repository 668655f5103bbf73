"""Offline candidate scoring in a closed loop: one unit is one call of the
program's ``score_candidates_fused`` (crop, resample, PointNet with its
trunks on K2, vote, rank) on the next of the mix's scenes.

Checked after the window, on units drawn from the seed: each candidate's
count of points in its box (exactly) and its class probabilities against
the plain crop and PointNetCls on the same draws, and the program's ranking
by the reference's probabilities (``scoring.rank_gap``).
"""

from __future__ import annotations

import torch

from .. import generate, program, weights
from ..counts.pointnet import forward_flops
from ..draws import UnitDraws
from ..reference import crop, scoring


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from pointnetgpd_tpu_torch.inference.scorer import (
            score_candidates_fused)

        self.t, self.seed, self.dev = traffic, seed, device
        self.params = weights.make(config, seed, device)
        self.scenes = generate.box_scenes(traffic, seed, device)
        weights.calibrate(self.params, *self._balance_crops())
        self.model = program.pointnet_cls(config, self.params, device)
        g = traffic["candidates"]
        self.valid_in = torch.ones(g, dtype=torch.bool, device=device)
        self._score = score_candidates_fused
        self.items_per_unit = g
        self.flops_per_unit = g * forward_flops(traffic["num_points"],
                                                config["k"])
        for s in range(len(self.scenes)):       # every scene's shapes
            self._program(s, ("warm", s))
        self.sample = program.Sample(seed, traffic["check_units"])

    def _balance_crops(self, n_frames: int = 64):
        """Crops of the first scene's first frames, for the
        weights' calibration."""
        t = self.t
        pc, frames = self.scenes[0]
        frames = frames[:n_frames]
        d = UnitDraws(self.seed, "balance", self.dev)
        lo, hi = crop.online_box(frames.shape[0], t["hand_depth_m"],
                                 t["width_m"], self.dev)
        clouds, _, valid = crop.crop(
            pc[d.crop_perm(pc.shape[0])], frames[:, 0],
            crop.unit(frames[:, 1:4]), lo, hi,
            lambda c: d.crop_windows(c, t["num_points"]), t["num_points"],
            t["min_points"])
        return clouds, valid

    def _program(self, i, key):
        pc, frames = self.scenes[i % len(self.scenes)]
        t = self.t
        return self._score(self.model, pc, frames, self.valid_in,
                           t["hand_depth_m"], t["width_m"],
                           UnitDraws(self.seed, key, self.dev),
                           num_points=t["num_points"], repeat=1,
                           min_points=t["min_points"])

    def flops_done(self, units: int) -> float:
        return units * self.flops_per_unit

    def unit(self, i: int):
        self.sample.offer(i, self._program(i, i))

    def reference(self, i: int, *, tf32: bool = False):
        """(pred, prob, counts, valid, good, order) of unit i, plain;
        ``tf32``: every product of the PointNet in TF32, its inputs and the
        crop in float32 (the control)."""
        t = self.t
        pc, frames = self.scenes[i % len(self.scenes)]
        d = UnitDraws(self.seed, i, self.dev)
        g, n = frames.shape[0], t["num_points"]
        crop.check_shuffled_window(pc.shape[0], g)
        lo, hi = crop.online_box(g, t["hand_depth_m"], t["width_m"], self.dev)
        rows = crop.unit(frames[:, 1:4])
        perm = d.crop_perm(pc.shape[0])
        clouds, counts, valid = crop.crop(
            pc[perm], frames[:, 0], rows, lo, hi,
            lambda c: d.crop_windows(c, n), n, t["min_points"])
        idx = d.resample(g, n, n)
        pred, prob = scoring.score(self.params, clouds, valid, idx,
                                   tf32=tf32)
        good, order = scoring.rank(pred, prob, valid)
        return pred, prob, counts, valid, good, order

    def control(self, units: int, limits: dict) -> dict:
        """The check with the reference in TF32 in the program's place."""
        for entry in self.sample.entries():
            entry[1] = self.reference(entry[0], tf32=True)
        return self.check(units, limits)

    def check(self, units: int, limits: dict) -> dict:
        kept = self.sample.entries()
        del self.model, self.sample
        program.free_cuda()
        mism, pgap, rgap = 0, 0.0, 0.0
        for i, (_, prob, counts, _, good, order) in kept:
            _, r_prob, r_counts, r_valid, _, _ = self.reference(i)
            mism += int((counts != r_counts).sum())
            if bool(r_valid.any()):
                pgap = max(pgap, float((prob - r_prob)[r_valid].abs().max()))
            rgap = max(rgap, scoring.rank_gap(order[:int(good.sum())],
                                              r_prob, r_valid))
        return {name: {"value": v, "limit": limits[name]} for name, v in
                (("count_mismatch", mism), ("prob_gap", pgap),
                 ("rank_gap", rgap))}

