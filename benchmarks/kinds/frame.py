"""The online frame in a closed loop, one frame in flight as a robot waits
for each grasp: one unit is one call of the program's
``GraspDetector.process_frame`` on the next of the mix's tabletops, which
ends with its results on the host.

Checked after the window, on frames drawn from the seed: the voxel cloud is
made again from the raw scene; every candidate the sampler emitted has to
keep GPG's rules on it (``reference/frame.py``); the number it emitted has
to be what the plain GPG search on the same seed draws allows
(``reference/gpg.py``); every candidate's crop count and best-class
probability are held to the plain crop and PointNetCls on the same draws,
and the ranking to what the reference's probabilities allow
(``scoring.rank_gap``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import generate, program, weights
from ..counts.pointnet import forward_flops
from ..draws import UnitDraws, generator
from ..reference import crop, gpg, scoring
from ..reference import frame as ref_frame


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from pointnetgpd_tpu_torch.grasping.gripper import Gripper
        from pointnetgpd_tpu_torch.inference.scorer import GraspScorer
        from pointnetgpd_tpu_torch.robot.node import (DetectorConfig,
                                                      GraspDetector)

        self.t, self.seed, self.dev = traffic, seed, device
        t = traffic
        self.params = weights.make(config, seed, device)
        self.scenes = generate.tabletops(t, seed)
        # the frames of a run: each tabletop with each of the pool's draws,
        # in an order drawn from the seed
        n_var = len(self.scenes) * t["draw_pool"]
        self.order = torch.randperm(
            n_var, generator=generator("cpu", seed, "frame order")).tolist()
        weights.calibrate(self.params, *self._balance_crops())
        scorer = GraspScorer(
            model=program.pointnet_cls(config, self.params, device),
            k=config["k"], pad_to=t["candidate_pad_to"], device=device)
        self.detector = GraspDetector(scorer, Gripper(**t["gripper"]),
                                      DetectorConfig(**t["detector"]))
        self.cam = np.asarray(t["camera_m"], np.float32)
        self.scored, self.voxel_counts = [], []
        for s, scene in enumerate(self.scenes):
            self._program(scene, UnitDraws(seed, ("warm", s), device))
        self.sample = program.Sample(seed, t["check_units"])
        self.flops_per_candidate = forward_flops(
            t["detector"]["input_points_num"], config["k"])

    def _balance_crops(self, n_frames: int = 64):
        """Crops at hand frames of random downward orientation at random
        points of the first tabletop, for the weights'
        calibration."""
        t, det, gr = self.t, self.t["detector"], self.t["gripper"]
        _, cloud = self.cloud(self.scenes[0])
        gen = generator(self.dev, self.seed, "balance")
        pick = torch.randint(0, cloud.shape[0], (n_frames,), generator=gen,
                             device=self.dev)
        rows = generate.random_rotations(n_frames, gen, self.dev)
        # approaching from above, the bottom centre backed off the surface,
        # as GPG's candidates are
        up = (rows[:, 0, 2] > 0)[:, None]
        rows = torch.stack([torch.where(up, -rows[:, 0], rows[:, 0]),
                            rows[:, 1],
                            torch.where(up, -rows[:, 2], rows[:, 2])], 1)
        centers = cloud[pick] - 0.015 * rows[:, 0]
        d = UnitDraws(self.seed, "balance", self.dev)
        lo, hi = crop.online_box(n_frames, gr["hand_depth"],
                                 gr["hand_outer_diameter"]
                                 - 2 * gr["finger_width"], self.dev)
        clouds, _, valid = crop.crop(
            cloud[d.crop_perm(cloud.shape[0])], centers, rows, lo, hi,
            lambda c: d.crop_windows(c, det["input_points_num"]),
            det["input_points_num"], det["minimal_points_send_to_point_net"])
        return clouds, valid

    def variant(self, i: int):
        """(tabletop, draws) of unit i."""
        v = self.order[i % len(self.order)]
        return (self.scenes[v % len(self.scenes)],
                UnitDraws(self.seed, ("frame", v), self.dev))

    def _program(self, scene, draws):
        out = self.detector.process_frame(scene, self.cam, draws=draws)
        out["n_voxels"] = int(out.pop("points").shape[0])
        return out

    def unit(self, i: int):
        out = self._program(*self.variant(i))
        self.sample.offer(i, out)
        self.scored.append(len(out["all_frames"]))
        self.voxel_counts.append(out["n_voxels"])

    def flops_done(self, units: int) -> float:
        return sum(self.scored[:units]) * self.flops_per_candidate

    def cloud(self, raw):
        """The raw scene as uploaded, and its voxel cloud."""
        t = self.t
        if t["detector"].get("upload_dtype", "float16") == "float16":
            raw = raw.astype(np.float16).astype(np.float32)
        return raw, ref_frame.voxel_downsample(
            torch.from_numpy(raw).to(self.dev), t["detector"]["n_voxel"])

    def bucket(self, raw) -> int:
        """Rows of the padded cloud the sampler and the crop run on."""
        pad = self.t["detector"]["cloud_pad_to"]
        return max(-(-len(raw) // pad), 1) * pad

    def valid_bounds(self, i: int) -> tuple[int, int]:
        """The plain GPG search's (least, most) valid frames of unit i."""
        t, det = self.t, self.t["detector"]
        scene, d = self.variant(i)
        raw, cloud = self.cloud(scene)
        bucket = self.bucket(raw)
        padded = torch.cat([cloud, torch.full(
            (bucket - cloud.shape[0], 3), -1e6, device=self.dev)])
        g = dict(t["gpg"], num_seeds=det["max_num_samples"],
                 above_table_m=det["select_point_above_table"],
                 normal_k=det["normal_k"],
                 normal_window=det["normal_window"])
        return gpg.valid_count_bounds(padded, cloud.shape[0],
                                      d.seed_uniform(bucket), self.cam,
                                      t["gripper"], g)

    def reference_scores(self, i: int, frames, *, tf32: bool = False):
        """(pred, prob, counts, valid, good, order) of the emitted
        candidates ``frames`` (G, 5, 3) of unit i, plain; ``tf32``: every
        product of the PointNet in TF32 (the control)."""
        t = self.t
        det = t["detector"]
        scene, d = self.variant(i)
        raw, cloud = self.cloud(scene)
        n = cloud.shape[0]
        bucket = self.bucket(raw)
        g = frames.shape[0]
        g_pad = max(-(-g // t["candidate_pad_to"]) * t["candidate_pad_to"],
                    t["candidate_pad_to"])
        npts = det["input_points_num"]
        crop.check_shuffled_window(bucket, g_pad)
        gr = t["gripper"]
        width = gr["hand_outer_diameter"] - 2 * gr["finger_width"]
        lo, hi = crop.online_box(g, gr["hand_depth"], width, self.dev)
        perm = d.crop_perm(bucket)
        visit = cloud[perm[perm < n]]

        def windows(count):
            full = torch.zeros(g_pad, dtype=count.dtype, device=self.dev)
            full[:g] = count
            r, start = d.crop_windows(full, npts)
            return r[:g], start[:g]

        clouds, counts, valid = crop.crop(
            visit, frames[:, 0], crop.unit(frames[:, 1:4]), lo, hi, windows,
            npts, det["minimal_points_send_to_point_net"])
        idx = d.resample(g_pad, npts, npts)[:g]
        pred, prob = scoring.score(self.params, clouds, valid, idx,
                                   tf32=tf32)
        good, order = scoring.rank(pred, prob, valid)
        return pred, prob, counts, valid, good, order

    def control(self, units: int, limits: dict) -> dict:
        """The check with the program's candidates scored by the reference
        with the PointNet's products in TF32, in the scorer's place."""
        for i, out in self.sample.entries():
            frames = torch.from_numpy(np.asarray(out["all_frames"],
                                                 np.float32)).to(self.dev)
            if frames.shape[0] == 0:
                continue
            pred, prob, counts, _, good, order = self.reference_scores(
                i, frames, tf32=True)
            ranked = order[:int(good.sum())].cpu().numpy()
            out.update(all_scores=prob[:, -1].cpu().numpy(),
                       counts=counts.cpu().numpy(),
                       grasps=np.asarray(out["all_frames"])[ranked],
                       scores=prob[ranked, -1].cpu().numpy())
        return self.check(units, limits)

    def check(self, units: int, limits: dict) -> dict:
        kept = self.sample.entries()
        del self.detector, self.sample
        program.free_cuda()
        rules, gap, mism, pgap, rgap = 0, 0, 0, 0.0, 0.0
        self.detail = {"unit_emitted_least_most": []}
        for i, out in kept:
            frames = torch.from_numpy(np.asarray(out["all_frames"],
                                                 np.float32)).to(self.dev)
            _, cloud = self.cloud(self.variant(i)[0])
            rules += ref_frame.rule_violations(
                cloud, frames, self.t["gripper"],
                min_open_points=self.t["gpg"]["min_open_points"])
            bounds = self.valid_bounds(i)
            self.detail["unit_emitted_least_most"].append(
                [i, frames.shape[0], *bounds])
            gap = max(gap, gpg.count_gap(frames.shape[0], bounds,
                                         self.t["detector"]["num_grasps"]))
            if frames.shape[0] == 0:
                continue
            _, r_prob, r_counts, r_valid, _, _ = self.reference_scores(
                i, frames)
            counts = torch.as_tensor(np.asarray(out["counts"]),
                                     device=self.dev)
            mism += int((counts != r_counts).sum())
            score = torch.as_tensor(np.asarray(out["all_scores"]),
                                    device=self.dev)
            best = r_prob[:, -1]
            if bool(r_valid.any()):
                pgap = max(pgap, float((score - best)[r_valid].abs().max()))
            rgap = max(rgap, scoring.rank_gap(listed(out), r_prob, r_valid))
        return {name: {"value": v, "limit": limits[name]} for name, v in
                (("rule_violations", rules), ("sampler_count_gap", gap),
                 ("count_mismatch", mism), ("prob_gap", pgap),
                 ("rank_gap", rgap))}


def listed(out) -> list[int]:
    """Indices into ``all_frames`` of a frame's ranked grasps, each matched
    by its frame and its score; -1 where none matches."""
    frames = np.asarray(out["all_frames"]).reshape(-1, 15)
    scores = np.asarray(out["all_scores"])
    taken, idx = set(), []
    for f, s in zip(np.asarray(out["grasps"]).reshape(-1, 15),
                    np.asarray(out["scores"])):
        hits = [j for j in np.flatnonzero((frames == f).all(1)
                                          & (scores == s))
                if j not in taken]
        idx.append(int(hits[0]) if hits else -1)
        taken.update(idx[-1:])
    return idx
