"""Labeling grasps in a closed loop, as a dataset builder does
(generate-dataset-canny.py): one unit is one fixed-budget round of the
program's ``antipodal_sample_grasps`` on the next object of the mix's pool,
then its ``friction_boundary_labels`` on the configuration's friction
ladder, with the round's grasps, contacts, normals and labels brought to the
host. A grasp is labeled where the sampler and the ladder both call it
valid. Each unit makes the same number of attempts; no round is repeated
until a quota is met.

Objects: tori, the analytic distance sqrt((sqrt(x^2 + y^2) - R)^2 + z^2) - r
with radii spread evenly over the mix's ranges (the same for every seed, so
that a seed changes no yield), each turned by a uniform random rotation and
the pool ordered from the seed, sampled on a
cube of ``sdf_dim`` cells a side that holds the torus with ``margin_m`` to
spare, made into the program's grid by its ``make_sdf``. A sample within
1e-5 of the surface threshold (res * sqrt(2) / 2) is moved 2e-5 off it, so
that no rounding of the threshold changes the list of surface cells that
the draws index.

Checked after the window, on units kept by ``program.Sample``, against
``reference/label.py`` in float64 on the same grids and draws:
- ``rule_violations``: labeled grasps that break a rule of the sampler by a
  decided margin: contacts over ``max_width_m`` apart, a contact off the
  surface, a configuration on which the reference's closing finds no pair,
  an inward normal outside the friction cone at ``friction_coef`` towards
  the other contact (the normals' signs kept), or an approach angle that is
  not the first collision-free one of the attempt's drawn order. Contacts
  under 0.1 mm apart are the coincident pairs the JAX package accepts
  (ROADMAP Queue C item 7), as the reference does: they break no cone
  rule.
- ``label_gap``: the share of labeled grasps whose rung the reference,
  closing the fingers on the same configuration, puts elsewhere with its
  closure margin at every friction between the two rungs over
  ``LADDER_TOL``. Float32 decides 5-12% of the sampler's lanes (ROADMAP
  Queue C item 6), so grasps are judged one by one, not lane by lane.
- ``yield_gap``: how far a unit's labeled count lies outside the least and
  most that the reference's replay of the round on the same draws allows,
  a grasp that rounding can turn counting either way (the rule of the frame
  cell's ``sampler_count_gap``); the largest over the kept units.

``control`` puts the reference in the program's place: in bfloat16 (no
``fault``), the precision below the configuration's float32; or in float32
with a fault planted in what it emits: ``rung_down`` (each label one rung
further down the ladder, the last rung kept), ``half_dropped`` (every other
labeled grasp dropped), ``flipped_normals`` (the contact normals turned
over), or ``float32`` (none: the witness that float32's own rounding meets
every limit).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from .. import program
from ..counts.label import unit_flops
from ..draws import UnitDraws, derive, generator
from ..generate import random_rotations
from ..reference import label as ref

F64 = torch.float64
# radians: a rung is decided where the reference's closure margins lie
# farther than this from the cone's edge
LADDER_TOL = 1e-4
FAULTS = ("rung_down", "half_dropped", "flipped_normals", "float32")
# columns of a unit's output on the host
CONFIG, CONTACTS, NORMALS = slice(0, 10), slice(10, 16), slice(16, 22)
VALID, RUNG, LADDER_OK = 22, 23, 24


class LabelDraws(UnitDraws):
    """``UnitDraws`` with the labeling path's draws of the ``Draws``
    protocol, each keyed by (seed, unit, name, call) as the others are."""

    def surface_index(self, n_surface: int, n: int):
        return torch.randint(0, n_surface, (n,),
                             generator=self._gen("surface_index"),
                             device=self.device)

    def antipodal_perturb(self, n: int):
        return self._rand("antipodal_perturb", n, 3)

    def antipodal_cone(self, n: int):
        return self._rand("cone_theta", n), self._rand("cone_r", n)

    def antipodal_flip(self, n: int):
        return self._rand("antipodal_flip", n)

    def approach_perm(self, n: int, a: int):
        return torch.argsort(self._rand("approach_perm", n, a), dim=1,
                             stable=True)

    def approach_choice(self, n: int, a: int):
        return torch.randint(0, a, (n,),
                             generator=self._gen("approach_choice"),
                             device=self.device)

    def next_round(self):
        k = self._calls.get("next_round", 0)
        self._calls["next_round"] = k + 1
        return LabelDraws(self.seed, (self.unit, "round", k), self.device)


def torus_grids(t: dict, seed: int, device) -> list:
    """[(data (dim, dim, dim) float32, origin, res), ...] of the pool. Every
    seed gets the same radii, the middles of ``objects`` equal steps over
    each range, the largest ring with the thinnest tube; the seed turns each
    torus and orders the pool."""
    n, dim, margin = t["objects"], t["sdf_dim"], t["margin_m"]
    gen = generator(device, seed, "tori")
    (a0, a1), (b0, b1) = t["major_radius_m"], t["minor_radius_m"]
    step = (torch.arange(n, dtype=F64) + 0.5) / n
    order = torch.randperm(n, generator=generator("cpu", seed, "tori order"))
    major = (a0 + (a1 - a0) * step)[order]
    minor = (b0 + (b1 - b0) * (1.0 - step))[order]
    rot = random_rotations(n, gen, device).to(F64)
    out = []
    for k in range(n):
        half = float(major[k] + minor[k]) + margin
        res = float(np.float32(2.0 * half / (dim - 1)))
        origin = float(np.float32(-half))
        axis = origin + res * torch.arange(dim, dtype=F64, device=device)
        pts = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), -1)
        q = pts @ rot[k].T
        ring = torch.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2) - float(major[k])
        data = (torch.sqrt(ring ** 2 + q[..., 2] ** 2) - float(minor[k]))
        out.append((_off_threshold(data.float(), res), [origin] * 3, res))
    return out


def _off_threshold(data, res: float):
    thresh = res * np.sqrt(2) / 2.0
    d = data.to(F64)
    near = ((d.abs() - thresh).abs() < 1e-5 * thresh)
    moved = torch.sign(d) * thresh * torch.where(d.abs() < thresh,
                                                 1 - 2e-5, 1 + 2e-5)
    return torch.where(near, moved, d).float().contiguous()


def pack(configs, contacts, normals, valid, rung, ladder_ok):
    """A round's output as one (N, 25) float32 host array."""
    n = configs.shape[0]
    return torch.cat([configs.float(), contacts.reshape(n, 6).float(),
                      normals.reshape(n, 6).float(),
                      valid[:, None].float(), rung[:, None].float(),
                      ladder_ok[:, None].float()], 1).cpu().numpy()


def labeled(out) -> np.ndarray:
    return (out[:, VALID] > 0) & (out[:, LADDER_OK] > 0)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from pointnetgpd_tpu_torch.geometry.sdf import make_sdf
        from pointnetgpd_tpu_torch.grasping.evaluation import (
            friction_boundary_labels)
        from pointnetgpd_tpu_torch.grasping.samplers import (
            antipodal_sample_grasps)

        self.t, self.seed, self.dev = traffic, seed, device
        t = traffic
        self.frictions = [float(f) for f in config["friction_ladder"]]
        self.objects = torus_grids(t, seed, device)
        self.sdfs = [make_sdf(d, o, r, device=device)
                     for d, o, r in self.objects]
        self.ladder_t = torch.tensor(self.frictions, dtype=torch.float32,
                                     device=device)
        self._sample, self._label = (antipodal_sample_grasps,
                                     friction_boundary_labels)
        self.attempts = t["num_attempts"]
        self.flops_per_unit = unit_flops(t, len(self.frictions))
        self.labeled = []
        for k in range(len(self.sdfs)):         # every object's shapes
            self._program(k, LabelDraws(seed, ("warm", k), device))
        self.sample = program.Sample(seed, t["check_units"])

    def _program(self, obj: int, draws):
        t, sdf = self.t, self.sdfs[obj]
        with record_function("label.sample"):
            s = self._sample(sdf, draws, max_width=t["max_width_m"],
                             friction_coef=t["friction_coef"],
                             min_contact_dist=t["min_contact_dist_m"],
                             num_attempts=t["num_attempts"],
                             num_samples_loa=t["num_samples_loa"])
        with record_function("label.ladder"):
            _, rung, ok = self._label(sdf, s.configs, self.ladder_t,
                                      num_samples=t["num_samples_loa"],
                                      n_fc=len(self.frictions))
        return pack(s.configs, s.contacts, s.normals, s.valid, rung, ok)

    def _draws(self, i: int):
        return LabelDraws(self.seed, i, self.dev)

    def unit(self, i: int):
        out = self._program(i % len(self.sdfs), self._draws(i))
        self.labeled.append(int(labeled(out).sum()))
        self.sample.offer(i, out)

    def flops_done(self, units: int) -> float:
        return units * self.flops_per_unit

    def _grid(self, i: int, dtype=F64):
        data, origin, res = self.objects[i % len(self.objects)]
        return ref.Grid(data, origin, res, dtype)

    def _kw(self) -> dict:
        t = self.t
        return dict(max_width=t["max_width_m"], friction=t["friction_coef"],
                    loa_samples=t["num_samples_loa"],
                    frictions=self.frictions)

    def _order(self, i: int):
        """Unit i's drawn approach angles, (attempts, A) float64, as its
        round's draws give them."""
        cands = torch.tensor(ref.APPROACH_ANGLES, dtype=F64, device=self.dev)
        return cands[self._draws(i).approach_perm(
            self.attempts, len(ref.APPROACH_ANGLES)).to(self.dev)]

    def reference_round(self, i: int, dtype=F64) -> dict:
        """Unit i's round and labels by the reference in ``dtype``."""
        return ref.antipodal_round(
            self._grid(i, dtype), self._draws(i), attempts=self.attempts,
            min_contact=self.t["min_contact_dist_m"], **self._kw())

    def control(self, units: int, limits: dict, fault=None) -> dict:
        """The check with the reference in the program's place: in
        bfloat16 (no ``fault``), or in float32 with ``fault`` planted in
        what it emits."""
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; faults: {FAULTS}")
        dtype = torch.bfloat16 if fault is None else torch.float32
        for entry in self.sample.entries():
            r = self.reference_round(entry[0], dtype)
            rung, ok = r["rung"], r["rung"] >= 0
            normals = r["normals"]
            if fault == "rung_down":
                rung = torch.where(ok, (rung + 1).clamp(
                    max=len(self.frictions) - 1), rung)
            elif fault == "half_dropped":
                lab = r["valid"] & ok
                ok = ok & ~(lab & (torch.cumsum(lab.long(), 0) % 2 == 0))
            elif fault == "flipped_normals":
                normals = -normals
            entry[1] = pack(r["configs"], r["contacts"], normals, r["valid"],
                            rung, ok)
        return self.check(units, limits)

    def check(self, units: int, limits: dict) -> dict:
        kept = self.sample.entries()
        del self.sdfs, self.sample
        program.free_cuda()
        kw = self._kw()
        counts = dict(wide=0, off_surface=0, unfound=0, outside_cone=0,
                      approach_off=0, coincident=0, rung_off=0, broken=0)
        n_labeled, gap = 0, 0
        self.detail = {"unit_labeled_least_most": [],
                       "labeled_per_rung": [0] * len(self.frictions)}
        for i, out in kept:
            lab = labeled(out)
            emitted = int(lab.sum())
            n_labeled += emitted
            ties = derive(self.seed, i, "ties")
            if emitted:
                rows = torch.from_numpy(out[lab]).to(self.dev).to(F64)
                at = torch.from_numpy(np.nonzero(lab)[0]).to(self.dev)
                flags = ref.judge(
                    self._grid(i).variants(ties), rows[:, CONFIG],
                    rows[:, CONTACTS].reshape(-1, 2, 3),
                    rows[:, NORMALS].reshape(-1, 2, 3),
                    rows[:, RUNG].long(), self._order(i)[at],
                    ladder_tol=LADDER_TOL, **kw)
                flags["broken"] = (flags["wide"] | flags["off_surface"]
                                   | flags["unfound"] | flags["outside_cone"]
                                   | flags["approach_off"])
                for name in counts:
                    counts[name] += int(flags[name].sum())
                for k in out[lab][:, RUNG].astype(int):
                    if 0 <= k < len(self.frictions):
                        self.detail["labeled_per_rung"][k] += 1
            least, most = ref.yield_bounds(
                self._grid(i).variants(ties), lambda: self._draws(i),
                attempts=self.attempts,
                min_contact=self.t["min_contact_dist_m"], **kw)
            self.detail["unit_labeled_least_most"].append(
                [i, emitted, least, most])
            gap = max(gap, least - emitted, emitted - most)
        self.detail["grasps"] = dict(counts, labeled=n_labeled)
        return {name: {"value": v, "limit": limits[name]} for name, v in
                (("rule_violations", counts["broken"]),
                 ("label_gap", counts["rung_off"] / max(n_labeled, 1)),
                 ("yield_gap", gap))}
