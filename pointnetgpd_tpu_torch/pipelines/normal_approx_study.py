"""Distribution-scale study of the frame pipeline's normal approximations.

Port of ``pointnetgpd_tpu/pipelines/normal_approx_study.py``. The
production detector replaces the reference's exact whole-cloud pcl KNN
normals (reference: dex-net/apps/kinect2grasp.py:131-144) with two
statistical shortcuts — Morton-window KNN (``estimate_normals_knn_window``)
and lazy seed-window normals (``seed_window_normals``) — plus an fp16
upload. This study runs N randomized multi-object tabletop scenes through
the FULL detector (kernels K1 and K2 on the card: 3 and 2 launches per
frame and config) under each config and reports candidate yield, top-grasp
agreement, and score deltas against the exact reference-shaped flow
(``DetectorConfig.reference_parity``).

Run on the card:
``python -m pointnetgpd_tpu_torch.pipelines.normal_approx_study --scenes 50
--raw-points 84000`` (``--device cpu`` for the CPU route). The
JAX version first turns on XLA's compilation cache; the port has nothing
for XLA to compile (its kernel library is built once and cached by
``_build.py``), so it has no counterpart of that step.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

def make_scene(rng: np.random.RandomState, n_points: int) -> np.ndarray:
    """Randomized segmented-tabletop scene: 3-6 axis-rotated boxes, points
    on the three camera-visible faces with depth-sensor-scale noise.

    Matches the reference's /table_top_points input shape: table plane at
    z=0 already segmented away, objects only (kinect2grasp.py:424-436).
    """
    n_obj = rng.randint(3, 7)
    # allocate points ~ proportional to object surface area
    sizes = rng.uniform(0.04, 0.12, size=(n_obj, 2))          # footprint
    heights = rng.uniform(0.04, 0.14, size=n_obj)
    areas = sizes[:, 0] * sizes[:, 1] + heights * (sizes[:, 0] + sizes[:, 1])
    counts = np.maximum((n_points * areas / areas.sum()).astype(int), 100)
    counts[-1] += n_points - counts.sum()                      # exact total
    pts = []
    for (sx, sy), h, n in zip(sizes, heights, counts):
        cx, cy = rng.uniform(-0.28, 0.28, size=2)
        th = rng.uniform(0, np.pi)
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        n_top = n // 2
        n_front = (n - n_top) // 2
        n_side = n - n_top - n_front
        top = rng.rand(n_top, 3) * [sx, sy, 0] + [0, 0, h]
        front = rng.rand(n_front, 3) * [sx, 0, h]
        side = rng.rand(n_side, 3) * [0, sy, h]
        p = np.concatenate([top, front, side])
        p[:, :2] -= [sx / 2, sy / 2]
        p[:, :2] = p[:, :2] @ rot.T
        p[:, :2] += [cx, cy]
        pts.append(p)
    scene = np.concatenate(pts).astype(np.float32)
    scene += rng.normal(0, 0.0005, scene.shape).astype(np.float32)  # 0.5 mm
    scene[:, 2] = np.maximum(scene[:, 2], 0.002)               # above table
    return scene


def study_configs(cloud_pad_to: int = 8192):
    """The ladder from exact to production, one approximation at a time
    (the port's ``DetectorConfig``s, field for field the JAX package's)."""
    from ..robot.node import DetectorConfig

    return {
        "exact": DetectorConfig.reference_parity(cloud_pad_to=cloud_pad_to),
        "window": DetectorConfig(
            lazy_normals=False, normal_window=2048, upload_dtype="float32",
            adaptive_bucket=False, cloud_pad_to=cloud_pad_to),
        "lazy": DetectorConfig(
            lazy_normals=True, normal_window=2048, upload_dtype="float32",
            adaptive_bucket=False, cloud_pad_to=cloud_pad_to),
        "lazy_fp16": DetectorConfig(
            lazy_normals=True, normal_window=2048, upload_dtype="float16",
            adaptive_bucket=False, cloud_pad_to=cloud_pad_to),
    }


def compare_frame(base: dict, alt: dict):
    """Per-frame agreement metrics of an alternative config vs baseline.

    Top-1 = the highest-SCORED candidate over all valid candidates (not the
    classifier-gated "good" list, which depends on the model weights and can
    be empty): the quantity a robot executive would act on."""

    def top1(out):
        if not len(out["all_frames"]):
            return None, None
        i = int(np.argmax(out["all_scores"]))
        return out["all_frames"][i], float(out["all_scores"][i])

    def match_matrix(fa, fb):
        """(|A|, |B|) bool: same physical grasp (center < 5 mm, approach
        aligned)."""
        d = np.linalg.norm(fa[:, None, 0] - fb[None, :, 0], axis=-1)
        dots = np.einsum("ai,bi->ab", fa[:, 1], fb[:, 1])
        return (d < 5e-3) & (dots > 0.95)

    nb, na = len(base["all_frames"]), len(alt["all_frames"])
    out = {"yield_base": nb, "yield_alt": na}
    if nb and na:
        m = match_matrix(alt["all_frames"], base["all_frames"])
        out["alt_matched_frac"] = float(m.any(axis=1).mean())
        out["base_matched_frac"] = float(m.any(axis=0).mean())
        # score agreement on MATCHED pairs (the classifier sees a nearly
        # identical crop for the same physical grasp)
        ai, bi = np.nonzero(m)
        if len(ai):
            deltas = np.abs(np.asarray(alt["all_scores"])[ai]
                            - np.asarray(base["all_scores"])[bi])
            out["matched_score_delta_max"] = float(deltas.max())
        out["matched_pairs"] = int(len(ai))
    b0, bs = top1(base)
    a0, as_ = top1(alt)
    if b0 is not None and a0 is not None:
        out["top1_center_mm"] = float(np.linalg.norm(b0[0] - a0[0]) * 1e3)
        out["top1_approach_dot"] = float(np.dot(b0[1], a0[1]))
        out["top1_score_delta"] = float(abs(bs - as_))
        # does the alt's top grasp appear anywhere in the base's candidate
        # set (same physical grasp)?
        d = np.linalg.norm(base["all_frames"][:, 0] - a0[0], axis=1)
        dots = base["all_frames"][:, 1] @ a0[1]
        out["top1_in_base_set"] = bool(((d < 5e-3) & (dots > 0.95)).any())
        # ... and is the alt's top-1 within the base's top-q score quantile
        # of its own set (ties make exact argmax identity meaningless)?
        bscores = np.asarray(base["all_scores"])
        ok = (d < 5e-3) & (dots > 0.95)
        out["top1_base_rank_q"] = float(
            (bscores >= bscores[ok].max()).mean()) if ok.any() else None
    out["both_empty"] = b0 is None and a0 is None
    out["one_empty"] = (b0 is None) != (a0 is None)
    return out


def pinned_normals_metrics(scene: np.ndarray, cam, seed: int,
                           normal_k: int = 30, window: int = 2048,
                           num_seeds: int = 150, device="cuda"):
    """Isolate the NORMALS approximation from the seed lottery: one fp32
    voxel-downsampled cloud on ``device``, exact all-pairs KNN normals as
    the oracle, the Morton-window estimator and the lazy seed-window
    estimator evaluated on the SAME points/seeds. Downstream candidate
    identity is chaotic by construction (eigen-frames on near-degenerate
    covariances rotate under any perturbation), so this is where the
    approximation's actual error lives."""
    from ..ops.cloud import (
        estimate_normals_knn, estimate_normals_knn_window,
        seed_window_normals, voxel_downsample_packed,
    )

    dev = torch.device(device)
    pts_pad, count = voxel_downsample_packed(
        torch.as_tensor(np.asarray(scene, np.float32), device=dev),
        n_grid=500)
    n = int(count)
    pts = pts_pad[:n].cpu().numpy()
    # a fixed-size subsample: all three estimators see the SAME cloud
    m = 16384
    rng0 = np.random.RandomState(seed + 7919)
    if n > m:
        pts = pts[rng0.choice(n, m, replace=False)]
        n = m
    pts = torch.as_tensor(pts, device=dev)
    cam = torch.as_tensor(np.asarray(cam, np.float32), device=dev)
    exact = estimate_normals_knn(pts, cam, k=normal_k).cpu().numpy()
    win = estimate_normals_knn_window(pts, cam, k=normal_k, window=window)
    cos_w = np.abs(np.sum(exact * win.cpu().numpy(), axis=1))

    rng = np.random.RandomState(seed)
    above = (pts[:, 2] > 0.01).cpu().numpy()
    cand = np.nonzero(above)[0]
    seed_idx = rng.choice(cand, min(num_seeds, len(cand)), replace=False)
    _, _, lazy_sn = seed_window_normals(
        pts, torch.as_tensor(seed_idx, device=dev), cam, k=normal_k,
        knn=100, window=window)
    cos_l = np.abs(np.sum(exact[seed_idx] * lazy_sn.cpu().numpy(), axis=1))
    return {"n_voxels": n,
            "window_cos_median": float(np.median(cos_w)),
            "window_cos_frac_gt99": float(np.mean(cos_w > 0.99)),
            "window_cos_p10": float(np.quantile(cos_w, 0.1)),
            "lazy_cos_median": float(np.median(cos_l)),
            "lazy_cos_frac_gt99": float(np.mean(cos_l > 0.99)),
            "lazy_cos_p10": float(np.quantile(cos_l, 0.1))}


def run_study(n_scenes: int = 50, raw_points: int = 84000, seed0: int = 0,
              cloud_pad_to: int = 8192, num_points: int = 500, *,
              model=None, device="cuda", draws_for=None, timer=None):
    """Scene i (``make_scene(RandomState(seed0 + i))``) through every
    config's detector with ``seed=seed0 + i``. ``model``: the 3-class
    PointNetCls scored with (default: initialized from a generator seeded
    0); ``draws_for(seed)``: the frame's draws (default: the detector's own
    from ``seed``); ``timer``: a ``utils.profiling.StageTimer`` that times
    each config's frames. Returns (rows, yields) for ``summarize``."""
    from ..inference.scorer import GraspScorer
    from ..models.pointnet import PointNetCls
    from ..robot.node import GraspDetector

    if model is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = PointNetCls(input_chann=3, k=3)
    scorer = GraspScorer(model=model, k=3, num_points=num_points,
                         device=device)
    dets = {name: GraspDetector(scorer, config=cfg)
            for name, cfg in study_configs(cloud_pad_to).items()}

    rows = {name: [] for name in dets if name != "exact"}
    yields = {name: [] for name in dets}
    cam = np.asarray([1.0, 1.0, 1.2], np.float32)
    for i in range(n_scenes):
        rng = np.random.RandomState(seed0 + i)
        scene = make_scene(rng, raw_points)
        outs = {}
        for name, det in dets.items():
            draws = None if draws_for is None else draws_for(seed0 + i)
            with (timer.stage(name) if timer is not None
                  else contextlib.nullcontext()):
                outs[name] = det.process_frame(scene, cam, seed=seed0 + i,
                                               draws=draws)
        for name, out in outs.items():
            yields[name].append(len(out["all_frames"]))
        for name in rows:
            rows[name].append(compare_frame(outs["exact"], outs[name]))
    return rows, yields


def summarize(rows, yields) -> dict:
    summary = {"mean_yield": {k: float(np.mean(v)) for k, v in yields.items()}}
    for name, rr in rows.items():
        paired = [r for r in rr if "top1_center_mm" in r]
        matched = [r for r in rr if "alt_matched_frac" in r]
        n = len(rr)
        same = [r for r in paired if r["top1_in_base_set"]]
        ranks = [r["top1_base_rank_q"] for r in paired
                 if r.get("top1_base_rank_q") is not None]
        summary[name] = {
            "frames": n,
            "frames_with_grasps_both": len(paired),
            "frames_one_side_empty": int(sum(r["one_empty"] for r in rr)),
            # candidate-SET agreement: the quantity the normals actually
            # influence (which grasps exist)
            "alt_matched_frac_mean": round(float(np.mean(
                [r["alt_matched_frac"] for r in matched])), 3),
            "base_matched_frac_mean": round(float(np.mean(
                [r["base_matched_frac"] for r in matched])), 3),
            # same physical grasp -> same score?
            "matched_score_delta_max": round(float(np.max(
                [r.get("matched_score_delta_max", 0.0) for r in matched])), 4)
            if matched else None,
            # top-1 agreement: exact-argmax identity is a knife edge under
            # score ties, so also report the base-set rank of the alt top-1
            "top1_in_base_set_pct": round(
                100 * len(same) / max(len(paired), 1), 1),
            "top1_base_rank_q_p90": round(float(np.quantile(ranks, 0.9)), 3)
            if ranks else None,
            "top1_score_delta_p90": round(float(np.quantile(
                [r["top1_score_delta"] for r in paired], 0.9)), 4)
            if paired else None,
            "yield_ratio_mean": round(float(np.mean(
                [r["yield_alt"] / max(r["yield_base"], 1) for r in rr])), 3),
        }
    return summary


def run_pinned(n_scenes: int, raw_points: int, seed0: int = 0,
               device="cuda") -> dict:
    cam = np.asarray([1.0, 1.0, 1.2], np.float32)
    per = []
    for i in range(n_scenes):
        rng = np.random.RandomState(seed0 + i)
        per.append(pinned_normals_metrics(make_scene(rng, raw_points), cam,
                                          seed=seed0 + i, device=device))
    keys = [k for k in per[0] if k != "n_voxels"]
    agg = {k: round(float(np.mean([p[k] for p in per])), 4) for k in keys}
    agg["worst_window_cos_p10"] = round(
        float(min(p["window_cos_p10"] for p in per)), 4)
    agg["worst_lazy_cos_p10"] = round(
        float(min(p["lazy_cos_p10"] for p in per)), 4)
    agg["scenes"] = n_scenes
    return agg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=50)
    ap.add_argument("--raw-points", type=int, default=84000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cloud-pad-to", type=int, default=8192)
    ap.add_argument("--skip-detector", action="store_true",
                    help="run only the pinned normals comparison")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    out = {}
    if not args.skip_detector:
        rows, yields = run_study(args.scenes, args.raw_points, args.seed,
                                 args.cloud_pad_to, device=args.device)
        out = summarize(rows, yields)
    out["pinned_normals"] = run_pinned(args.scenes, args.raw_points,
                                       args.seed, device=args.device)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
