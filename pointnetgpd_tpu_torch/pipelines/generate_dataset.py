"""Offline grasp-label dataset generation: the generate-dataset-canny pipeline.

Port of ``pointnetgpd_tpu/pipelines/generate_dataset.py`` (reference:
dex-net/apps/generate-dataset-canny.py). One host process drives batched
calls on the card: antipodal sampling, the friction-ladder labels and
Ferrari-Canny each evaluate hundreds of grasps per call. Output format is
the reference's: per object a ``.npy`` of 12-column rows (10-dim
configuration + score_friction + score_canny, :48-54) and a pickle of
(config, fc, canny) tuples.

Run:  python -m pointnetgpd_tpu_torch.pipelines.generate_dataset [prefix]
      --data-root DIR [--device cuda]
"""

from __future__ import annotations

import json
import os
import pickle
from typing import NamedTuple

import numpy as np
import torch

from ..draws import Draws
from ..geometry.io import read_obj, read_sdf
from ..grasping.evaluation import (
    FC_LIST_FULL,
    FC_LIST_LESS_CLASS,
    evaluate_ferrari_canny,
    friction_boundary_labels,
)
from ..grasping.grasp import adaptive_num_samples
from ..grasping.gripper import Gripper
from ..grasping.samplers import antipodal_sample_grasps, dedupe_grasps


class LabelResult(NamedTuple):
    """``label_grasps_for_object`` output: reference-format rows plus the
    yield books (the reference prints only a progress line,
    generate-dataset-canny.py:134)."""

    rows: np.ndarray      # (N, 12) float32, reference .npy format
    counts: np.ndarray    # (n_fc,) accepted rows per friction class
    stats: dict           # rounds/attempts/accepted/exhausted/quota_met


def label_grasps_for_object(
    sdf,
    center_of_mass,
    gripper: Gripper,
    draws=None,
    *,
    fc_list=None,
    grasps_per_class: int = 20,
    batch_attempts: int = 256,
    max_rounds: int | None = None,
    patience: int = 12,
    friction_coef_sampling: float = 2.0,
    num_samples_loa: int | None = None,
    seed: int = 0,
) -> LabelResult:
    """Sample and label grasps on the SDF's device until every friction
    class has ``grasps_per_class`` rows (the reference's while loop,
    generate-dataset-canny.py:109-134, over fixed-size batches).

    ``max_rounds`` caps the rounds (None: 40 per 20 of quota) and
    ``patience`` rounds with no accepted row declare the remaining classes
    exhausted. Each round takes ``draws.next_round()`` (default
    ``Draws(seed)``). Returns LabelResult(rows (N, 12) float32, counts,
    stats)."""
    dev = sdf.data.device
    if draws is None:
        draws = Draws(seed, dev)
    fc_list = FC_LIST_LESS_CLASS if fc_list is None else np.asarray(fc_list)
    n_fc = len(fc_list)
    fc_dev = torch.as_tensor(fc_list.astype(np.float32), device=dev)
    com = torch.as_tensor(np.asarray(center_of_mass), dtype=torch.float32,
                          device=dev)
    counts = np.zeros(n_fc, dtype=int)
    rows = []
    if num_samples_loa is None:
        # resolution-adaptive line-of-action density (grasp.py:464-466)
        num_samples_loa = adaptive_num_samples(sdf, gripper.max_width)
    if max_rounds is None:
        max_rounds = 40 * max(1, -(-grasps_per_class // 20))
    rounds = accepted_total = 0
    stale = 0  # consecutive rounds with no accepted row

    for _ in range(max_rounds):
        rounds += 1
        sampled = antipodal_sample_grasps(
            sdf, draws.next_round(), max_width=gripper.max_width,
            min_width=gripper.min_width,
            friction_coef=friction_coef_sampling,
            num_attempts=batch_attempts, num_samples_loa=num_samples_loa)
        configs = sampled.configs[sampled.valid]
        if configs.shape[0] == 0:
            stale += 1
            if stale >= patience:
                break
            continue
        # coverage rejection within the round (grasp_sampler.py:153-234)
        configs = dedupe_grasps(configs, min_dist=0.0025)
        label_fc, label_idx, valid = friction_boundary_labels(
            sdf, configs, fc_dev, num_samples=num_samples_loa, n_fc=n_fc)
        canny, _ = evaluate_ferrari_canny(sdf, configs, com, label_fc,
                                          num_samples=num_samples_loa)

        accepted = 0
        for cfg, fc, idx, ok, cq in zip(configs.cpu().numpy(),
                                        label_fc.cpu().numpy(),
                                        label_idx.cpu().numpy(),
                                        valid.cpu().numpy(),
                                        canny.cpu().numpy()):
            if not ok or counts[idx] >= grasps_per_class:
                continue
            counts[idx] += 1
            accepted += 1
            rows.append(np.concatenate([cfg[:10], [fc, cq]]).astype(np.float32))
        accepted_total += accepted
        stale = 0 if accepted else stale + 1
        if np.all(counts >= grasps_per_class) or stale >= patience:
            break

    quota_met = bool(np.all(counts >= grasps_per_class))
    stats = {
        "rounds": rounds,
        "attempts": rounds * batch_attempts,
        "accepted": accepted_total,
        "quota_met": quota_met,
        "exhausted": not quota_met and stale >= patience,
        "per_class": counts.tolist(),
        "fc_list": np.asarray(fc_list, np.float32).round(2).tolist(),
    }
    return LabelResult(
        np.stack(rows) if rows else np.zeros((0, 12), np.float32),
        counts, stats)


def generate_for_object_dir(obj_dir: str, out_dir: str, gripper: Gripper,
                            seed: int = 0, *, filename_prefix: str = "default",
                            less_class: bool = True, device="cuda",
                            **kwargs):
    """Label one object directory (reference layout
    {obj}/google_512k/nontextured.obj/.sdf, generate-dataset-canny.py:75-77)
    on ``device``. Writes {prefix}_{object}_{n}.npy and .pickle as the
    reference does (:44-54). Returns (npy path or None, stats), or None
    when the files are missing."""
    object_name = os.path.basename(obj_dir.rstrip("/"))
    obj_path = os.path.join(obj_dir, "google_512k", "nontextured.obj")
    sdf_path = os.path.join(obj_dir, "google_512k", "nontextured.sdf")
    if not (os.path.exists(obj_path) and os.path.exists(sdf_path)):
        print(f"can not find obj/sdf for {object_name}")
        return None

    from ..geometry.mesh import center_of_mass as mesh_com

    verts, faces = read_obj(obj_path)
    sdf = read_sdf(sdf_path, device=device)
    com = mesh_com(verts, faces)

    fc_list = FC_LIST_LESS_CLASS if less_class else FC_LIST_FULL
    rows, counts, stats = label_grasps_for_object(
        sdf, com, gripper, Draws(seed, device), fc_list=fc_list, **kwargs)
    stats["object"] = object_name
    stats["n_rows"] = int(len(rows))
    if len(rows) == 0:
        print(f"finished job {object_name}: 0 rows ({stats})")
        return None, stats

    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(out_dir, f"{filename_prefix}_{object_name}_{len(rows)}")
    np.save(base + ".npy", rows)
    with open(base + ".pickle", "wb") as f:
        pickle.dump([(r[:10], r[10], r[11]) for r in rows], f)
    status = "quota met" if stats["quota_met"] else (
        "EXHAUSTED" if stats["exhausted"] else "budget spent")
    print(f"finished job {object_name}: counts={counts.tolist()} "
          f"({status}, {stats['rounds']} rounds x "
          f"{stats['attempts'] // max(stats['rounds'], 1)} attempts)")
    return base + ".npy", stats


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="grasp-label dataset generation")
    p.add_argument("prefix", nargs="?", default="default")
    p.add_argument("--data-root",
                   default=os.environ.get("PointNetGPD_FOLDER", ""))
    p.add_argument("--out-dir", default="./generated_grasps")
    p.add_argument("--gripper", default="robotiq_85")
    p.add_argument("--grasps-per-class", type=int, default=20)
    # the reference hardcodes the 'less' ladder (generate-dataset-canny.py:
    # 88-90); the full ladder is what the 1v_mc/fullv_mc thresholds need
    # to see class 2 (score = fc + 0.01 canny can then reach 0.4)
    p.add_argument("--ladder", choices=("less", "full"), default="less",
                   help="friction ladder: 'less' = [2.0, 1.6, 0.6] "
                   "(reference default), 'full' = 2.0..0.4 (required for "
                   "the 1v_mc/fullv_mc thresholds to see class 2)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-rounds", type=int, default=None,
                   help="attempt-budget escape hatch per object (rounds of "
                   "256 batched attempts); default scales with the quota")
    p.add_argument("--device", default="cuda",
                   help="torch device of the labeling (default: the card)")
    args = p.parse_args(argv)

    gripper = Gripper.named(args.gripper)
    file_dir = os.path.join(args.data_root,
                            "PointNetGPD/data/ycb-tools/models/ycb")
    if not os.path.isdir(file_dir):
        p.error(
            f"no YCB object models at {file_dir!r} — point --data-root (or "
            "$PointNetGPD_FOLDER) at a directory containing "
            "PointNetGPD/data/ycb-tools/models/ycb (the reference's layout)")
    objects = sorted(
        os.path.join(file_dir, d) for d in os.listdir(file_dir)
        if os.path.isdir(os.path.join(file_dir, d)))
    # a failing object is logged and skipped, as the reference's job pool
    # keeps going when a worker dies (generate-dataset-canny.py:171-179)
    all_stats = []
    os.makedirs(args.out_dir, exist_ok=True)
    for i, obj_dir in enumerate(objects):
        try:
            res = generate_for_object_dir(
                obj_dir, args.out_dir, gripper, seed=args.seed + i,
                filename_prefix=args.prefix,
                less_class=args.ladder == "less",
                grasps_per_class=args.grasps_per_class,
                max_rounds=args.max_rounds, device=args.device)
            if res is not None:
                all_stats.append(res[1])
        except Exception as e:
            with open(os.path.join(args.out_dir, "exceptions.txt"), "a") as f:
                f.write(f"{obj_dir}: {e}\n")
            print(f"FAILED {obj_dir}: {e}")
    if all_stats:
        rows_per_obj = [s["n_rows"] for s in all_stats]
        summary = {
            "grasps_per_class": args.grasps_per_class,
            "n_classes": len(all_stats[0]["fc_list"]),
            "target_rows_per_object": (args.grasps_per_class
                                       * len(all_stats[0]["fc_list"])),
            "total_rows": int(sum(rows_per_obj)),
            "rows_min": int(min(rows_per_obj)),
            "rows_median": float(np.median(rows_per_obj)),
            "rows_max": int(max(rows_per_obj)),
            "objects_quota_met": sum(s["quota_met"] for s in all_stats),
            "objects_exhausted": sum(s["exhausted"] for s in all_stats),
            "objects": all_stats,
        }
        with open(os.path.join(args.out_dir, "yield_summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print("All job done.")


if __name__ == "__main__":
    main()
