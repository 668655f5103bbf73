"""Ground-truth validation of detected grasps against the scene's exact SDFs.

Port of ``pointnetgpd_tpu/pipelines/ground_truth.py``: every candidate the
online detector proposes is scored with the offline labeler's physics,
force closure over the friction ladder and the Ferrari-Canny epsilon
(reference: dex-net/src/dexnet/grasping/quality.py:245-283, 626-723),
against the exact SDF of the object it grasps. The statistics answer
whether the classifier's top-ranked grasps have higher true quality than
the candidate pool.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import sdf as sdf_lib
from ..grasping.evaluation import (
    FC_LIST_FULL,
    evaluate_ferrari_canny,
    evaluate_force_closure,
    friction_boundary_labels,
)
from ..grasping.grasp import adaptive_num_samples
from ..grasping.gripper import Gripper


def configs_from_frames(frames: np.ndarray, gripper: Gripper,
                        points: np.ndarray | None = None) -> np.ndarray:
    """GPG candidate frames (G, 5, 3) [bottom_center, approach, major,
    minor, bottom_center_modified] -> (G, 10) world configurations (host
    numpy). The center sits at the centroid, in all three hand axes, of the
    observed points inside the closing region (the crop's membership,
    kinect2grasp.py:216-233; the |z| < hand_height/2 gate is the JAX
    package's), or half the hand depth along the approach axis when fewer
    than 3 points land there."""
    frames = np.asarray(frames, np.float32)
    g = len(frames)
    configs = np.zeros((g, 10), np.float32)
    for i, fr in enumerate(frames):
        bc, approach, major, minor = fr[4], fr[1], fr[2], fr[3]
        off = approach * (gripper.hand_depth / 2.0)
        if points is not None and len(points):
            rel = points - bc
            x = rel @ approach
            y = rel @ major
            z = rel @ minor
            inside = ((x > 0) & (x < gripper.hand_depth)
                      & (np.abs(y) < gripper.open_width / 2.0)
                      & (np.abs(z) < gripper.hand_height / 2.0))
            if inside.sum() >= 3:
                off = (approach * float(np.mean(x[inside]))
                       + major * float(np.mean(y[inside]))
                       + minor * float(np.mean(z[inside])))
        configs[i, 0:3] = bc + off
        configs[i, 3:6] = major
        configs[i, 6] = gripper.open_width
    return configs


def ground_truth_quality(frames: np.ndarray, objects, gripper: Gripper,
                         points: np.ndarray | None = None,
                         fc_list=None, mu_good: float = 0.6,
                         num_samples: int | None = None):
    """Per-candidate ground truth against the scene objects' SDFs.

    objects: list of (SdfGrid, transform (4, 4)): each object's SDF in its
    own frame and its world pose. Each candidate goes to the object whose
    bbox center is nearest its configuration center, moves into that
    object's frame, and is labeled on the SDF's device with the ladder
    boundary label, Ferrari-Canny at that friction, and force closure and
    epsilon at ``mu_good``.

    Returns a dict of (G,) arrays: obj_idx, fc_label, label_valid,
    eps_label, score (fc_label + 0.01 eps_label), fc_good, eps_good,
    center_sdf."""
    frames = np.asarray(frames, np.float32)
    fc_list = FC_LIST_FULL if fc_list is None else np.asarray(fc_list)
    g = len(frames)
    out = {
        "obj_idx": np.full(g, -1, np.int32),
        "fc_label": np.zeros(g, np.float32),
        "label_valid": np.zeros(g, bool),
        "eps_label": np.zeros(g, np.float32),
        "score": np.full(g, np.inf, np.float32),
        "fc_good": np.zeros(g, bool),
        "eps_good": np.zeros(g, np.float32),
        # SDF value at each center in its object's frame: > 0 means the
        # frame -> config mapping failed for that candidate
        "center_sdf": np.full(g, np.inf, np.float32),
    }
    if g == 0:
        return out

    configs = configs_from_frames(frames, gripper, points)
    centers_w = []
    for sdf, t in objects:
        t = np.asarray(t, np.float32)
        origin = sdf.origin.cpu().numpy()
        res = np.float32(float(sdf.resolution))
        top = np.asarray([d - 1 for d in sdf.dims], np.float32)
        c_obj = 0.5 * (origin + (origin + res * top))
        centers_w.append(t[:3, :3] @ c_obj + t[:3, 3])
    centers_w = np.stack(centers_w)
    d2 = np.sum((configs[:, None, 0:3] - centers_w[None]) ** 2, axis=2)
    out["obj_idx"] = np.argmin(d2, axis=1).astype(np.int32)

    for j, (sdf, t) in enumerate(objects):
        sel = np.where(out["obj_idx"] == j)[0]
        if len(sel) == 0:
            continue
        dev = sdf.data.device
        ns = num_samples
        if ns is None:
            ns = adaptive_num_samples(sdf, gripper.open_width)
        t = np.asarray(t, np.float32)
        r, tr = t[:3, :3], t[:3, 3]
        cfg_o = configs[sel].copy()
        cfg_o[:, 0:3] = (configs[sel, 0:3] - tr) @ r  # R^T (c - t)
        cfg_o[:, 3:6] = configs[sel, 3:6] @ r

        # slide the center along the approach axis (+-hand_depth/2) to the
        # exact SDF's minimum where it is not interior already
        app_o = np.asarray(frames[sel, 1], np.float32) @ r
        depths = np.linspace(-gripper.hand_depth / 2.0,
                             gripper.hand_depth / 2.0, 17, dtype=np.float32)
        cand_pts = (cfg_o[:, None, 0:3]
                    + depths[None, :, None] * app_o[:, None, :])
        vals = sdf_lib.signed_distance(sdf, sdf_lib.world_to_grid(
            sdf, torch.as_tensor(cand_pts.reshape(-1, 3), device=dev)))
        vals = vals.cpu().numpy().reshape(len(sel), -1)
        refined = cand_pts[np.arange(len(sel)), np.argmin(vals, axis=1)]
        cfg_o[:, 0:3] = np.where((vals[:, 8] < 0)[:, None], cfg_o[:, 0:3],
                                 refined)
        cfg_dev = torch.as_tensor(cfg_o, device=dev)
        out["center_sdf"][sel] = sdf_lib.signed_distance(
            sdf, sdf_lib.world_to_grid(sdf, cfg_dev[:, 0:3])).cpu().numpy()

        fc_dev = torch.as_tensor(np.asarray(fc_list, np.float32), device=dev)
        label_fc, _, valid = friction_boundary_labels(
            sdf, cfg_dev, fc_dev, num_samples=ns, n_fc=len(fc_list))
        # the force-only metric ignores the center of mass; zero keeps the
        # labeler's call shape
        com = torch.zeros(3, device=dev)
        eps_label, _ = evaluate_ferrari_canny(sdf, cfg_dev, com, label_fc,
                                              num_samples=ns)
        fc_good, _ = evaluate_force_closure(sdf, cfg_dev, mu_good,
                                            num_samples=ns)
        eps_good, _ = evaluate_ferrari_canny(sdf, cfg_dev, com, mu_good,
                                             num_samples=ns)

        valid = valid.cpu().numpy()
        label_fc = label_fc.cpu().numpy()
        eps_label = eps_label.cpu().numpy()
        out["fc_label"][sel] = np.where(valid, label_fc, 0.0)
        out["label_valid"][sel] = valid
        out["eps_label"][sel] = np.where(valid, eps_label, 0.0)
        out["score"][sel] = np.where(valid, label_fc + 0.01 * eps_label,
                                     np.inf)
        out["fc_good"][sel] = fc_good.cpu().numpy().astype(bool)
        out["eps_good"][sel] = np.where(out["fc_good"][sel],
                                        eps_good.cpu().numpy(), 0.0)
    return out


def summarize_ground_truth(gt: dict, ranked_order: np.ndarray,
                           top_k: int = 5) -> dict:
    """Classifier-top-k mean true quality against the candidate-pool mean.
    ranked_order: candidate indices by classifier score, descending."""
    g = len(gt["eps_good"])
    pool_eps = float(np.mean(gt["eps_good"])) if g else 0.0
    pool_fc = float(np.mean(gt["fc_good"])) if g else 0.0
    top = np.asarray(ranked_order)[:top_k]
    top_eps = float(np.mean(gt["eps_good"][top])) if len(top) else None
    top_fc = float(np.mean(gt["fc_good"][top])) if len(top) else None
    return {
        "n_candidates": int(g),
        "n_ranked": int(len(ranked_order)),
        "top_k": int(min(top_k, len(top))),
        "frac_centers_inside": (round(float(np.mean(
            gt["center_sdf"] < 0)), 4) if g else None),
        "pool_mean_eps_mu0.6": round(pool_eps, 5),
        "pool_frac_fc_mu0.6": round(pool_fc, 4),
        "topk_mean_eps_mu0.6": (round(top_eps, 5)
                                if top_eps is not None else None),
        "topk_frac_fc_mu0.6": (round(top_fc, 4)
                               if top_fc is not None else None),
        "pool_frac_fc_mu2.0": (float(np.mean(gt["label_valid"]))
                               if g else 0.0),
    }
