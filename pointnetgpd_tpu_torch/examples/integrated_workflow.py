"""Integrated 20-object offline workflow, driven through the port's CLIs.

Port of ``examples/integrated_workflow.py``. The reference's production
flow is mesh prep -> SDF -> grasp labeling -> cloud generation -> training
-> eval -> online detection (reference: dex-net/apps/read_file_sdf.py:34-73,
generate-dataset-canny.py:146-180, PointNetGPD/ycb_cloud_generate.py:
377-381, main_1v_mc.py, dex-net/apps/kinect2grasp.py). This driver runs the
stages together through the port's CLI entry points, each in a fresh
subprocess (``python -m pointnetgpd_tpu_torch.<stage> ... --device DEV``)
with reference-layout file handoffs, and records per-stage wall times
beside the card they ran on. Writes ``docs/WORKFLOW_20OBJ_TORCH.md``.

Stage 0 synthesizes 20 watertight meshes (randomized ellipsoids, boxes,
cylinders, cones, capsules, tori) as ASCII PLY, equal byte for byte to the
JAX driver's, which also exercises the PLY reader of prepare_objects.
``--sdf-dim``, ``--max-rounds``, ``--n-views`` and ``--max-points`` pass
through to the stage CLIs that have them; left unset, those CLIs' defaults
hold and the run is the JAX driver's (``--cloud-pad-to`` likewise sets the
detect stage's size bucket, 8192 in the JAX driver).

Run: python -m pointnetgpd_tpu_torch.examples.integrated_workflow \\
         --root ROOT --objects 20 --epochs 20 [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from ..pipelines.parity import _cone_mesh, _torus_mesh, _uv_sphere
from . import card_label

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PKG = "pointnetgpd_tpu_torch"
PRESETS = ("production", "reference_parity", "production_height_bias")


# ---------------------------------------------------------------------------
# Stage 0: synthesize meshes (ASCII PLY, reference YCB layout)
# ---------------------------------------------------------------------------


def _box_mesh(half):
    hx, hy, hz = half
    v = np.array([[sx * hx, sy * hy, sz * hz]
                  for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                 np.float32)
    f = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],  # x faces
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],  # y faces
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],  # z faces
    ], np.int32)
    return v, f


def _cylinder_mesh(r, h, nu=48):
    verts = [(0.0, 0.0, h / 2), (0.0, 0.0, -h / 2)]
    for j in range(nu):
        ph = 2 * np.pi * j / nu
        verts.append((r * np.cos(ph), r * np.sin(ph), h / 2))
        verts.append((r * np.cos(ph), r * np.sin(ph), -h / 2))
    top = lambda j: 2 + 2 * (j % nu)
    bot = lambda j: 3 + 2 * (j % nu)
    tris = []
    for j in range(nu):
        tris.append((0, top(j), top(j + 1)))
        tris.append((1, bot(j + 1), bot(j)))
        tris.append((top(j), bot(j), top(j + 1)))
        tris.append((top(j + 1), bot(j), bot(j + 1)))
    return np.asarray(verts, np.float32), np.asarray(tris, np.int32)


def _capsule_mesh(r, seg, nu=32, nv=16):
    verts, tris = _uv_sphere((r, r, r), nu=nu, nv=nv)
    verts = verts.copy()
    verts[:, 2] += np.where(verts[:, 2] >= 0, seg, -seg)
    return verts, tris


def write_ply(path, verts, tris):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(tris)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in tris:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def synth_meshes(root: str, n_objects: int, seed: int = 0):
    """Randomized graspable meshes in the reference's YCB directory layout."""
    rng = np.random.RandomState(seed)
    makers = [
        ("ellipsoid", lambda: _uv_sphere(
            (rng.uniform(0.022, 0.038), rng.uniform(0.02, 0.034),
             rng.uniform(0.018, 0.03)))),
        ("box", lambda: _box_mesh(
            (rng.uniform(0.015, 0.036), rng.uniform(0.015, 0.036),
             rng.uniform(0.012, 0.03)))),
        ("cylinder", lambda: _cylinder_mesh(
            rng.uniform(0.014, 0.03), rng.uniform(0.04, 0.1))),
        ("cone", lambda: _cone_mesh(
            rng.uniform(0.02, 0.034), rng.uniform(0.05, 0.09))),
        ("capsule", lambda: _capsule_mesh(
            rng.uniform(0.014, 0.026), rng.uniform(0.015, 0.035))),
        ("torus", lambda: _torus_mesh(
            rng.uniform(0.02, 0.03), rng.uniform(0.009, 0.014))),
    ]
    base = os.path.join(root, "PointNetGPD/data/ycb-tools/models/ycb")
    names = []
    for i in range(n_objects):
        kind, make = makers[i % len(makers)]
        name = f"{i:03d}_{kind}"
        gdir = os.path.join(base, name, "google_512k")
        os.makedirs(gdir, exist_ok=True)
        verts, tris = make()
        write_ply(os.path.join(gdir, "nontextured.ply"), verts, tris)
        names.append(name)
    # the dataset classes read clouds under {root}/data/... while meshes
    # live under {root}/PointNetGPD/data/... (the reference's own split
    # layout, model/dataset.py:226-227): one symlink serves both
    link = os.path.join(root, "data")
    if not os.path.exists(link):
        os.makedirs(os.path.join(root, "PointNetGPD/data"), exist_ok=True)
        os.symlink(os.path.join(root, "PointNetGPD/data"), link)
    return names


# ---------------------------------------------------------------------------
# CLI stage runner
# ---------------------------------------------------------------------------


def run_cli(args_list, root, log_path):
    """``python -m <args_list>`` in a fresh process under ``root``, its
    output appended to ``log_path``; returns its wall seconds."""
    env = dict(os.environ)
    env["PointNetGPD_FOLDER"] = root
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.time()
    with open(log_path, "a") as log:
        log.write(f"\n$ {' '.join(args_list)}\n")
        log.flush()
        proc = subprocess.run([sys.executable, "-m"] + args_list,
                              stdout=log, stderr=subprocess.STDOUT,
                              env=env, cwd=root)
    dt = time.time() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"stage {' '.join(args_list)} failed rc={proc.returncode} "
            f"(log: {log_path})")
    return dt


def split_labels(root: str, out_dir: str, train_frac: float = 0.8,
                 seed: int = 0):
    """generated_grasps/*.npy -> ycb_grasp/{train,test}/{obj}.npy + the
    google2cloud transform pickle (identity: synthetic meshes ARE the cloud
    frame). The reference does this arrangement by hand (README.md:156)."""
    import pickle

    rng = np.random.RandomState(seed)
    tr = os.path.join(root, "PointNetGPD/data/ycb_grasp/train")
    te = os.path.join(root, "PointNetGPD/data/ycb_grasp/test")
    os.makedirs(tr, exist_ok=True)
    os.makedirs(te, exist_ok=True)
    transform = {}
    n_rows = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "*.npy"))):
        rows = np.load(path)
        # filename: {prefix}_{object}_{n}.npy with object = NNN_kind
        stem = os.path.basename(path)[:-4]
        obj = "_".join(stem.split("_")[1:-1])
        rng.shuffle(rows)
        k = int(round(len(rows) * train_frac))
        np.save(os.path.join(tr, f"{obj}.npy"), rows[:k])
        np.save(os.path.join(te, f"{obj}.npy"), rows[k:])
        transform[obj] = (obj, np.eye(4, dtype=np.float32))
        n_rows[obj] = (k, len(rows) - k)
    with open(os.path.join(root, "PointNetGPD/data/google2cloud.pkl"),
              "wb") as f:
        pickle.dump(transform, f)
    return n_rows


def detect_stage(root: str, ckpt_dir: str, names, seed: int = 0,
                 num_classes: int = 2, num_seeds: int = 400,
                 num_point: int = 750, device="cuda", draws_for=None,
                 presets=PRESETS, raw=None, cloud_pad_to: int = 8192):
    """Online path on the trained model: compose a 3-object tabletop scene
    from the workflow's meshes with the native renderer, run the
    GraspDetector on it (kinect2grasp.py end to end) under each preset with
    the per-guard funnel table, and hold every candidate to the scene
    objects' exact SDFs (``pipelines/ground_truth.py``, on ``device``): do
    the classifier's top-ranked grasps have higher true epsilon-quality
    than the candidate pool?

    The cloud merges three registered low-elevation views, as the
    reference's /table_top_points input merges several kinects
    (README.md:195); GPG's downward-approach guard (grasp_sampler.py:
    1564-1569) needs side-surface seeds, which one overhead view lacks.
    Each preset gets a fresh detector: ``production``'s adaptive bucket
    depends on the stream's history.

    ``draws_for(preset, seed)``: the frame's draws under each preset
    (default: the detector's own from ``seed``). ``presets``: the subset
    to run. ``raw``: a dict that receives each preset's ``process_frame``
    output and ground truth, as (out, gt). ``cloud_pad_to``: the detectors'
    size bucket (the JAX driver's 8192)."""
    import torch

    from ..cli.infer import load_scorer
    from ..geometry.io import read_obj, read_sdf
    from ..geometry.mesh import Mesh3D
    from ..grasping.gripper import Gripper
    from ..pipelines.ground_truth import (ground_truth_quality,
                                          summarize_ground_truth)
    from ..pipelines.render_clouds import DEFAULT_INTR, backproject_depth
    from ..render.camera import (RenderMode, SceneObject, VirtualCamera,
                                 look_at_pose)
    from ..robot.node import DetectorConfig, GraspDetector

    # load_scorer's arguments. num_point is the TRAINED model's crop size,
    # as the reference pairs input_points_num with the loaded checkpoint
    # (kinect2grasp.py:58-63)
    args = argparse.Namespace(load_model=ckpt_dir, model_type=None,
                              k=num_classes, repeat=1, ref_path="",
                              num_point=num_point, device=device)
    scorer = load_scorer(args)
    base = os.path.join(root, "PointNetGPD/data/ycb-tools/models/ycb")
    # the 3 largest objects (bbox diagonal): graspable side surface area
    # drives GPG yield, and the smallest synthetic objects (~3 cm) leave
    # almost nothing after the table-clearance adjustment
    diag = []
    for nm in names:
        v, _ = read_obj(os.path.join(base, nm, "google_512k",
                                     "nontextured.obj"))
        diag.append((float(np.linalg.norm(np.ptp(v, axis=0))), nm))
    picks = [nm for _, nm in sorted(diag, reverse=True)[:3]]
    meshes = []
    objects = []  # (SdfGrid, world pose) for ground truth
    for j, nm in enumerate(picks):
        gdir = os.path.join(base, nm, "google_512k")
        v, f = read_obj(os.path.join(gdir, "nontextured.obj"))
        m = Mesh3D(v, f)
        lift = -float(np.asarray(m.vertices)[:, 2].min())
        t = np.eye(4)
        t[:2, 3] = [(-0.16, 0.14, 0.0)[j], (-0.05, -0.12, 0.16)[j]]
        t[2, 3] = lift  # rest on the table plane z=0
        meshes.append(SceneObject(m, t))
        objects.append((read_sdf(os.path.join(gdir, "nontextured.sdf"),
                                 device=device), t.astype(np.float32)))
    cam = VirtualCamera(DEFAULT_INTR)
    views = [np.array([0.45, 0.12, 0.28]), np.array([-0.12, -0.45, 0.28]),
             np.array([-0.3, 0.35, 0.3])]
    clouds = []
    for cam_c in views:
        t_wc = look_at_pose(cam_c, target=[0, 0, 0.03], up=[0, 0, 1.0])
        # as in the JAX driver, the first pick renders at its own frame's
        # pose (meshes[0].mesh), the others at theirs
        depth = cam.images(meshes[0].mesh, [(t_wc, cam_c)],
                           RenderMode.DEPTH, scene_objects=meshes[1:])[0]
        view_pts = backproject_depth(depth, DEFAULT_INTR.k, t_wc,
                                     device).cpu().numpy()
        # table segmentation (z=0 plane; the reference RANSAC-fits it)
        clouds.append(view_pts[view_pts[:, 2] > 0.004])
    pts = np.concatenate(clouds).astype(np.float32)
    # normals orient toward the primary camera, the reference's semantics
    # for a merged multi-kinect cloud (kinect2grasp.py:131-144); a
    # low-elevation primary camera keeps its hemisphere's side normals
    # outward, like the reference's rig
    cam_pos = views[0].astype(np.float32)
    gripper = Gripper()
    kw = dict(cloud_pad_to=cloud_pad_to, max_num_samples=num_seeds,
              input_points_num=num_point)
    cfgs = {
        "production": DetectorConfig.production(**kw),
        "reference_parity": DetectorConfig.reference_parity(**kw),
        # the deciding measurement for the seed_bias production default
        # (docs/FUNNEL.md): same production preset, height-biased seeds
        "production_height_bias": DetectorConfig.production(
            **kw, seed_bias="height"),
    }

    def run_preset(name):
        det = GraspDetector(scorer, gripper, config=cfgs[name])
        draws = None if draws_for is None else draws_for(name, seed)
        out = det.process_frame(pts, cam_pos, seed=seed, funnel=True,
                                draws=draws)
        pred = np.asarray(out["pred"])
        pts_np = out["points"].cpu().numpy()
        gt = ground_truth_quality(out["all_frames"], objects, gripper,
                                  points=pts_np)
        if raw is not None:
            raw[name] = (out, gt)
        # classifier ranking over the candidate buffer: best-class prob
        # descending (the publish order, kinect2grasp.py:506-514)
        ranked = np.argsort(-np.asarray(out["all_scores"], np.float64),
                            kind="stable")
        summary = summarize_ground_truth(gt, ranked, top_k=5)
        # approved == voted best class (the reference's publish rule)
        approved = np.where(pred == num_classes - 1)[0]
        if len(approved):
            summary["approved_mean_eps_mu0.6"] = round(
                float(np.mean(gt["eps_good"][approved])), 5)
            summary["approved_frac_fc_mu0.6"] = round(
                float(np.mean(gt["fc_good"][approved])), 4)
        return {
            "preset": name,
            "candidates": int(len(out["all_frames"])),
            "n_valid": int(out["n_valid"]),
            "pred_hist": np.bincount(
                pred, minlength=num_classes).tolist()
            if len(pred) else [0] * num_classes,
            "good_grasps": int(len(out["grasps"])),
            "top_score": float(out["scores"][0]) if len(out["scores"])
            else None,
            "funnel": {k: int(v) for k, v in out["funnel"].items()
                       if np.ndim(v) == 0},
            "ground_truth": summary,
        }

    res = {"scene_points": int(len(pts)), "scene_objects": picks,
           "num_seeds": num_seeds}
    for name in presets:
        res[name] = run_preset(name)
    if "production" in res:
        # headline fields mirror the production preset
        for k in ("candidates", "pred_hist", "good_grasps", "top_score"):
            res[k] = res["production"][k]
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return res


VARIANT_CFG = {
    # training variant -> (classes, thresholds, crop size) for the report's
    # label histogram + the detect stage's scorer (cli/train.py VARIANTS)
    "1v": dict(num_classes=2, thresh_good=0.6, thresh_bad=0.6,
               num_point=750),
    "1v_mc": dict(num_classes=3, thresh_good=0.5, thresh_bad=1.2,
                  num_point=750),
    # fullv: merged multi-view training clouds (main_fullv.py), the
    # in-distribution choice when the deployment cloud merges several
    # registered cameras (the detect stage's 3-view tabletop)
    "fullv": dict(num_classes=2, thresh_good=0.6, thresh_bad=0.6,
                  num_point=1000),
}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None,
                   help="the workflow's tree (default: a new directory"
                   " under the system's temporary directory, printed)")
    p.add_argument("--objects", type=int, default=20)
    p.add_argument("--variant", choices=sorted(VARIANT_CFG), default="1v",
                   help="1v = 2-class main_1v semantics (thresh .6/.6);"
                   " 1v_mc = 3-class; fullv = merged multi-view training"
                   " clouds (main_fullv.py), in-distribution for the merged"
                   " 3-view detect scene")
    p.add_argument("--views-per-sample", type=int, default=None,
                   help="override the variant's view-merge count")
    p.add_argument("--cloud-points", type=int, default=None,
                   help="override the variant's per-sample cloud size")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--steps-per-epoch", type=int, default=60)
    p.add_argument("--grasps-per-class", type=int, default=20)
    p.add_argument("--num-seeds", type=int, default=400,
                   help="GPG seed budget for the detect stage")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gpd", action="store_true",
                   help="also train and test the GPD projection-CNN"
                   " baseline (--variant 1v_gpd) on the same dataset, the"
                   " main_1v_gpd.py path end to end")
    p.add_argument("--gpd-epochs", type=int, default=10)
    p.add_argument("--sdf-dim", type=int, default=None,
                   help="prepare_objects' --sdf-dim (default: its own, 100)")
    p.add_argument("--max-rounds", type=int, default=None,
                   help="generate_dataset's --max-rounds (default: its"
                   " own)")
    p.add_argument("--n-views", type=int, default=None,
                   help="render_clouds' --n-views (default: its own, 6)")
    p.add_argument("--max-points", type=int, default=None,
                   help="render_clouds' --max-points (default: its own,"
                   " 40000)")
    p.add_argument("--cloud-pad-to", type=int, default=8192,
                   help="the detect stage's size bucket (the JAX driver's"
                   " 8192)")
    p.add_argument("--out-md", default="docs/WORKFLOW_20OBJ_TORCH.md")
    p.add_argument("--fresh", action="store_true",
                   help="wipe --root before running")
    p.add_argument("--resume", action="store_true",
                   help="skip stages already recorded in stage_times.json"
                   " (their outputs are reused; recorded times kept)")
    p.add_argument("--device", default="cuda",
                   help="device of every stage (default: the card)")
    return p


def _opt(flag, value):
    return [] if value is None else [flag, str(value)]


def main(argv=None, draws_for=None):
    """``draws_for(preset, seed)``: the detect stage's draws (default: the
    detector's own)."""
    args = build_parser().parse_args(argv)
    dev = ["--device", args.device]

    if args.root is None:
        if args.resume:
            raise SystemExit("--resume needs the tree's --root")
        args.root = tempfile.mkdtemp(prefix="workflow20_")
        print(f"workflow tree: {args.root}", flush=True)
    root = os.path.abspath(args.root)
    if args.fresh and os.path.isdir(root):
        shutil.rmtree(root)
    os.makedirs(root, exist_ok=True)
    log = os.path.join(root, "workflow.log")
    times_path = os.path.join(root, "stage_times.json")
    times = {}
    if args.resume and os.path.exists(times_path):
        times = json.load(open(times_path))

    def stage(key, fn):
        """Run one stage (unless resumed) and persist its wall time, so an
        interrupted run restarts from the first incomplete stage."""
        if key not in times:
            t0 = time.time()
            out = fn()
            times[key] = (out if isinstance(out, float)
                          else time.time() - t0)
            json.dump(times, open(times_path, "w"))
        return times[key]

    t0 = time.time()
    if "0_synth_meshes" not in times:
        names = synth_meshes(root, args.objects, seed=args.seed)
        times["0_synth_meshes"] = time.time() - t0
        json.dump(times, open(times_path, "w"))
    else:  # resumed: recover the object names from the mesh tree
        base = os.path.join(root, "PointNetGPD/data/ycb-tools/models/ycb")
        names = sorted(os.listdir(base))

    stage("1_prepare_objects_sdf", lambda: run_cli(
        [f"{PKG}.pipelines.prepare_objects", "--data-root", root]
        + _opt("--sdf-dim", args.sdf_dim) + dev, root, log))
    out_dir = os.path.join(root, "generated_grasps")
    # --ladder full: the reference's less_class ladder ({2.0, 1.6, 0.6})
    # can never produce a row in the 1v_mc "good" band (score <= 0.5)
    stage("2_generate_dataset", lambda: run_cli(
        [f"{PKG}.pipelines.generate_dataset", "r4", "--data-root",
         root, "--out-dir", out_dir, "--grasps-per-class",
         str(args.grasps_per_class), "--ladder", "full",
         "--seed", str(args.seed)] + _opt("--max-rounds", args.max_rounds)
        + dev, root, log))
    # the split is cheap and idempotent (same seed -> same split): always
    # re-run it so n_rows is available on resume
    t0 = time.time()
    n_rows = split_labels(root, out_dir, seed=args.seed)
    times.setdefault("3_split_labels", time.time() - t0)
    stage("4_render_clouds", lambda: run_cli(
        [f"{PKG}.pipelines.render_clouds", "--data-root", root]
        + _opt("--n-views", args.n_views)
        + _opt("--max-points", args.max_points) + dev, root, log))
    # per-variant checkpoint dir: a shared dir would resolve "newest step"
    # across variants and hand the detect stage the wrong model
    model_path = os.path.join(root, "learned_models"
                              if args.variant == "1v"
                              else f"learned_models_{args.variant}")
    extra_train = (_opt("--views-per-sample", args.views_per_sample)
                   + _opt("--cloud-points", args.cloud_points))
    stage(f"5_train_{args.variant}", lambda: run_cli(
        [f"{PKG}.cli.train", "--variant", args.variant, "--mode",
         "train", "--tag", "wf20", "--epoch", str(args.epochs),
         "--batch-size", str(args.batch_size), "--steps-per-epoch",
         str(args.steps_per_epoch), "--eval-steps", "20",
         "--data-root", root, "--model-path",
         model_path, "--log-dir", os.path.join(root, "log")]
        + extra_train + dev, root, log))
    stage(f"6_eval_{args.variant}", lambda: run_cli(
        eval_command(args, root, model_path) + extra_train + dev, root,
        log))
    if args.gpd:
        # the GPD projection-CNN baseline through the same CLIs
        # (main_1v_gpd.py:50-115)
        gpd_path = os.path.join(root, "learned_models_gpd")
        stage("5b_train_1v_gpd", lambda: run_cli(
            [f"{PKG}.cli.train", "--variant", "1v_gpd", "--mode",
             "train", "--tag", "wf20gpd", "--epoch", str(args.gpd_epochs),
             "--batch-size", str(args.batch_size), "--steps-per-epoch",
             str(args.steps_per_epoch), "--eval-steps", "20",
             "--data-root", root, "--model-path", gpd_path,
             "--log-dir", os.path.join(root, "log")] + dev, root, log))
        stage("6b_eval_1v_gpd", lambda: run_cli(
            [f"{PKG}.cli.train", "--variant", "1v_gpd", "--mode",
             "test", "--tag", "wf20gpd",
             "--load-epoch", str(args.gpd_epochs - 1),
             "--batch-size", str(args.batch_size), "--eval-steps", "20",
             "--data-root", root, "--model-path", gpd_path,
             "--log-dir", os.path.join(root, "log")] + dev, root, log))

    # the standalone inference CLI on one generated view crop; cli.infer
    # resolves the train CLI's --model-path directory to its newest step_N
    ckpt_dir = model_path
    any_cloud = sorted(glob.glob(os.path.join(
        root, "data/ycb-tools/models/ycb/*/rgbd/clouds/*.npy")))[0]
    stage("7_infer_cli", lambda: run_cli(
        [f"{PKG}.cli.infer", "--load-model", ckpt_dir, "--input",
         any_cloud, "--repeat", "3",
         "--k", str(VARIANT_CFG[args.variant]["num_classes"])] + dev,
        root, log))
    det_path = os.path.join(root, "det.json")
    vcfg = VARIANT_CFG[args.variant]
    if args.resume and "8_detect_frame" in times and os.path.exists(det_path):
        det = json.load(open(det_path))
    else:
        t0 = time.time()
        det = detect_stage(root, ckpt_dir, names, seed=args.seed,
                           num_classes=vcfg["num_classes"],
                           num_seeds=args.num_seeds,
                           num_point=vcfg["num_point"], device=args.device,
                           draws_for=draws_for,
                           cloud_pad_to=args.cloud_pad_to)
        times["8_detect_frame"] = time.time() - t0
        json.dump(times, open(times_path, "w"))
        json.dump(det, open(det_path, "w"))

    total_rows = sum(a + b for a, b in n_rows.values())
    eval_acc = _parse_eval_acc(log, variant=args.variant)
    gpd_acc = _parse_eval_acc(log, variant="1v_gpd") if args.gpd else None
    test_hist = _test_label_hist(root, vcfg)
    yield_summary = _load_yield_summary(out_dir)
    card = card_label(args.device)
    report(args, names, n_rows, total_rows, times, det, log,
           eval_acc=eval_acc, test_hist=test_hist,
           yield_summary=yield_summary, gpd_acc=gpd_acc, card=card)
    print(json.dumps({"times_s": {k: round(v, 1) for k, v in times.items()},
                      "card": card, "detect": det, "total_rows": total_rows,
                      "eval_acc": eval_acc, "gpd_acc": gpd_acc,
                      "test_hist": test_hist}))
    return 0


def eval_command(args, root, model_path):
    """The eval stage's ``cli.train --mode test`` arguments (without the
    variant's overrides and ``--device``)."""
    return [f"{PKG}.cli.train", "--variant", args.variant, "--mode",
            "test", "--tag", "wf20", "--load-epoch", str(args.epochs - 1),
            "--batch-size", str(args.batch_size), "--eval-steps", "20",
            "--data-root", root, "--model-path", model_path,
            "--log-dir", os.path.join(root, "log")]


def _parse_eval_acc(log_path, variant=None):
    """Last ``Test done, acc=...`` line the eval stage appended to the log
    (cli.train --mode test prints the reference's format, main_1v.py:108),
    scoped to the given --variant's eval stage when several variants eval
    into the same log (e.g. --gpd). One malformed line must not mask a
    later valid one, so the float parse is guarded per line."""
    acc = None
    current = None  # variant of the most recent cli.train invocation
    try:
        for ln in open(log_path, errors="replace"):
            if ln.startswith("$ ") and "--variant" in ln:
                toks = ln.split()
                current = toks[toks.index("--variant") + 1] \
                    if "--variant" in toks else None
            if "Test done, acc=" in ln:
                if variant is not None and current != variant:
                    continue
                try:
                    acc = float(ln.split("acc=")[1].split(",")[0])
                except ValueError:
                    continue
    except OSError:
        pass
    return acc


def _test_label_hist(root, vcfg):
    """Label histogram of the test split under the training variant's
    thresholds: the majority-class prior the eval accuracy must beat to
    show the model learned anything."""
    from ..training.data import labels_from_scores

    k = vcfg["num_classes"]
    hist = np.zeros(k, np.int64)
    for pth in sorted(glob.glob(os.path.join(
            root, "PointNetGPD/data/ycb_grasp/test/*.npy"))):
        rows = np.load(pth)
        if not len(rows):
            continue
        lab, w = labels_from_scores(rows[:, -2], rows[:, -1],
                                    vcfg["thresh_good"], vcfg["thresh_bad"],
                                    k)
        lab = np.asarray(lab)[np.asarray(w) > 0]
        hist += np.bincount(lab, minlength=k)[:k]
    return hist.tolist()


def _load_yield_summary(out_dir):
    """pipelines.generate_dataset's per-object quota accounting
    (yield_summary.json), or None where it is absent."""
    pth = os.path.join(out_dir, "yield_summary.json")
    if os.path.exists(pth):
        return json.load(open(pth))
    return None


def report(args, names, n_rows, total_rows, times, det, log,
           eval_acc=None, test_hist=None, yield_summary=None,
           gpd_acc=None, card="cpu"):
    """Write the run's markdown report to ``args.out_md``; ``card`` names
    the device (and its power limit) beside every time."""
    vcfg = VARIANT_CFG[args.variant]
    k = vcfg["num_classes"]
    ladder_note = ("2-class main_1v semantics, thresh .6/.6"
                   if k == 2 else "3-class, thresh 0.5/1.2")
    lines = [
        f"# Integrated offline workflow at {len(names)}-object scale"
        " (PyTorch/CUDA port)",
        "",
        "One command (`python -m"
        " pointnetgpd_tpu_torch.examples.integrated_workflow`) drives the",
        "whole offline flow through the port's CLI entry points in fresh",
        "subprocesses with reference-layout file handoffs: synth meshes ->",
        "`pipelines.prepare_objects` (PLY->OBJ+SDF, the read_file_sdf.py",
        "replacement) -> `pipelines.generate_dataset` (grasp labels, the",
        "generate-dataset-canny.py replacement) -> train/test split ->",
        "`pipelines.render_clouds` (per-view clouds; stands in for",
        "ycb_cloud_generate.py's RGB-D conversion, which needs real",
        f"captures) -> `cli.train --variant {args.variant}` -> `cli.train"
        " --mode test` -> `cli.infer` -> GraspDetector (three presets) on a",
        "rendered 3-object tabletop frame, with every candidate",
        "held to the scene objects' exact SDFs.",
        "",
        f"- device: {card} (`--device {args.device}`)",
        f"- objects: {len(names)} ({args.grasps_per_class}/class target,"
        " full friction ladder)",
        f"- labeled rows: {total_rows} (12-col reference format)",
        f"- training: {args.epochs} epochs x {args.steps_per_epoch} steps,"
        f" batch {args.batch_size}, variant {args.variant} ({ladder_note})",
    ]
    cuts = [f"{flag} {val}" for flag, val in (
        ("--sdf-dim", args.sdf_dim), ("--max-rounds", args.max_rounds),
        ("--n-views", args.n_views), ("--max-points", args.max_points),
        ("--cloud-pad-to", None if args.cloud_pad_to == 8192
         else args.cloud_pad_to)) if val is not None]
    if cuts:
        lines.append(f"- stage CLI overrides: {', '.join(cuts)}")
    if eval_acc is not None and test_hist and sum(test_hist):
        prior = max(test_hist) / sum(test_hist)
        n_test = sum(test_hist)
        sigma = (prior * (1 - prior) / n_test) ** 0.5
        margin = (eval_acc - prior) / sigma if sigma > 0 else float("inf")
        lines.append(
            f"- **eval on the held-out split: test acc {eval_acc:.3f} vs"
            f" majority prior {prior:.3f}** ({margin:+.1f} sigma at"
            f" {n_test} weighted test rows; label histogram {test_hist},"
            f" {args.variant} thresholds)")
    if gpd_acc is not None:
        lines.append(
            f"- GPD projection-CNN baseline (variant 1v_gpd,"
            f" {args.gpd_epochs} epochs, main_1v_gpd.py path): test acc"
            f" {gpd_acc:.3f} on the same split")
    for other in sorted(VARIANT_CFG):
        if other == args.variant:
            continue
        acc_o = _parse_eval_acc(log, variant=other)
        if acc_o is not None:
            lines.append(
                f"- variant {other} (also trained this run): test acc"
                f" {acc_o:.3f}")
    if yield_summary:
        ys = yield_summary
        lines += [
            "",
            "## Labeling yield (quota accounting)",
            "",
            f"Target: {ys['grasps_per_class']}/class x {ys['n_classes']}"
            f" friction classes = {ys['target_rows_per_object']} rows per"
            f" object ({ys['target_rows_per_object'] * len(names)} total).",
            f"Achieved: **{ys['total_rows']} rows**: per object"
            f" min {ys['rows_min']} / median {ys['rows_median']:.0f} /"
            f" max {ys['rows_max']};"
            f" {ys['objects_quota_met']}/{len(ys['objects'])} objects met"
            f" the full quota, {ys['objects_exhausted']} declared"
            " exhausted (no new accepted row for `patience` consecutive"
            " rounds; the reference's while-loop would spin on those"
            " forever, generate-dataset-canny.py:109-134).",
        ]
        shortfalls = [o for o in ys["objects"] if not o["quota_met"]]
        if shortfalls:
            lines += ["", "| object | rows | per-class counts | status |",
                      "|---|---|---|---|"]
            for o in shortfalls:
                status = ("exhausted" if o["exhausted"] else "budget spent")
                lines.append(f"| {o['object']} | {o['n_rows']} |"
                             f" {o['per_class']} | {status} |")
    lines += [
        "",
        f"## Per-stage wall time ({card})",
        "",
        "Host clock around each stage; a CLI stage's time includes its",
        "process start.",
        "",
        f"| stage | wall time ({card}) | reference anchor |",
        "|---|---|---|",
    ]
    anchors = {
        "0_synth_meshes": "(synthetic stand-in for YCB downloads)",
        "1_prepare_objects_sdf": "SDFGen shell-outs over mp.Pool"
                                 " (read_file_sdf.py:34-73)",
        "2_generate_dataset": "50 procs/object x ~hours/object"
                              " (generate-dataset-canny.py:36-40)",
        "3_split_labels": "manual arrangement (README.md:156)",
        "4_render_clouds": "~36 h YCB RGB-D conversion on 56 threads"
                           " (README.md:166)",
        f"5_train_{args.variant}": "200-epoch torch DataParallel run"
                                   " (README.md:178-181)",
        f"6_eval_{args.variant}": "per-epoch test pass (main_1v.py:87-110)",
        "7_infer_cli": "main_test.py demo loop",
        "8_detect_frame": "kinect2grasp.py frame (20 sampler procs)",
    }
    for key, v in times.items():
        mins = f"{v / 60:.1f} min" if v >= 60 else f"{v:.1f} s"
        lines.append(f"| {key} | {mins} | {anchors.get(key, '')} |")
    total = sum(times.values())
    lines += [
        "",
        f"**Total: {total / 60:.1f} min end to end on {card} + host.**",
        "",
        "## Online detection on the trained model",
        "",
        f"- rendered tabletop scene: {det['scene_points']} points"
        f" (3 merged registered views, like the reference's multi-kinect"
        f" /table_top_points), 3 objects"
        f" ({', '.join(det.get('scene_objects', []))}),"
        f" {det.get('num_seeds', 300)} GPG seeds",
    ]
    for preset in PRESETS:
        d = det.get(preset)
        if not d:
            continue
        lines += [
            "",
            f"### Preset `{preset}`",
            "",
            f"- candidates: {d['candidates']} in the {args.num_seeds}-seed"
            f" budget (sampler valid total {d['n_valid']}; reference"
            " target: 40/frame, kinect2grasp.py:42-44)",
            f"- class histogram {d['pred_hist']};"
            f" classifier-approved grasps: {d['good_grasps']}"
            + (f"; top score {d['top_score']:.3f}"
               if d["top_score"] is not None else ""),
        ]
        f_tab = d.get("funnel")
        if f_tab:
            lines += ["", "Per-guard funnel ((seed x theta) frames"
                      " surviving each GPG guard, reference order"
                      " grasp_sampler.py:1539-1614):", "",
                      "| " + " | ".join(f_tab) + " |",
                      "|" + "---|" * len(f_tab),
                      "| " + " | ".join(str(f_tab[key]) for key in f_tab)
                      + " |"]
        gt = d.get("ground_truth")
        if gt:
            lines += [
                "",
                "Ground truth vs the exact scene SDFs (epsilon ="
                " Ferrari-Canny force-only at mu=0.6, the main_1v"
                " good-band friction; quality.py:626-723):",
                "",
                f"- candidate pool: mean eps {gt['pool_mean_eps_mu0.6']},"
                f" {gt['pool_frac_fc_mu0.6']:.0%} force-closure at mu 0.6,"
                f" {gt['pool_frac_fc_mu2.0']:.0%} FC at mu 2.0"
                + (f" ({gt['frac_centers_inside']:.0%} of mapped grasp"
                   " centers inside their object)"
                   if gt.get("frac_centers_inside") is not None else ""),
                f"- classifier top-{gt['top_k']}: mean eps"
                f" {gt['topk_mean_eps_mu0.6']},"
                + (f" {gt['topk_frac_fc_mu0.6']:.0%} FC at mu 0.6"
                   if gt["topk_frac_fc_mu0.6"] is not None else " n/a")
                + (f"; approved set: mean eps"
                   f" {gt['approved_mean_eps_mu0.6']},"
                   f" {gt['approved_frac_fc_mu0.6']:.0%} FC"
                   if "approved_mean_eps_mu0.6" in gt else ""),
            ]
    closing = [
        "",
        "Approval follows the reference's rule: a grasp is published only",
        "if its voted class equals the best class (kinect2grasp.py:493-495).",
    ]
    if eval_acc is not None and test_hist and sum(test_hist):
        prior = max(test_hist) / sum(test_hist)
        if eval_acc > prior:
            closing.append(
                f"The trained classifier beats the majority prior"
                f" ({eval_acc:.3f} vs {prior:.3f}); the ground-truth tables"
                " above measure whether its ranking transfers to true"
                " grasp quality on the rendered scene.")
        else:
            closing.append(
                f"At this run's data scale the classifier did NOT beat the"
                f" majority prior ({eval_acc:.3f} vs {prior:.3f}); compare"
                " the eval line above and docs/TRAINING_PARITY_TORCH.md.")
    closing.append("")
    closing.append(
        f"Stage logs: `{os.path.basename(log)}` under the workflow root.")
    lines += closing
    os.makedirs(os.path.dirname(args.out_md) or ".", exist_ok=True)
    with open(args.out_md, "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    sys.exit(main())
