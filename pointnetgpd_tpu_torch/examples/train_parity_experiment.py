"""Training-accuracy parity experiment: the reference's torch trainer vs
the port's.

Port of ``examples/train_parity_experiment.py``. Generates a labeled grasp
dataset with the port's own labeling path in the reference's on-disk
layout (``pipelines.parity.build_parity_dataset``; mesh objects through
the voxelizer's kernel K3 on the card), then trains the port's path
(``train_ours``: OneViewBatcher + the fused crop train step, eval through
the trunk kernel K2) and, unless ``--skip-reference``, the reference's own
dataset and model code from a reference checkout (``train_reference``,
main_1v_mc.py loop semantics, torch on the CPU) on the identical files,
with the same epochs, batch and lr over several seeds each. Writes the
mean +- std accuracy comparison to ``docs/TRAINING_PARITY_TORCH.md`` and
the curves to ``docs/training_parity_curves_torch.json``.

The JAX driver enables XLA's persistent compilation cache first
(``utils/cache.py``); the port has no counterpart: its compiled code is the
kernel library, which ``_build.py`` caches by a hash of its sources.
``--sdf-dim``, ``--sdf-res``, ``--views-per-object`` and
``--points-per-view`` pass through to ``build_parity_dataset`` (default:
its own).

Run: python -m pointnetgpd_tpu_torch.examples.train_parity_experiment \\
         --root ROOT --epochs 40 --seeds 3 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import tempfile
import time

import numpy as np

from . import card_label


def _run_reference_seed(payload):
    """Subprocess target: one reference-trainer seed (torch CPU)."""
    (root, epochs, batch_size, lr, num_points, n_train, n_test, seed,
     torch_threads, num_classes, thresh_good, thresh_bad) = payload
    import torch

    torch.set_num_threads(torch_threads)
    from ..pipelines import parity

    t0 = time.time()
    # num_workers=0: this already runs inside a daemonic Pool worker, which
    # cannot spawn DataLoader children
    hist = parity.train_reference(
        root, epochs=epochs, batch_size=batch_size, lr=lr,
        num_points=num_points, grasp_amount_train=n_train,
        grasp_amount_test=n_test, seed=seed, num_workers=0,
        num_classes=num_classes, thresh_good=thresh_good,
        thresh_bad=thresh_bad)
    hist["seconds"] = round(time.time() - t0, 1)
    hist["seed"] = seed
    return hist


# 2-class default object set: every object carries both label populations
OBJECTS_2CLASS = [
    "parity_box", "parity_box_flat", "parity_cylinder",
    "parity_cylinder_thin", "parity_capsule", "parity_ellipsoid_mesh",
    "parity_cone_mesh", "parity_torus_mesh",
]


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None,
                   help="the dataset's directory (default: a new directory"
                   " under the system's temporary directory, printed)")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.005)
    p.add_argument("--num-points", type=int, default=750)
    p.add_argument("--grasps-per-class", type=int, default=24)
    p.add_argument("--max-rounds", type=int, default=30)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--seed", type=int, default=0, help="dataset seed")
    p.add_argument("--num-classes", type=int, choices=(2, 3), default=2,
                   help="2 = main_1v semantics (thresh .6/.6);"
                   " 3 = main_1v_mc (thresh .5/1.2)")
    p.add_argument("--objects", nargs="*", default=None,
                   help="object names (default: OBJECTS_2CLASS for 2-class,"
                   " all PARITY_OBJECTS for 3-class)")
    p.add_argument("--skip-build", action="store_true",
                   help="reuse an existing dataset at --root")
    p.add_argument("--skip-reference", action="store_true")
    p.add_argument("--skip-ours", action="store_true")
    p.add_argument("--out-json",
                   default="docs/training_parity_curves_torch.json")
    p.add_argument("--out-md", default="docs/TRAINING_PARITY_TORCH.md")
    p.add_argument("--ref-procs", type=int, default=3,
                   help="reference seeds run as parallel CPU processes")
    p.add_argument("--sdf-dim", type=int, default=None)
    p.add_argument("--sdf-res", type=float, default=None)
    p.add_argument("--views-per-object", type=int, default=None)
    p.add_argument("--points-per-view", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="device of the dataset build and of the port's"
                   " trainer")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..pipelines import parity

    if args.num_classes == 2:
        thresh_good, thresh_bad = 0.6, 0.6   # main_1v.py
        objects = args.objects or OBJECTS_2CLASS
    else:
        thresh_good, thresh_bad = 0.5, 1.2   # main_1v_mc.py
        objects = args.objects

    if args.root is None:
        if args.skip_build:
            raise SystemExit("--skip-build needs the dataset's --root")
        args.root = tempfile.mkdtemp(prefix="parity_data_")
        print(f"dataset: {args.root}", flush=True)
    meta_path = os.path.join(args.root, "parity_meta.json")
    if args.skip_build and os.path.exists(meta_path):
        meta = json.load(open(meta_path))
    else:
        sizes = {k: v for k, v in (
            ("sdf_dim", args.sdf_dim), ("sdf_res", args.sdf_res),
            ("views_per_object", args.views_per_object),
            ("points_per_view", args.points_per_view)) if v is not None}
        t0 = time.time()
        meta = parity.build_parity_dataset(
            args.root, grasps_per_class=args.grasps_per_class,
            max_rounds=args.max_rounds, seed=args.seed,
            objects=objects, device=args.device, **sizes)
        meta["build_seconds"] = round(time.time() - t0, 1)
        meta["views_per_object"] = sizes.get("views_per_object", 6)
        json.dump(meta, open(meta_path, "w"))
    meta["num_classes"] = args.num_classes
    meta["thresh_good"], meta["thresh_bad"] = thresh_good, thresh_bad
    meta["test_prior"] = _test_prior(args.root, meta, args.num_classes,
                                     thresh_good, thresh_bad)
    meta["device"] = card_label(args.device)
    print("dataset:", meta, flush=True)

    # resume: merge into an existing curves file, but only one in the
    # multi-seed format (seed-tagged lists) for the same dataset
    curves = {}
    if os.path.exists(args.out_json):
        try:
            curves = json.load(open(args.out_json))
        except Exception:
            curves = {}
        same_data = curves.get("meta", {}).get("objects") == meta["objects"]
        if not (same_data
                and isinstance(curves.get("ours", []), list)
                and isinstance(curves.get("reference", []), list)):
            curves = {}
    curves.update({"meta": meta, "epochs": args.epochs,
                   "batch_size": args.batch_size, "lr": args.lr,
                   "num_points": args.num_points, "n_seeds": args.seeds})
    curves.setdefault("ours", [])
    curves.setdefault("reference", [])

    seeds = list(range(args.seeds))

    if not args.skip_ours:
        done = {h.get("seed") for h in curves["ours"]}
        for s in seeds:
            if s in done:
                continue
            t0 = time.time()
            hist = parity.train_ours(
                args.root, epochs=args.epochs, batch_size=args.batch_size,
                lr=args.lr, num_points=args.num_points,
                cloud_points=meta["points_per_view"], seed=s,
                num_classes=args.num_classes, thresh_good=thresh_good,
                thresh_bad=thresh_bad, device=args.device)
            hist["seconds"] = round(time.time() - t0, 1)
            hist["seed"] = s
            curves["ours"].append(hist)
            json.dump(curves, open(args.out_json, "w"), indent=1)
            print(f"ours[seed={s}]: final {hist['test_acc'][-1]:.3f} "
                  f"({hist['seconds']}s)", flush=True)

    if not args.skip_reference:
        done = {h.get("seed") for h in curves["reference"]}
        todo = [s for s in seeds if s not in done]
        payloads = [(args.root, args.epochs, args.batch_size, args.lr,
                     args.num_points, meta["n_train"], meta["n_test"], s,
                     max(1, (os.cpu_count() or 8) // max(args.ref_procs, 1)),
                     args.num_classes, thresh_good, thresh_bad)
                    for s in todo]
        if payloads:
            with mp.get_context("spawn").Pool(
                    min(args.ref_procs, len(payloads))) as pool:
                for hist in pool.imap_unordered(_run_reference_seed,
                                                payloads):
                    curves["reference"].append(hist)
                    json.dump(curves, open(args.out_json, "w"), indent=1)
                    print(f"reference[seed={hist['seed']}]: final "
                          f"{hist['test_acc'][-1]:.3f} "
                          f"({hist['seconds']}s)", flush=True)

    write_report(curves, args.out_md, args.out_json)
    return 0


def _test_prior(root, meta, num_classes, thresh_good, thresh_bad):
    """Majority-class prior of the test split under the run's thresholds:
    the number both trainers must beat to show learning."""
    import glob

    from ..training.data import labels_from_scores

    hist = np.zeros(num_classes, np.int64)
    for pth in sorted(glob.glob(os.path.join(
            root, "PointNetGPD/data/ycb_grasp/test/*.npy"))):
        rows = np.load(pth)
        if not len(rows):
            continue
        lab, w = labels_from_scores(rows[:, -2], rows[:, -1], thresh_good,
                                    thresh_bad, num_classes)
        hist += np.bincount(np.asarray(lab)[np.asarray(w) > 0],
                            minlength=num_classes)[:num_classes]
    return round(float(hist.max() / max(hist.sum(), 1)), 4)


def _final_quarter(hist, epochs):
    tail = max(1, epochs // 4)
    return float(np.mean(hist["test_acc"][-tail:]))


def write_report(curves, out_md, out_json):
    meta = curves["meta"]
    epochs = curves["epochs"]
    ours = sorted(curves["ours"], key=lambda h: h["seed"])
    ref = sorted(curves["reference"], key=lambda h: h["seed"])
    fo = [_final_quarter(h, epochs) for h in ours]
    fr = [_final_quarter(h, epochs) for h in ref]

    k = meta.get("num_classes", 3)
    ref_main = "main_1v.py" if k == 2 else "main_1v_mc.py"
    thresh = (f"thresh {meta.get('thresh_good', 0.5)}/"
              f"{meta.get('thresh_bad', 1.2)}")
    version = "v3" if k == 2 else "v2"
    card = meta.get("device", "the card")
    lines = [
        f"# Training-accuracy parity vs the reference trainer ({version},"
        " PyTorch/CUDA port)",
        "",
        "Both trainers ran on the identical dataset files (generated by the",
        "port's labeling path, written in the reference's",
        "$PointNetGPD_FOLDER layout), same epochs/batch/lr, both with the",
        "reference's per-epoch optimizer-reset quirk, several seeds each.",
        "Reference = the reference's own dataset + model code (imported, not",
        f"copied) under a {ref_main}-semantics loop on torch CPU; ours =",
        f"OneViewBatcher + the fused crop train step on {card}. Eval = full",
        "test split each epoch. See pointnetgpd_tpu_torch/pipelines/parity.py;",
        f"reference: PointNetGPD/{ref_main} + model/dataset.py.",
        "",
        f"- dataset: {len(meta['objects'])} objects"
        f" ({', '.join(meta['objects'])})",
        f"- rows: {meta['n_train']} train / {meta['n_test']} test PER OBJECT"
        f" -> {meta['n_train'] * len(meta['objects'])} train /"
        f" {meta['n_test'] * len(meta['objects'])} test total,"
        f" {meta.get('views_per_object', 6)} views/object",
        f"- config: {epochs} epochs, batch {curves['batch_size']},"
        f" lr {curves['lr']}, {curves['num_points']} points, {k}-class"
        f" ({thresh})",
        f"- seeds: {len(ours)} (ours), {len(ref)} (reference)",
    ]
    prior = meta.get("test_prior")
    if prior is not None:
        lines.append(f"- majority-class prior of the test split:"
                     f" **{prior:.3f}** — the bar both trainers must beat")
    lines += [
        "",
        "## Final-quarter mean test accuracy (per seed)",
        "",
        "| seed | reference | ours |",
        "|---|---|---|",
    ]
    for i in range(max(len(ours), len(ref))):
        r = f"{fr[i]:.3f}" if i < len(fr) else "-"
        o = f"{fo[i]:.3f}" if i < len(fo) else "-"
        lines.append(f"| {i} | {r} | {o} |")
    if fr and fo:
        mr, sr = float(np.mean(fr)), float(np.std(fr))
        mo, so = float(np.mean(fo)), float(np.std(fo))
        lines += [
            "",
            f"**Reference: {mr:.3f} ± {sr:.3f}; ours: {mo:.3f} ± {so:.3f}"
            f" (|mean diff| = {abs(mr - mo):.3f}).**",
        ]
        if prior is not None:
            verdict = ("BOTH trainers beat the prior"
                       if min(mr, mo) > prior else
                       "at least one trainer does NOT beat the prior")
            lines.append(
                f"Against the {prior:.3f} prior: reference {mr - prior:+.3f},"
                f" ours {mo - prior:+.3f} — {verdict}.")
    if ref:
        lines += ["", "## Reference loss spikes are seed noise",
                  "",
                  "| seed | max epoch loss | final-quarter max loss |",
                  "|---|---|---|"]
        for h in ref:
            tail = max(1, epochs // 4)
            lines.append(
                f"| {h['seed']} | {max(h['train_loss']):.3f} |"
                f" {max(h['train_loss'][-tail:]):.3f} |")
    lines += [
        "",
        "## Mean test-accuracy curve (across seeds)",
        "",
        "| epoch | reference | ours |",
        "|---|---|---|",
    ]
    for e in range(epochs):
        r = (f"{np.mean([h['test_acc'][e] for h in ref]):.3f}"
             if ref else "-")
        o = (f"{np.mean([h['test_acc'][e] for h in ours]):.3f}"
             if ours else "-")
        lines.append(f"| {e} | {r} | {o} |")
    secs_r = sum(h.get("seconds", 0) for h in ref)
    secs_o = sum(h.get("seconds", 0) for h in ours)
    lines += [
        "",
        f"Wall time: reference {secs_r / 60:.1f} min total (torch CPU,"
        f" seeds in parallel), ours {secs_o / 60:.1f} min total ({card}).",
        f"Raw curves: `{os.path.basename(out_json)}`.",
    ]
    os.makedirs(os.path.dirname(out_md) or ".", exist_ok=True)
    with open(out_md, "w") as f:
        f.write("\n".join(lines) + "\n")
    if fr and fo:
        print(f"final acc: ref={np.mean(fr):.3f}±{np.std(fr):.3f} "
              f"ours={np.mean(fo):.3f}±{np.std(fo):.3f}")


if __name__ == "__main__":
    sys.exit(main())
