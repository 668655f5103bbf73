"""Ground-truth robustness checks on an existing integrated-workflow tree.

Port of ``examples/gt_robustness.py``: re-run the detect stage of
``integrated_workflow`` (a) with another GPG sampler seed on the same scene
and (b) on another 3-object scene (the next-largest objects), against the
same trained checkpoint. Does the classifier's top-k-beats-pool
ground-truth result survive a fresh candidate pool and a fresh scene?
(Reference context: kinect2grasp.py publishes whatever the model approves
per frame; it has no ground-truth check at all.)

Usage: python -m pointnetgpd_tpu_torch.examples.gt_robustness --root ROOT
           [--seed 7] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

from .integrated_workflow import detect_stage


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True,
                   help="an integrated_workflow tree")
    p.add_argument("--seed", type=int, default=7,
                   help="GPG sampler seed for the same-scene re-run")
    p.add_argument("--num-seeds", type=int, default=400)
    p.add_argument("--num-point", type=int, default=750)
    p.add_argument("--cloud-pad-to", type=int, default=8192,
                   help="the detect stage's size bucket (the JAX driver's"
                   " 8192)")
    p.add_argument("--skip-same-scene", action="store_true")
    p.add_argument("--skip-new-scene", action="store_true")
    p.add_argument("--out", default=None,
                   help="write results JSON here (default"
                   " <root>/gt_robustness.json)")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None, draws_for=None):
    """``draws_for(preset, seed)``: the detect stage's draws (default: the
    detector's own). Returns the results dict."""
    args = build_parser().parse_args(argv)
    root = os.path.abspath(args.root)
    ckpt = os.path.join(root, "learned_models")
    base = os.path.join(root, "PointNetGPD/data/ycb-tools/models/ycb")
    names = sorted(os.listdir(base))
    kw = dict(num_classes=2, num_seeds=args.num_seeds,
              num_point=args.num_point, device=args.device,
              draws_for=draws_for, cloud_pad_to=args.cloud_pad_to)

    out = {}
    if not args.skip_same_scene:
        det = detect_stage(root, ckpt, names, seed=args.seed, **kw)
        out["same_scene_new_sampler_seed"] = {"seed": args.seed, **det}
        print("same-scene seed", args.seed, "->",
              json.dumps(det["production"]["ground_truth"]), flush=True)

    if not args.skip_new_scene:
        # drop the original picks so detect_stage's 3-largest rule lands on
        # the next trio: a different scene, the same trained model
        prev = out.get("same_scene_new_sampler_seed", {}).get("scene_objects")
        if prev is None:
            det0 = json.load(open(os.path.join(root, "det.json")))
            prev = det0["scene_objects"]
        rest = [n for n in names if n not in set(prev)]
        det2 = detect_stage(root, ckpt, rest, seed=0, **kw)
        out["new_scene"] = det2
        print("new scene", det2["scene_objects"], "->",
              json.dumps(det2["production"]["ground_truth"]), flush=True)

    dst = args.out or os.path.join(root, "gt_robustness.json")
    json.dump(out, open(dst, "w"), indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
