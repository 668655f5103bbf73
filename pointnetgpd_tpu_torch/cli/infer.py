"""Inference CLI: the reference's main_test.py.

Port of ``pointnetgpd_tpu/cli/infer.py`` (reference PointNetGPD/main_test.py):
load a checkpoint by ``--model_type`` or path, resample the local
gripper-frame cloud ``--repeat`` times, score every resample in one batched
forward (``GraspScorer.score_clouds``, K2 on the card) and majority-vote.

A checkpoint is a reference file (``.model``/``.pt``/``.pth``, a pickled
module or a state_dict), an ``.npz`` of a state_dict, or a checkpoint
directory of the port's trainer (``cli/train.py --model-path``), which
resolves to its newest ``step_N``.

Usage:
  python -m pointnetgpd_tpu_torch.cli.infer --model_type 3class --input cloud.npy
  python -m pointnetgpd_tpu_torch.cli.infer --load-model ckpt_dir --k 2 --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# --model_type shortcuts (main_test.py:34-41)
MODEL_TYPES = {
    "100": ("../data/pointgpd_chann3_local.model", 3),
    "50": ("../data/pointgpd_50_points.model", 3),
    "3class": ("../data/pointnetgpd_3class.model", 3),
}


def build_parser():
    p = argparse.ArgumentParser(description="pointnetgpd_tpu_torch inference")
    p.add_argument("--load-model", type=str,
                   default="../data/pointnetgpd_3class.model")
    p.add_argument("--model_type", type=str, default=None)
    p.add_argument("--k", type=int, default=3,
                   help="classes (checked against a checkpoint directory)")
    p.add_argument("--input", type=str, default="",
                   help=".npy (N, 3) local gripper-frame cloud; random demo "
                        "cloud when omitted (main_test.py:81)")
    p.add_argument("--num-point", type=int, default=500)
    p.add_argument("--repeat", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ref-path", type=str, default="",
                   help="path containing the reference model package for "
                        "unpickling whole-module checkpoints")
    p.add_argument("--exact", action="store_true",
                   help="accepted for the JAX CLI's sake and does nothing: "
                        "the port never turns TF32 on, so its matmuls are "
                        "always float32 (K2 computes in 3xTF32, float32 "
                        "accurate)")
    p.add_argument("--device", type=str, default="cuda")
    return p


def load_scorer(args):
    from ..inference.scorer import GraspScorer
    from ..models.convert import MODEL_FILE
    from ..training.checkpoint import latest_checkpoint

    path = args.load_model
    if args.model_type in MODEL_TYPES:
        path, _ = MODEL_TYPES[args.model_type]
    kw = dict(num_points=args.num_point, repeat=args.repeat,
              device=args.device)
    if os.path.isdir(path):
        # the train CLI's --model-path directory: its newest step_N
        if not os.path.exists(os.path.join(path, MODEL_FILE)):
            resolved = latest_checkpoint(path)
            if resolved is not None:
                print(f"resolved {path} -> {resolved}")
                path = resolved
        kw["k"] = args.k
    ref_paths = [args.ref_path] if args.ref_path else []
    return GraspScorer.from_checkpoint(path, ref_paths=ref_paths, **kw)


def main(argv=None, draws=None):
    """``draws``: a ``draws.Draws``-like source of the resample indices
    (default ``Draws(--seed)``)."""
    args = build_parser().parse_args(argv)
    scorer = load_scorer(args)

    if args.input:
        local_pc = np.load(args.input)[:, :3].astype(np.float32)
    else:
        local_pc = np.random.random([500, 3]).astype(np.float32)  # demo

    pred, prob, votes = scorer.score_clouds(local_pc[None], seed=args.seed,
                                            draws=draws)
    print("voting:", votes[0].tolist())
    print("Test result:", int(pred[0]))
    print("class probabilities:", np.round(prob[0], 4).tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
