"""Training CLI: one entry point for the reference's six training scripts,
and for the PointNet++ classifier on the same data.

Port of ``pointnetgpd_tpu/cli/train.py``: main_1v.py / main_1v_mc.py /
main_fullv.py / main_fullv_mc.py / main_1v_gpd.py / main_fullv_gpd.py
(reference PointNetGPD/main_*.py, README.md:183-191) behind a --variant
switch; flags mirror the reference's argparse set (main_1v.py:18-31), plus
``--device`` (default ``cuda``) and ``--n-devices`` (JAX ``:78``, ``:104``;
default 1): with N > 1 the command starts N ranks with
``torch.multiprocessing`` (NCCL on the card, rank r on card r; gloo for
``--device cpu``), each holding its rows of every global batch; under
``torchrun`` it joins the group that torchrun describes instead.

Variant configs (reference deltas):
  1v        OneView 2-class, 750 pts, thresh .6/.6, k=2
  1v_mc     OneView 3-class, 750 pts, thresh_good .5 / thresh_bad 1.2, k=3
  fullv     Full cloud 2-class, 1000 pts, 50k obj points, 20 view files
  fullv_mc  Full cloud 3-class
  1v_gpd    GPD projection CNN, 3 channels, lr 1e-3
  fullv_gpd GPD projection CNN, 12 channels
  1v_pn2    PointNet++ SSG classifier (arXiv:1706.02413) on the 1v crops,
            1024 pts, lr 1e-3 (pointnet2/train.py)

Usage:
  python -m pointnetgpd_tpu_torch.cli.train --variant 1v --mode train --synthetic
  python -m pointnetgpd_tpu_torch.cli.train ... --n-devices 4
  torchrun --nproc-per-node 4 -m pointnetgpd_tpu_torch.cli.train ... \
      --n-devices 4
  (data root from $PointNetGPD_FOLDER, reference layout; --synthetic for a
  generated stand-in dataset when the YCB assets are absent)
"""

from __future__ import annotations

import argparse
import os
import sys

VARIANTS = {
    "1v": dict(num_classes=2, grasp_points_num=750, thresh_good=0.6,
               thresh_bad=0.6, one_view=True, lr=0.005, gpd=False),
    "1v_mc": dict(num_classes=3, grasp_points_num=750, thresh_good=0.5,
                  thresh_bad=1.2, one_view=True, lr=0.005, gpd=False),
    "fullv": dict(num_classes=2, grasp_points_num=1000, thresh_good=0.6,
                  thresh_bad=0.6, one_view=False, lr=0.005, gpd=False,
                  views_per_sample=20, cloud_points=50000),
    "fullv_mc": dict(num_classes=3, grasp_points_num=1000, thresh_good=0.5,
                     thresh_bad=1.2, one_view=False, lr=0.005, gpd=False,
                     views_per_sample=20, cloud_points=50000),
    "1v_gpd": dict(num_classes=2, grasp_points_num=750, thresh_good=0.6,
                   thresh_bad=0.6, one_view=True, lr=1e-3, gpd=True,
                   project_chann=3),
    "fullv_gpd": dict(num_classes=2, grasp_points_num=1000, thresh_good=0.6,
                      thresh_bad=0.6, one_view=False, lr=1e-3, gpd=True,
                      project_chann=12, views_per_sample=20,
                      cloud_points=50000),
    "1v_pn2": dict(num_classes=2, grasp_points_num=1024, thresh_good=0.6,
                   thresh_bad=0.6, one_view=True, lr=1e-3, gpd=False,
                   model="pointnet2_ssg"),
}


def build_parser():
    p = argparse.ArgumentParser(description="pointnetgpd_tpu_torch trainer")
    p.add_argument("--variant", choices=sorted(VARIANTS), default="1v")
    p.add_argument("--tag", type=str, default="default")
    p.add_argument("--epoch", type=int, default=200)
    p.add_argument("--mode", choices=["train", "test"], required=True)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=None,
                   help="default: variant's reference lr")
    p.add_argument("--load-model", type=str, default="")
    p.add_argument("--load-epoch", type=int, default=-1)
    p.add_argument("--model-path", type=str, default="./assets/learned_models")
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--save-interval", type=int, default=1)
    p.add_argument("--log-dir", type=str, default="./assets/log")
    p.add_argument("--steps-per-epoch", type=int, default=100)
    p.add_argument("--eval-steps", type=int, default=10)
    p.add_argument("--data-root", type=str,
                   default=os.environ.get("PointNetGPD_FOLDER", ""))
    p.add_argument("--synthetic", action="store_true",
                   help="use generated data (no YCB assets needed)")
    p.add_argument("--cloud-points", type=int, default=None,
                   help="scene-cloud size per sample (default: the"
                   " variant's, else 20000)")
    p.add_argument("--views-per-sample", type=int, default=None,
                   help="override the variant's view-merge count (the"
                   " fullv datasets' pc_file_used_num, dataset.py:244-254)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default: the card)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-devices", type=int, default=1,
                   help="data-parallel ranks (one process each)")
    return p


def _rank_main(rank, world, argv):
    """One spawned rank: the process group is up."""
    run(build_parser().parse_args(argv))


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.n_devices > 1:
        from ..parallel import dist as pdist
        from ..parallel.mesh import initialize_distributed

        if pdist.environment_rank() is not None:       # under torchrun
            world = initialize_distributed(device=args.device)
            if world != args.n_devices:
                raise SystemExit(f"--n-devices {args.n_devices} but the "
                                 f"environment's world size is {world}")
            return run(args)
        backend = "nccl" if args.device.startswith("cuda") else "gloo"
        pdist.spawn(_rank_main, args.n_devices, backend,
                    args=(sys.argv[1:] if argv is None else list(argv),),
                    timeout=float("inf"))
        return 0
    return run(args)


def run(args):
    var = VARIANTS[args.variant]

    from ..training.data import (GraspDataIndex, OneViewBatcher,
                                 SyntheticGraspData)
    from ..training.loop import TrainConfig, Trainer

    cfg = TrainConfig(
        num_classes=var["num_classes"],
        grasp_points_num=var["grasp_points_num"],
        batch_size=args.batch_size,
        lr=args.lr if args.lr is not None else var["lr"],
        epochs=args.epoch,
        steps_per_epoch=args.steps_per_epoch,
        eval_steps=args.eval_steps,
        save_interval=args.save_interval,
        log_interval=args.log_interval,
        tag=args.tag,
        model_path=args.model_path,
        log_dir=args.log_dir,
        seed=args.seed,
        device=args.device,
        n_devices=args.n_devices,
        gpd=var["gpd"],
        project_chann=var.get("project_chann", 3),
        model=var.get("model", "pointnet"),
    )

    def make_data(tag, seed):
        if args.synthetic or not args.data_root:
            return SyntheticGraspData(
                batch_size=cfg.batch_size,
                cloud_points=args.cloud_points or 20000,
                num_classes=cfg.num_classes, seed=seed,
                thresh_good=var["thresh_good"], thresh_bad=var["thresh_bad"])
        index = GraspDataIndex(args.data_root, tag=tag,
                               one_view=var["one_view"])
        views = (args.views_per_sample if args.views_per_sample is not None
                 else var.get("views_per_sample", 1))
        cloud_points = (args.cloud_points if args.cloud_points is not None
                        else var.get("cloud_points", 20000))
        return OneViewBatcher(
            index, cfg.batch_size, cloud_points=cloud_points,
            num_classes=cfg.num_classes, thresh_good=var["thresh_good"],
            thresh_bad=var["thresh_bad"], seed=seed, views_per_sample=views)

    trainer = Trainer(cfg, make_data("train", args.seed),
                      make_data("test", args.seed + 1))
    try:
        resumed = trainer.maybe_resume() if (
            args.load_model or args.load_epoch != -1) else None
        if resumed:
            print(f"resumed from {resumed}")
        if args.mode == "train":
            trainer.fit()
        else:
            if not resumed:
                trainer.maybe_resume()
            acc, loss = trainer.evaluate()
            if trainer.rank == 0:
                print(f"Test done, acc={acc}, loss={loss}")
    finally:
        trainer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
