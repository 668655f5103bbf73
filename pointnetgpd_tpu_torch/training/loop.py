"""The training loop: epochs, eval, logging, checkpoints.

Port of ``pointnetgpd_tpu/training/loop.py`` (reference
PointNetGPD/main_1v.py:59-183): per-epoch train + eval with
train_loss/train_acc/test_acc/test_loss scalars (tensorboardX when
installed, always a metrics.jsonl), periodic checkpoints, resume. It runs on
``TrainConfig.device`` (the card unless the caller asks for the CPU).
Random draws come from one ``draws.Draws`` on that device, seeded from the
config.

Data parallel (``TrainConfig.n_devices`` > 1, JAX ``loop.py:93-153``): one
process per rank in an initialized ``torch.distributed`` group of that size
(``cli/train.py`` starts them). Every rank reads the same seeded global
batch and keeps its rows, so the batch must divide by the world size; every
rank builds the same model and the same ``Draws`` and takes its rows of the
whole batch's draws (``parallel.dist.group_draws``: the crop's shuffle is
one permutation for the global batch). The steps take their statistics,
loss and metrics over the group and sum the gradients before Adam
(``training/train.py``); the eval pass runs K2 on each rank's rows and sums
over the group. Only rank 0 writes checkpoints and logs; ``maybe_resume``
loads on every rank. On an unnamed ``"cuda"`` device rank r takes card
r (modulo the cards present).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..draws import Draws
from ..parallel import dist as pdist
from ..models.gpd import GPDClassifier
from ..models.pointnet import PointNetCls
from ..models.pointnet2 import PointNet2ClsSSG
from ..ops.crop import collect_grasp_clouds_batched
from . import checkpoint as ckpt_lib
from .train import (init_train_state, make_eval_step, make_fused_train_step,
                    make_gpd_eval_step, make_gpd_train_step, make_optimizer)


class MetricsLogger:
    """tensorboardX scalars (where installed) + append-only metrics.jsonl."""

    def __init__(self, log_dir: str, tag: str):
        self.dir = os.path.join(log_dir, tag)
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(self.dir)

    def scalar(self, name: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(name, value, step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"name": name, "value": float(value), "step": int(step),
                 "t": time.time()}) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


@dataclass
class TrainConfig:
    """Canonical configs mirror the reference entry points (README.md:183-191):
    main_1v -> k=2, 750 pts; main_1v_mc -> k=3; main_fullv -> 1000 pts, ..."""

    num_classes: int = 2
    grasp_points_num: int = 750
    input_chann: int = 3
    batch_size: int = 128
    lr: float = 0.005
    lr_step: int = 30
    lr_gamma: float = 0.5
    epochs: int = 200
    steps_per_epoch: int = 100
    eval_steps: int = 10
    min_point_limit: int = 50
    save_interval: int = 1          # epochs between checkpoints (main_1v.py:31)
    log_interval: int = 10          # steps between scalar logs (main_1v.py:30)
    gpd: bool = False                # GPD projection-CNN baseline variant
    model: str = "pointnet"          # the point-cloud classifier: "pointnet"
    #                                  (PointNetCls) or "pointnet2_ssg"
    #                                  (PointNet2ClsSSG); not read with gpd
    project_chann: int = 3           # GPD input channels (3 or 12)
    tag: str = "default"
    model_path: str = "./assets/learned_models"
    log_dir: str = "./assets/log"
    seed: int = 0
    device: str = "cuda"
    n_devices: int = 1              # ranks of the process group


class _NullLogger:
    """The logger of ranks other than 0."""

    def scalar(self, name, value, step):
        pass

    def close(self):
        pass


class Trainer:
    def __init__(self, cfg: TrainConfig, train_data, eval_data=None):
        self.cfg = cfg
        self.train_data = train_data
        self.eval_data = eval_data
        self.group, self.rank, self.world = None, 0, 1
        if cfg.n_devices > 1:
            import torch.distributed as dist

            if not dist.is_initialized() or \
                    dist.get_world_size() != cfg.n_devices:
                raise RuntimeError(
                    f"n_devices={cfg.n_devices} needs an initialized process "
                    "group of that size (cli/train.py --n-devices starts one)")
            self.group = dist.group.WORLD
            self.rank, self.world = dist.get_rank(), cfg.n_devices
        if cfg.batch_size % self.world:
            raise ValueError(f"batch {cfg.batch_size} does not divide over "
                             f"{self.world} ranks")
        dev = torch.device(cfg.device)
        if dev.type == "cuda" and dev.index is None and self.world > 1:
            dev = torch.device("cuda", self.rank % torch.cuda.device_count())
        self.device = dev
        self.logger = (MetricsLogger(cfg.log_dir, cfg.tag) if self.rank == 0
                       else _NullLogger())
        self.tx = make_optimizer(cfg.lr, cfg.lr_step, cfg.lr_gamma,
                                 steps_per_epoch=cfg.steps_per_epoch)
        kw = dict(num_points=cfg.grasp_points_num,
                  min_point_limit=cfg.min_point_limit)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)      # the modules' initializers
            model = self._model(cfg)
        if cfg.gpd:
            self.train_step = make_gpd_train_step(
                project_chann=cfg.project_chann, group=self.group, **kw)
            self.eval_step = make_gpd_eval_step(
                project_chann=cfg.project_chann, group=self.group, **kw)
        else:
            self.train_step = make_fused_train_step(group=self.group, **kw)
            self.eval_step = make_eval_step(self.group)
        self.state = init_train_state(model.to(self.device), self.tx)
        self.draws = self._draws(Draws(cfg.seed + 1, self.device))
        self._epoch0 = 0

    @staticmethod
    def _model(cfg: TrainConfig):
        if cfg.gpd:
            return GPDClassifier(cfg.project_chann)
        if cfg.model == "pointnet2_ssg":
            return PointNet2ClsSSG(k=cfg.num_classes)
        if cfg.model != "pointnet":
            raise ValueError(f"unknown model {cfg.model!r}: pointnet or "
                             f"pointnet2_ssg")
        return PointNetCls(num_points=cfg.grasp_points_num,
                           input_chann=cfg.input_chann, k=cfg.num_classes)

    def _draws(self, base):
        """This rank's rows of ``base``'s draws for the global batch."""
        if self.group is None:
            return base
        return pdist.group_draws(base, self.group, self.device)

    def _rows(self, a):
        """This rank's rows of a global-batch array."""
        b = a.shape[0] // self.world
        return a[self.rank * b:(self.rank + 1) * b]

    # ------------------------------------------------------------------
    def maybe_resume(self):
        path = ckpt_lib.latest_checkpoint(self.cfg.model_path)
        if path:
            self.state = ckpt_lib.restore_checkpoint(path, self.state)
            self._epoch0 = self.state.step // self.cfg.steps_per_epoch
        return path

    def _to_device(self, batch):
        grasps, clouds, transforms, labels, weights = (
            torch.as_tensor(self._rows(np.asarray(a))).to(
                self.device, non_blocking=True)
            for a in batch)
        return grasps, clouds, transforms, labels.long(), weights.float()

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int):
        cfg = self.cfg
        it = iter(self.train_data)
        acc_sum = loss_sum = 0.0
        for step in range(cfg.steps_per_epoch):
            batch = self._to_device(next(it))
            self.state, metrics = self.train_step(self.state, *batch,
                                                  self.draws)
            if step % cfg.log_interval == 0 and self.rank == 0:
                loss = float(metrics["loss"])
                self.logger.scalar("train_loss", loss,
                                   epoch * cfg.steps_per_epoch + step)
                print(f"Train Epoch: {epoch} [{step}/{cfg.steps_per_epoch}]"
                      f"\tLoss: {loss:.6f}", flush=True)
            acc_sum = acc_sum + metrics["acc"]
            loss_sum = loss_sum + metrics["loss"]
        return (float(acc_sum) / cfg.steps_per_epoch,
                float(loss_sum) / cfg.steps_per_epoch)

    def evaluate(self, draws=None):
        """Mean accuracy and loss over ``eval_steps`` batches, each cropped
        on the device and scored in eval mode (K2 on the card), over the
        group's whole batch. ``draws``: a source for the global batch."""
        if self.eval_data is None:
            return None, None
        cfg = self.cfg
        draws = self.draws if draws is None else self._draws(draws)
        it = iter(self.eval_data)
        tot = {"loss_sum": 0.0, "correct": 0.0, "count": 0.0}
        for _ in range(cfg.eval_steps):
            grasps, clouds, transforms, labels, weights = self._to_device(
                next(it))
            if cfg.gpd:
                out = self.eval_step(self.state.model, grasps, clouds,
                                     transforms, labels, weights, draws)
            else:
                cropped, _, crop_valid = collect_grasp_clouds_batched(
                    grasps, clouds, transforms, draws,
                    num_out=cfg.grasp_points_num,
                    min_point_limit=cfg.min_point_limit)
                w = weights * crop_valid.float()
                out = self.eval_step(self.state.model, cropped, labels, w)
            for k_ in tot:
                tot[k_] = tot[k_] + out[k_]
        count = max(float(tot["count"]), 1.0)
        return float(tot["correct"]) / count, float(tot["loss_sum"]) / count

    # ------------------------------------------------------------------
    def fit(self):
        cfg = self.cfg
        for epoch in range(self._epoch0, cfg.epochs):
            train_acc, train_loss = self.train_epoch(epoch)
            self.logger.scalar("train_acc", train_acc, epoch)
            eval_acc, eval_loss = self.evaluate()
            if self.rank != 0:
                continue
            if eval_acc is not None:
                self.logger.scalar("test_acc", eval_acc, epoch)
                self.logger.scalar("test_loss", eval_loss, epoch)
                print(f"Epoch {epoch}: train_acc={train_acc:.4f} "
                      f"test_acc={eval_acc:.4f} test_loss={eval_loss:.4f}",
                      flush=True)
            else:
                print(f"Epoch {epoch}: train_acc={train_acc:.4f} "
                      f"train_loss={train_loss:.4f}", flush=True)
            if epoch % cfg.save_interval == 0:
                ckpt_lib.save_checkpoint(cfg.model_path, self.state)
        return self.state

    def close(self):
        self.logger.close()
