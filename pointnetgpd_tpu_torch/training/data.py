"""Host-side data pipeline: YCB grasp files -> fixed-shape batches.

The port's own copy of ``pointnetgpd_tpu/training/data.py`` (numpy only).
Replaces the reference's 32-process torch DataLoader
(reference: PointNetGPD/main_1v.py:115-146 + model/dataset.py:201-549) with a
thin host pipeline: the host only loads .npy files, picks views, and builds
fixed-shape batches; the closing-region crop runs on the device in the train
step (``ops/crop.py``). Samples the reference would drop (None from
__getitem__, filtered by my_collate, main_1v.py:48-50) are kept at fixed
shape with a zero loss-weight instead.

Directory layout mirrors the reference ($PointNetGPD_FOLDER, dataset.py:12,226-227):
  {root}/PointNetGPD/data/ycb_grasp/{tag}/*.npy          grasp label files
  {root}/data/ycb-tools/models/ycb/*/rgbd/clouds/*.npy   per-view clouds
  {root}/PointNetGPD/data/google2cloud.pkl               per-object 4x4 transforms

Grasp row format (generate-dataset-canny.py:48-54): 10-dim configuration +
score_friction (level) + score_canny (refine); label thresholds follow
dataset.py:271-277 / :358-364.
"""

from __future__ import annotations

import glob
import os
import pickle
import queue
import threading
from dataclasses import dataclass

import numpy as np


def labels_from_scores(level_score, refine_score, thresh_good, thresh_bad,
                       num_classes: int):
    """score = level + 0.01*refine; returns (label, weight).

    2-class (dataset.py:271-277): >=thresh_bad -> 0, <=thresh_good -> 1,
    else dropped (weight 0). 3-class (dataset.py:358-364): >=bad -> 0,
    <=good -> 2, else 1.
    """
    score = level_score + refine_score * 0.01
    if num_classes == 2:
        label = np.where(score >= thresh_bad, 0, 1)
        weight = ((score >= thresh_bad) | (score <= thresh_good)).astype(np.float32)
    else:
        label = np.where(score >= thresh_bad, 0, np.where(score <= thresh_good, 2, 1))
        weight = np.ones_like(score, dtype=np.float32)
    return label.astype(np.int32), weight


@dataclass
class GraspDataIndex:
    """Index of grasp files / view clouds / transforms for one split tag."""

    root: str
    tag: str = "train"
    one_view: bool = True

    def __post_init__(self):
        pattern = (
            "pc_NP3_NP5*.npy" if self.one_view else "*.npy"
        )  # one-view: fixed reference camera NP5 (dataset.py:400)
        fl_grasp = sorted(
            glob.glob(f"{self.root}/PointNetGPD/data/ycb_grasp/{self.tag}/*.npy")
        )
        fl_pc = sorted(
            glob.glob(f"{self.root}/data/ycb-tools/models/ycb/*/rgbd/clouds/{pattern}")
        )
        with open(f"{self.root}/PointNetGPD/data/google2cloud.pkl", "rb") as f:
            self.transform = pickle.load(f)

        self.cloud_files: dict[str, list] = {}
        for p in fl_pc:
            obj = p.split("/")[-4]
            self.cloud_files.setdefault(obj, []).append(p)
        self.grasp_files = {
            os.path.basename(p).split(".")[0]: p for p in fl_grasp
        }
        objects = set(self.grasp_files) & set(self.transform)
        # only keep objects whose paired cloud object also has views
        self.objects = sorted(
            o for o in objects if self.transform[o][0] in self.cloud_files
        )

    def __len__(self):
        return len(self.objects)


class OneViewBatcher:
    """Assemble fixed-shape batches for the fused train step.

    Per sample: one random grasp row of one random object + one random view
    cloud subsampled/padded to ``cloud_points`` (the crop runs on device).
    A background thread prefetches batches.
    """

    def __init__(self, index: GraspDataIndex, batch_size: int,
                 cloud_points: int = 20000, num_classes: int = 2,
                 thresh_good: float = 0.6, thresh_bad: float = 0.6,
                 seed: int = 0, prefetch: int = 4,
                 views_per_sample: int = 1):
        """views_per_sample: 1 == the one-view datasets (dataset.py:420-430);
        >1 stacks that many random view files before subsampling, the full-
        cloud datasets' pc_file_used_num (dataset.py:244-254, fullv uses 20)."""
        self.index = index
        self.batch_size = batch_size
        self.cloud_points = cloud_points
        self.num_classes = num_classes
        self.thresh_good = thresh_good
        self.thresh_bad = thresh_bad
        self.views_per_sample = views_per_sample
        self.rng = np.random.RandomState(seed)
        self._grasp_cache: dict[str, np.ndarray] = {}
        # objects with ZERO grasp rows contribute no samples — the same
        # semantics as the reference's unravel_index over per-file row
        # counts (dataset.py:245), where an empty file gets no index slots.
        # (A tiny object can legitimately land 0 rows in one split of a
        # small run.) Sampling from one would crash the producer thread.
        self._objects = [o for o in index.objects
                         if len(self._load_grasps(o)) > 0]
        if not self._objects:
            raise ValueError(
                f"no grasp rows in any object under {index.root!r} "
                f"(tag={index.tag!r})")
        self._error: BaseException | None = None
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _load_grasps(self, obj):
        if obj not in self._grasp_cache:
            self._grasp_cache[obj] = np.load(self.index.grasp_files[obj])
        return self._grasp_cache[obj]

    def _fixed_cloud(self, pc):
        n = len(pc)
        if n >= self.cloud_points:
            idx = self.rng.choice(n, self.cloud_points, replace=False)
        else:
            idx = self.rng.choice(n, self.cloud_points, replace=True)
        return pc[idx]

    def _make_batch(self):
        b = self.batch_size
        grasps = np.zeros((b, 12), np.float32)
        clouds = np.zeros((b, self.cloud_points, 3), np.float32)
        transforms = np.zeros((b, 4, 4), np.float32)
        levels = np.zeros((b,), np.float32)
        refines = np.zeros((b,), np.float32)
        for i in range(b):
            obj = self._objects[self.rng.randint(len(self._objects))]
            rows = self._load_grasps(obj)
            row = rows[self.rng.randint(len(rows))]
            grasps[i, : row.shape[0]] = row
            levels[i], refines[i] = row[-2], row[-1]
            cloud_obj = self.index.transform[obj][0]
            files = self.index.cloud_files[cloud_obj]
            if self.views_per_sample <= 1:
                pc = np.asarray(np.load(files[self.rng.randint(len(files))]),
                                np.float32)[:, :3]
            else:
                picks = self.rng.choice(len(files), self.views_per_sample)
                pc = np.concatenate([
                    np.asarray(np.load(files[j]), np.float32)[:, :3]
                    for j in picks
                ])
            clouds[i] = self._fixed_cloud(pc)
            transforms[i] = np.asarray(self.index.transform[obj][1], np.float32)
        labels, weights = labels_from_scores(
            levels, refines, self.thresh_good, self.thresh_bad, self.num_classes
        )
        return grasps, clouds, transforms, labels, weights

    def _producer(self):
        while not self._stop.is_set():
            try:
                batch = self._make_batch()
            except BaseException as e:  # surface it — a silently dead
                self._error = e         # producer would hang the consumer
                self._queue.put(None)
                return
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        out = self._queue.get()
        if out is None and self._error is not None:
            raise RuntimeError(
                "OneViewBatcher producer thread failed") from self._error
        return out

    def close(self):
        self._stop.set()


class SyntheticGraspData:
    """Synthetic stand-in for the YCB grasp data (tests, benchmarks, CI).

    Generates box-like object clouds and grasp rows whose closing regions
    actually contain points, with score columns spanning the label bands.
    """

    def __init__(self, batch_size: int, cloud_points: int = 5000,
                 num_classes: int = 2, seed: int = 0,
                 thresh_good: float = 0.6, thresh_bad: float = 0.6,
                 learnable: bool = False):
        self.batch_size = batch_size
        self.cloud_points = cloud_points
        self.num_classes = num_classes
        self.thresh_good = thresh_good
        self.thresh_bad = thresh_bad
        self.learnable = learnable
        self.rng = np.random.RandomState(seed)

    def next_batch(self):
        b, p = self.batch_size, self.cloud_points
        rng = self.rng
        clouds = rng.rand(b, p, 3).astype(np.float32) * 0.08 - 0.04
        grasps = np.zeros((b, 12), np.float32)
        grasps[:, 0:3] = clouds.mean(axis=1) + rng.randn(b, 3) * 0.005
        axes = rng.randn(b, 3).astype(np.float32)
        grasps[:, 3:6] = axes / np.linalg.norm(axes, axis=1, keepdims=True)
        grasps[:, 6] = 0.08
        grasps[:, 7] = rng.uniform(-np.pi, np.pi, b)
        grasps[:, 10] = rng.uniform(0.3, 2.2, b)   # level score
        grasps[:, 11] = rng.uniform(0.0, 1.0, b)   # refine score
        transforms = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
        labels, weights = labels_from_scores(
            grasps[:, 10], grasps[:, 11], self.thresh_good, self.thresh_bad,
            self.num_classes,
        )
        if self.learnable:
            # give labels a geometric signature the network can learn from
            # the cropped points: "good" samples concentrate their cloud
            # tightly around the grasp center (tests/CI sanity for the whole
            # learning loop — the random-score mode has NO learnable signal)
            good = labels == (self.num_classes - 1)
            for i in np.where(good & (weights > 0))[0]:
                clouds[i] = (grasps[i, 0:3]
                             + (clouds[i] - grasps[i, 0:3]) * 0.25)
        return grasps, clouds, transforms, labels, weights

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()
