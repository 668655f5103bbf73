"""Online GPD-baseline scorer: crop + normals + projection + CNN.

Port of ``pointnetgpd_tpu/inference/gpd_scorer.py``. A trained
``GPDClassifier`` scores GPG candidates through the same per-scene shape as
``inference.scorer.GraspScorer``: the closing-region crop
(kinect2grasp.py:216-233 box), k-NN normals with the camera along -approach,
60x60 projection features (dataset.py:88-120), the CNN, and softmax on its
log_softmax (main_test.py:65-66, kept as in the PointNet scorer). The GPD
baseline is 2-class; "good" is class 1. Random numbers come from a
``draws.Draws``-like object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from ..draws import Draws
from ..ops.cloud import estimate_normals_knn
from ..ops.crop import collect_candidate_clouds
from ..ops.projection import gpd_projection_features
from ..utils.profiling import span
from .scorer import (PendingScore, collect_scores, dispatch_padded,
                     rank_candidates)

CAMERA = (-1.0, 0.0, 0.0)      # along -approach, in the gripper frame
NUM_CLASSES = 2                # "good" is the best class, 1


def gpd_features(clouds, widths, *, project_chann: int, knn_k: int = 30):
    """Cropped gripper-frame clouds (G, N, 3) and gripper widths (G,) ->
    (G, 60, 60, C) projection features over k-NN normals (spans
    ``gpd.normals``, then one ``gpd.project`` per projection order)."""
    n = clouds.shape[1]
    with span("gpd.normals"):
        normals = estimate_normals_knn(clouds, CAMERA, k=knn_k,
                                       chunk=min(256, n))
    valid = torch.ones(clouds.shape[:2], dtype=torch.bool,
                       device=clouds.device)
    return gpd_projection_features(clouds, normals, valid, widths,
                                   project_chann=project_chann)


@torch.no_grad()
def score_candidates_gpd(model, pc, cand_frames, valid_in, hand_depth, width,
                         draws, *, num_points: int = 500,
                         project_chann: int = 3, min_points: int = 50,
                         knn_k: int = 30):
    """Whole-scene GPD scoring. Returns (pred, prob, counts, valid, good,
    order) with the semantics of ``scorer.score_candidates_fused``."""
    clouds, counts, valid = collect_candidate_clouds(
        cand_frames[:, 0], cand_frames[:, 1], cand_frames[:, 2],
        cand_frames[:, 3], pc, hand_depth, width, draws,
        num_out=num_points, min_point_limit=min_points)
    valid = valid & valid_in
    widths = torch.full((clouds.shape[0],), float(width),
                        dtype=clouds.dtype, device=clouds.device)
    feats = gpd_features(clouds, widths, project_chann=project_chann,
                         knn_k=knn_k)
    probs = F.softmax(model(feats), dim=-1)          # deployed quirk
    pred = torch.where(valid, probs.argmax(dim=-1), 0)
    probs = torch.where(valid[:, None], probs, 0.0)
    return rank_candidates(pred, probs, counts, valid)


@dataclass
class GPDScorer:
    """``GraspScorer`` counterpart for the GPD projection-CNN baseline."""

    model: Any
    project_chann: int = 3
    num_points: int = 500
    pad_to: int = 64
    min_points: int = 50
    knn_k: int = 30
    device: Any = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.model = self.model.to(self.device).eval()

    def score_candidates(self, pc, candidates, hand_depth, width,
                         seed: int = 0, valid=None, extra_fetch=None,
                         draws=None):
        return self.collect(self.dispatch_candidates(
            pc, candidates, hand_depth, width, seed=seed, valid=valid,
            extra_fetch=extra_fetch, draws=draws))

    def dispatch_candidates(self, pc, candidates, hand_depth, width,
                            seed: int = 0, valid=None, extra_fetch=None,
                            draws=None):
        """Enqueue the scoring on the device; returns a ``PendingScore``."""
        def score(pc_d, cand_p, valid_in):
            return score_candidates_gpd(
                self.model, pc_d, cand_p, valid_in, float(hand_depth),
                float(width), draws or Draws(seed, self.device),
                num_points=self.num_points, project_chann=self.project_chann,
                min_points=self.min_points, knn_k=self.knn_k)

        return dispatch_padded(score, pc, candidates, valid, extra_fetch,
                               pad_to=self.pad_to, device=self.device)

    def collect(self, pending: PendingScore):
        """Copy the result (and the caller's extras) to the host."""
        return collect_scores(pending, NUM_CLASSES)
