"""Batched grasp scorers: the deployed models on the card (PointNet family,
its trunks through K2, and the GPD projection-CNN baseline); the names of
``pointnetgpd_tpu/inference/__init__.py``."""

from .gpd_scorer import GPDScorer, score_candidates_gpd
from .scorer import GraspScorer, score_candidates_fused, score_cloud_batch

__all__ = ["GPDScorer", "GraspScorer", "score_candidates_fused",
           "score_candidates_gpd", "score_cloud_batch"]
