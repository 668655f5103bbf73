"""Grasp collision checking against surface geometry.

Port of ``pointnetgpd_tpu/grasping/collision_checker.py`` (reference:
dex-net/src/dexnet/grasping/collision_checker.py:46-376, which wraps
openravepy): collisions are tested against the object's surface points
(SDF surface cells or a sensor cloud) with the gripper's panel boxes in the
grasp frame, the model the samplers use, as one batched call for G grasps.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import sdf as sdf_lib
from .gripper import (Gripper, collision_and_open_counts, hand_points,
                      panel_box_array)


class GraspCollisionChecker:
    """(collision_checker.py:237-376 API surface), on ``device``."""

    def __init__(self, gripper: Gripper = Gripper(), device="cuda"):
        self.gripper = gripper
        self.device = torch.device(device)
        self._boxes = torch.as_tensor(panel_box_array(gripper),
                                      dtype=torch.float32, device=self.device)
        self._points: list = []
        self._table_z = None

    def set_graspable_object(self, obj, pose_4x4=None):
        """obj: SdfGrid or (N, 3) points. Replaces the scene."""
        self._points = []
        self.add_graspable_object(obj, pose_4x4)

    def add_graspable_object(self, obj, pose_4x4=None):
        if isinstance(obj, sdf_lib.SdfGrid):
            pts = sdf_lib.grid_to_world(obj, obj.surface_points).cpu().numpy()
        else:
            pts = np.asarray(obj, np.float32)
        if pose_4x4 is not None:
            pose_4x4 = np.asarray(pose_4x4)
            pts = pts @ pose_4x4[:3, :3].T + pose_4x4[:3, 3]
        self._points.append(pts.astype(np.float32))

    def set_table(self, z: float = 0.0):
        """Clearance plane (collision_checker.py set_table analogue)."""
        self._table_z = z

    @property
    def scene_points(self):
        if not self._points:
            return np.zeros((0, 3), np.float32)
        return np.concatenate(self._points)

    def grasps_in_collision(self, frames):
        """frames (G, >=4, 3) rows [bottom_center, approach, binormal, minor,
        ...] -> (G,) bool: a hand panel (bottom / left / right) holds scene
        points, or the hand dips below the table
        (collision_checker.py:310-336)."""
        frames = torch.as_tensor(np.asarray(frames), dtype=torch.float32,
                                 device=self.device)
        pts = torch.as_tensor(self.scene_points, device=self.device)
        if pts.shape[0] == 0 and self._table_z is None:
            return np.zeros(len(frames), bool)
        bc = frames[:, 0]
        rot = frames[:, 1:4]                                   # (G, 3, 3)
        pf = (pts[None] - bc[:, None]) @ rot.transpose(1, 2)   # (G, P, 3)
        counts = collision_and_open_counts(pf, self._boxes)    # (G, 4)
        collide = (counts[:, 1:] > 0).any(dim=1)
        if self._table_z is not None:
            hp = torch.as_tensor(hand_points(self.gripper)[1:],
                                 dtype=torch.float32, device=self.device)
            hp_world = bc[:, None] + hp @ rot
            collide = collide | (hp_world[..., 2].amin(dim=1) < self._table_z)
        return collide.cpu().numpy()

    def grasp_in_collision(self, frame, key=None):
        """Single-grasp convenience (collision_checker.py:310)."""
        return bool(self.grasps_in_collision(np.asarray(frame)[None])[0])

    def collides_along_approach(self, frame, approach_dist: float,
                                delta_approach: float = 0.005):
        """True if any pose from ``approach_dist`` back along the approach
        axis to the grasp pose collides (collision_checker.py:337-376)."""
        frame = np.asarray(frame, np.float32)
        steps = max(int(approach_dist / delta_approach), 1)
        frames = np.tile(frame[None], (steps, 1, 1))
        for i in range(steps):
            frames[i, 0] = frame[0] - frame[1] * (approach_dist
                                                  - i * delta_approach)
        return bool(self.grasps_in_collision(frames).any())
