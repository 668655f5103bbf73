"""Parallel-jaw gripper model: parameters, the 21-point hand, panel boxes
and the box tests.

Port of ``pointnetgpd_tpu/grasping/gripper.py`` (reference:
dex-net/src/dexnet/grasping/gripper.py:46-129 and the sampler's hand
geometry, grasp_sampler.py:287-417). The parameter sets are kept as a copy
so the port imports nothing of the JAX package; the box tests run on
tensors. Default parameters are the robotiq_85 set (reference asset
dex-net/data/grippers/robotiq_85/params.json).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Gripper:
    """Gripper parameters (reference README.md:56-74)."""

    name: str = "robotiq_85"
    min_width: float = 0.0
    force_limit: float = 235.0
    max_width: float = 0.085
    finger_radius: float = 0.01
    max_depth: float = 0.03
    finger_width: float = 0.0255
    real_finger_width: float = 0.0255
    hand_height: float = 0.030
    hand_height_two_finger_side: float = 0.105
    hand_outer_diameter: float = 0.218
    hand_depth: float = 0.125
    real_hand_depth: float = 0.120
    init_bite: float = 0.01

    @property
    def open_width(self) -> float:
        return self.hand_outer_diameter - 2.0 * self.finger_width

    def collides_with_table(self, config, table_z: float = 0.0,
                            clearance: float = 0.0) -> bool:
        """True when the 21-point hand in the grasp pose dips below the
        table plane (reference: gripper.py:69-103 tests the mesh's min z)."""
        from .grasp import rotated_full_axis

        config = np.asarray(config, np.float64)
        rot = rotated_full_axis(torch.as_tensor(config[3:6]),
                                torch.as_tensor(config[7])).numpy()
        rows = np.stack([rot[:, 0], config[3:6], rot[:, 2]])
        pts = config[0:3] + hand_points(self)[1:] @ rows
        return bool(pts[:, 2].min() < table_z + clearance)

    def gripper_pose(self, config, t_grasp_gripper=None):
        """4x4 gripper->object transform of a grasp configuration
        (reference: grasp.py:377-399 with gripper.py:105-129's
        T_grasp_gripper composed on the right; identity by default)."""
        from .grasp import t_grasp_obj

        t = t_grasp_obj(torch.as_tensor(np.asarray(config, np.float64)))
        t = t.numpy()
        if t_grasp_gripper is not None:
            t = t @ np.asarray(t_grasp_gripper)
        return t

    @classmethod
    def from_json(cls, path: str, name: str = "custom") -> "Gripper":
        import json

        with open(path) as f:
            params = json.load(f)
        fields = {k: v for k, v in params.items()
                  if k in cls.__dataclass_fields__}
        return cls(name=name, **fields)

    @classmethod
    def named(cls, name: str) -> "Gripper":
        """A built-in parameter set (reference assets
        dex-net/data/grippers/{robotiq_85,baxter,yumi_metal_spline}/
        params.json); keys a set lacks keep the robotiq_85 defaults."""
        try:
            overrides = _NAMED_GRIPPERS[name]
        except KeyError:
            raise KeyError(
                f"unknown gripper {name!r}; built-ins: "
                f"{sorted(_NAMED_GRIPPERS)}") from None
        return cls(name=name, **overrides)


# Built-in parameter sets (reference: dex-net/data/grippers/*/params.json).
_NAMED_GRIPPERS = {
    "robotiq_85": {},
    "baxter": dict(min_width=0.025, max_width=0.06, force_limit=30.0,
                   finger_radius=0.01, max_depth=0.05, finger_width=0.01),
    "yumi_metal_spline": dict(min_width=0.0, force_limit=20.0, max_width=0.05,
                              finger_radius=0.01, max_depth=0.04,
                              finger_width=0.01),
}


def _tf(rotation_rows, translation):
    t = np.eye(4)
    t[:3, :3] = np.asarray(rotation_rows, np.float64)
    t[:3, 3] = np.asarray(translation, np.float64)
    return t


# Gripper-frame conventions as 4x4 transforms (reference:
# dex-net/data/grippers/*/T_grasp_gripper.tf and T_mesh_gripper.tf).
# ``t_grasp_gripper`` maps gripper-frame coords to grasp-frame coords and
# composes on the right of t_grasp_obj (grasp.py:393-399).
_NAMED_TRANSFORMS = {
    "robotiq_85": {
        "t_grasp_gripper": _tf(np.eye(3), [0, 0, 0]),
        "t_mesh_gripper": _tf([[0, 1, 0], [1, 0, 0], [0, 0, -1]],
                              [0, 0.0675, 0]),
    },
    "baxter": {
        "t_grasp_gripper": _tf([[0, 0, -1], [0, 1, 0], [1, 0, 0]], [0, 0, 0]),
        "t_mesh_gripper": _tf(np.eye(3), [0.005, 0, 0.055]),
    },
    "yumi_metal_spline": {
        "t_grasp_gripper": _tf([[0, 0, 1], [1, 0, 0], [0, 1, 0]], [0, 0, 0]),
        "t_mesh_gripper": _tf(np.eye(3), [0, 0, 0.078237]),
    },
}


def named_transforms(name: str) -> dict:
    """The built-in (t_grasp_gripper, t_mesh_gripper) 4x4s of a gripper."""
    try:
        return {k: v.copy() for k, v in _NAMED_TRANSFORMS[name].items()}
    except KeyError:
        raise KeyError(
            f"unknown gripper {name!r}; built-ins: "
            f"{sorted(_NAMED_TRANSFORMS)}") from None


def hand_points(gripper: Gripper) -> np.ndarray:
    """The 21-point hand model in the local grasp frame (approach = +x,
    binormal = +y, minor = +z, bottom center at origin) —
    grasp_sampler.py:287-321 with identity frame."""
    hh, fw, hd = gripper.hand_height, gripper.finger_width, gripper.hand_depth
    open_w = gripper.open_width
    x, y, z = np.eye(3)
    p5_p6 = z * hh * 0.5
    p7_p8 = -z * hh * 0.5
    p5 = -y * open_w * 0.5 + p5_p6
    p6 = y * open_w * 0.5 + p5_p6
    p7 = y * open_w * 0.5 + p7_p8
    p8 = -y * open_w * 0.5 + p7_p8
    p1, p2, p3, p4 = (x * hd + p for p in (p5, p6, p7, p8))
    p9, p10, p11, p12 = (-y * fw + p for p in (p1, p4, p5, p8))
    p13, p14, p15, p16 = (y * fw + p for p in (p2, p3, p6, p7))
    p17, p18, p19, p20 = (-x * hh + p for p in (p11, p15, p16, p12))
    return np.stack([np.zeros(3), p1, p2, p3, p4, p5, p6, p7, p8, p9, p10,
                     p11, p12, p13, p14, p15, p16, p17, p18, p19, p20])


# panel -> (s1, s2, s4, s8) indices (grasp_sampler.py:354-361)
_PANEL_CORNERS = {
    "p_open": (1, 2, 4, 8),
    "p_left": (9, 1, 10, 12),
    "p_right": (2, 13, 3, 7),
    "p_bottom": (11, 15, 12, 20),
}


def panel_boxes(gripper: Gripper) -> dict:
    """Each panel as a static (lo, hi) box in the local grasp frame:
    x in (s8.x, s4.x), y in (s1.y, s2.y), z in (s4.z, s1.z), strict
    (grasp_sampler.py:364-369)."""
    p = hand_points(gripper)
    boxes = {}
    for name, (i1, i2, i4, i8) in _PANEL_CORNERS.items():
        s1, s2, s4, s8 = p[i1], p[i2], p[i4], p[i8]
        boxes[name] = (np.array([s8[0], s1[1], s4[2]]),
                       np.array([s4[0], s2[1], s1[2]]))
    return boxes


def panel_box_array(gripper: Gripper) -> np.ndarray:
    """(4, 2, 3) array of [open, bottom, left, right] boxes."""
    boxes = panel_boxes(gripper)
    order = ["p_open", "p_bottom", "p_left", "p_right"]
    return np.stack([np.stack(boxes[k]) for k in order])


def points_in_frame(bottom_center, approach, binormal, minor, points):
    """(..., P, 3) world points in the grasp frame rows [approach, binormal,
    minor] about bottom_center (grasp_sampler.py:336-353); the frame vectors
    may carry leading grasp dims (..., 3)."""
    rot = torch.stack([approach, binormal, minor], dim=-2)       # (..., 3, 3)
    return (points - bottom_center[..., None, :]) @ rot.transpose(-1, -2)


def count_in_box(points_frame, lo, hi):
    """Number of frame points strictly inside the (lo, hi) box."""
    lo = torch.as_tensor(lo, dtype=points_frame.dtype,
                         device=points_frame.device)
    hi = torch.as_tensor(hi, dtype=points_frame.dtype,
                         device=points_frame.device)
    inside = torch.all((points_frame > lo) & (points_frame < hi), dim=-1)
    return inside.sum(dim=-1)


def collision_and_open_counts(points_frame, boxes):
    """(..., 4) counts for the [open, bottom, left, right] boxes (4, 2, 3)
    of frame points (..., P, 3). A pose is kept when open > 0 and the others
    are 0 (grasp_sampler.py:1539-1557); it collides when any of bottom, left
    or right is > 0 (check_collide, grasp_sampler.py:401-417)."""
    boxes = torch.as_tensor(boxes, dtype=points_frame.dtype,
                            device=points_frame.device)
    pf = points_frame[..., None, :, :]                      # (..., 1, P, 3)
    inside = torch.all((pf > boxes[:, None, 0, :])
                       & (pf < boxes[:, None, 1, :]), dim=-1)  # (..., 4, P)
    return inside.sum(dim=-1)
