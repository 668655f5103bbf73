"""Parallel-jaw gripper model: parameters, the 21-point hand, panel boxes.

Port of ``pointnetgpd_tpu/grasping/gripper.py`` (numpy only; kept as a copy so
the port imports nothing of the JAX package). Default parameters are the
robotiq_85 set (reference asset dex-net/data/grippers/robotiq_85/params.json).
Loading other grippers (``from_json``, ``named``) and the collision helpers
come in a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
