"""Plain checks of the online frame: the voxel cloud, and the rules every
grasp candidate that GPG emits has to keep.

Voxel downsampling (VoxelGrid, kinect2grasp.py:102-144): a grid of
``n_grid`` cells a side over the cloud's bounding box; each occupied cell
becomes its centre, kept where its first point lies, in the cloud's order.
The cell step is the box's span times float32(1 / n_grid) and a centre is
``(index + 0.5) * step + lo`` rounded once.

A GPG candidate (grasp_sampler.py:1539-1614) is a hand pose: bottom centre,
approach, binormal, minor axis. Its approach points down (z below -0.5),
its axes are orthonormal, its closing region holds more than
``min_open_points`` points and neither finger nor the palm holds any. The
panels are boxes in the hand's frame built from the gripper's parameters
(hand_points below, grasp_sampler.py:287-369). A point closer than
``margin`` to a panel's face is counted neither for nor against a rule,
since float32 coordinates place it on either side.
"""

from __future__ import annotations

import numpy as np
import torch

from .crop import fma


def voxel_downsample(points, n_grid: int):
    """(P, 3) float32 -> (M, 3) kept voxel centres in the cloud's order."""
    lo = points.amin(dim=0)
    hi = points.amax(dim=0)
    span = torch.clamp(hi - lo, min=1e-9)
    step = span * torch.tensor(1.0 / n_grid, dtype=torch.float32,
                               device=points.device)
    idx = torch.clamp(((points - lo) / step).to(torch.int32), 0, n_grid - 1)
    centers = fma(idx.float() + 0.5, step, lo)
    vid = ((idx[:, 0].long() * n_grid + idx[:, 1]) * n_grid + idx[:, 2])
    _, inv = torch.unique(vid, return_inverse=True)
    first = torch.full((int(inv.max()) + 1,), points.shape[0],
                       dtype=torch.long, device=points.device)
    first = first.scatter_reduce(0, inv, torch.arange(
        points.shape[0], device=points.device), reduce="amin")
    keep = torch.zeros(points.shape[0], dtype=torch.bool,
                       device=points.device)
    keep[first] = True
    return centers[keep]


def hand_points(g: dict) -> np.ndarray:
    """The 21-point hand in its own frame (approach +x, binormal +y, minor
    +z, bottom centre at the origin), grasp_sampler.py:287-321."""
    hh, fw, hd = g["hand_height"], g["finger_width"], g["hand_depth"]
    ow = g["hand_outer_diameter"] - 2.0 * fw
    x, y, z = np.eye(3)
    p5 = -y * ow / 2 + z * hh / 2
    p6 = y * ow / 2 + z * hh / 2
    p7 = y * ow / 2 - z * hh / 2
    p8 = -y * ow / 2 - z * hh / 2
    p1, p2, p3, p4 = (x * hd + p for p in (p5, p6, p7, p8))
    p9, p10, p11, p12 = (-y * fw + p for p in (p1, p4, p5, p8))
    p13, p14, p15, p16 = (y * fw + p for p in (p2, p3, p6, p7))
    p17, p18, p19, p20 = (-x * hh + p for p in (p11, p15, p16, p12))
    return np.stack([np.zeros(3), p1, p2, p3, p4, p5, p6, p7, p8, p9, p10,
                     p11, p12, p13, p14, p15, p16, p17, p18, p19, p20])


# panel -> corner indices (s1, s2, s4, s8), grasp_sampler.py:354-361
PANELS = {"open": (1, 2, 4, 8), "bottom": (11, 15, 12, 20),
          "left": (9, 1, 10, 12), "right": (2, 13, 3, 7)}


def panel_boxes(g: dict) -> dict:
    """name -> (lo, hi): x in (s8.x, s4.x), y in (s1.y, s2.y), z in (s4.z,
    s1.z)."""
    p = hand_points(g)
    return {name: (np.array([p[i8][0], p[i1][1], p[i4][2]]),
                   np.array([p[i4][0], p[i2][1], p[i1][2]]))
            for name, (i1, i2, i4, i8) in PANELS.items()}


def rule_violations(cloud, frames, gripper: dict, *, min_open_points: int,
                    margin: float = 1e-6) -> int:
    """Number of candidates (frames (G, 5, 3): bottom centre, approach,
    binormal, minor, table-adjusted bottom centre) that break a rule, judged
    at the adjusted bottom centre in float64."""
    if frames.shape[0] == 0:
        return 0
    f = frames.double()
    pts = cloud.double()
    rows = f[:, 1:4]                                   # (G, 3, 3)
    ortho = (rows @ rows.transpose(1, 2)
             - torch.eye(3, dtype=f.dtype, device=f.device)).abs().amax(
                 dim=(1, 2))
    local = (pts[None] - f[:, 4, None]) @ rows.transpose(1, 2)  # (G, P, 3)
    bad = (ortho > 1e-4) | (rows[:, 0, 2] >= -0.5 + 1e-3)
    for name, (lo, hi) in panel_boxes(gripper).items():
        lo = torch.as_tensor(lo, dtype=f.dtype, device=f.device)
        hi = torch.as_tensor(hi, dtype=f.dtype, device=f.device)
        sure = torch.all((local > lo + margin) & (local < hi - margin),
                         dim=-1).sum(dim=1)
        maybe = torch.all((local > lo - margin) & (local < hi + margin),
                          dim=-1).sum(dim=1)
        if name == "open":
            bad |= maybe <= min_open_points
        else:
            bad |= sure > 0
    return int(bad.sum())
