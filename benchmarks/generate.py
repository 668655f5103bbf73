"""The one generator of the benchmark's inputs: every traffic file's
parameters in, tensors out, all fixed by the seed.

- ``tabletops``: segmented tabletop clouds (host arrays, as a camera node
  delivers them): boxes of three visible faces each, placed at random
  without overlap inside the tray, table at z = 0; laid out from the seed.
- ``box_scenes``: a cloud filling a box and candidate hand frames with
  centres inside it and uniformly random orientations, on the device.
- ``grasp_batches``: training batches in the form of the synthetic grasp
  data (box-like clouds, grasps centred near the cloud's mean with random
  axes and approach angles, friction scores spanning the label bands), on
  the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .draws import derive, generator


def tabletops(t: dict, seed: int) -> list[np.ndarray]:
    """The mix's tabletops, laid out from the run's seed: every seed gets
    the same number of boxes and points in other places."""
    rs = np.random.RandomState(derive(seed, "tabletops") % (1 << 32))
    size, n = t["box_size_m"], t["face_points"]
    (x0, x1), (y0, y1) = t["tray_x_m"], t["tray_y_m"]
    scenes = []
    for _ in range(t["scenes"]):
        corners = []
        while len(corners) < t["boxes"]:
            c = rs.uniform([x0, y0], [x1 - size, y1 - size])
            if all(np.abs(c - o).max() > size * 1.5 for o in corners):
                corners.append(c)
        objs = []
        base = t["box_base_z_m"]
        for cx, cy in corners:
            top = rs.rand(n, 3) * [size, size, 0] + [cx, cy, base + size]
            front = rs.rand(n, 3) * [size, 0, size] + [cx, cy, base]
            side = rs.rand(n, 3) * [0, size, size] + [cx + size, cy, base]
            objs.append(np.concatenate([top, front, side]))
        scenes.append(np.concatenate(objs).astype(np.float32))
    return scenes


def random_rotations(n: int, gen, device):
    """(n, 3, 3) rotation matrices, uniform (normalized Gaussian
    quaternions); rows are the frame's axes."""
    q = torch.randn((n, 4), generator=gen, device=device)
    q = q / q.norm(dim=1, keepdim=True)
    w, x, y, z = q.unbind(1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y + w * z),
                     2 * (x * z - w * y)], 1),
        torch.stack([2 * (x * y - w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z + w * x)], 1),
        torch.stack([2 * (x * z + w * y), 2 * (y * z - w * x),
                     1 - 2 * (x * x + y * y)], 1)], 1)


def box_scenes(t: dict, seed: int, device):
    """[(cloud (P, 3), frames (G, 5, 3)), ...]: frame rows bottom centre,
    approach, binormal, minor, bottom centre."""
    extent = torch.tensor(t["scene_extent_m"], device=device)
    shift = torch.tensor(t["center_shift_m"], device=device)
    out = []
    for s in range(t["scenes"]):
        gen = generator(device, seed, "box_scenes", s)
        pc = torch.rand((t["scene_points"], 3), generator=gen,
                        device=device) * extent
        g = t["candidates"]
        centers = torch.rand((g, 3), generator=gen, device=device) * extent \
            + shift
        rot = random_rotations(g, gen, device)
        frames = torch.cat([centers[:, None], rot, centers[:, None]], dim=1)
        out.append((pc.contiguous(), frames.contiguous()))
    return out


def grasp_batches(t: dict, seed: int, device):
    """[(grasps (B, 12), clouds (B, P, 3), transforms (B, 4, 4), labels
    (B,), weights (B,)), ...]. Labels follow the 2-class bands of
    dataset.py:271-277: friction score + 0.01 x refine score at or above
    ``thresh_bad`` is class 0, at or below ``thresh_good`` class 1, between
    them dropped (weight 0)."""
    b, p = t["batch"], t["cloud_points"]
    half = t["cloud_half_extent_m"]
    out = []
    for s in range(t["pool"]):
        gen = generator(device, seed, "grasp_batches", s)
        clouds = torch.rand((b, p, 3), generator=gen, device=device) \
            * (2 * half) - half
        grasps = torch.zeros((b, 12), device=device)
        grasps[:, 0:3] = clouds.mean(dim=1) + torch.randn(
            (b, 3), generator=gen, device=device) * t["center_sigma_m"]
        axes = torch.randn((b, 3), generator=gen, device=device)
        grasps[:, 3:6] = axes / axes.norm(dim=1, keepdim=True)
        grasps[:, 6] = t["width_m"]
        grasps[:, 7] = (torch.rand((b,), generator=gen, device=device)
                        * 2 - 1) * np.pi
        lo, hi = t["friction_score_range"]
        grasps[:, 10] = lo + (hi - lo) * torch.rand((b,), generator=gen,
                                                    device=device)
        grasps[:, 11] = torch.rand((b,), generator=gen, device=device)
        score = grasps[:, 10] + grasps[:, 11] * 0.01
        labels = torch.where(score >= t["thresh_bad"], 0, 1)
        weights = ((score >= t["thresh_bad"])
                   | (score <= t["thresh_good"])).float()
        transforms = torch.eye(4, device=device).expand(b, 4, 4).contiguous()
        out.append((grasps, clouds.contiguous(), transforms, labels, weights))
    return out
