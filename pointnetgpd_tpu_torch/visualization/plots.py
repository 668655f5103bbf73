"""Matplotlib visualizers for meshes, grasps, and grippers.

Port of ``pointnetgpd_tpu/visualization/plots.py``: host-side numpy and
matplotlib, with the grasp endpoints from the port's ``grasping/grasp.py``
on CPU tensors. Equivalents of
DexNetVisualizer3D.gripper/grasp/gripper_on_object (reference:
dex-net/src/dexnet/visualization/visualizer3d.py:57-116) and the 2-D grasp
arrows (visualizer2d.py:45), on matplotlib instead of mayavi.
Functions return the figure so callers can save or show.
"""

from __future__ import annotations

import numpy as np
import torch

import matplotlib

matplotlib.use("Agg")  # headless by default
import matplotlib.pyplot as plt  # noqa: E402
from mpl_toolkits.mplot3d.art3d import Poly3DCollection  # noqa: E402

from ..grasping.grasp import endpoints as grasp_endpoints  # noqa: E402
from ..grasping.gripper import Gripper, hand_points  # noqa: E402


def _new_3d_axes():
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="3d")
    return fig, ax


def plot_mesh(mesh, ax=None, color=(0.5, 0.5, 0.8), alpha=0.6, show=False):
    fig, ax = (ax.figure, ax) if ax is not None else _new_3d_axes()
    tv = np.asarray(mesh.vertices)[np.asarray(mesh.triangles)]
    ax.add_collection3d(Poly3DCollection(tv, facecolor=color, alpha=alpha,
                                         edgecolor="none"))
    lo, hi = mesh.bounding_box()
    c = (lo + hi) / 2
    r = (hi - lo).max() / 2
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)
    if show:
        plt.show()
    return fig


def plot_gripper_3d(bottom_center, approach, binormal, minor,
                    gripper: Gripper = Gripper(), ax=None,
                    color=(0, 0.6, 0), show=False):
    """Wireframe hand from the 21-point model (grasp_sampler.py:287-334)."""
    fig, ax = (ax.figure, ax) if ax is not None else _new_3d_axes()
    rot_rows = np.stack([approach, binormal, minor])
    pts = np.asarray(bottom_center) + hand_points(gripper) @ rot_rows
    # finger + palm edges (indices per get_hand_points layout)
    edges = [(1, 2), (3, 4), (1, 4), (2, 3),       # finger tips frame
             (5, 6), (7, 8), (5, 8), (6, 7),       # hand opening
             (1, 5), (2, 6), (3, 7), (4, 8),       # fingers
             (9, 10), (13, 14), (17, 20), (18, 19)]
    for a, b in edges:
        ax.plot(*zip(pts[a], pts[b]), color=color, linewidth=2)
    if show:
        plt.show()
    return fig


def plot_grasps_3d(mesh, configs, scores=None, max_plot: int = 25,
                   gripper: Gripper = Gripper(), show=False):
    """Object + grasp axes colored by score (visualizer3d.py gripper_on_object;
    the reference caps at max_plot_gripper=250, config.yaml)."""
    fig = plot_mesh(mesh)
    ax = fig.axes[0]
    configs = np.asarray(configs)[:max_plot]
    if scores is None:
        scores = np.ones(len(configs))
    scores = np.asarray(scores)[:max_plot]
    smax = scores.max() if len(scores) and scores.max() > 0 else 1.0

    for cfg, s in zip(configs, scores):
        g1, g2 = (g.numpy() for g in grasp_endpoints(torch.as_tensor(cfg)))
        ax.plot(*zip(g1, g2), color=plt.cm.viridis(float(s) / smax),
                linewidth=2)
        ax.scatter(*cfg[0:3], color="r", s=10)
    if show:
        plt.show()
    return fig


def plot_stable_poses(mesh, poses, show=False):
    """Grid of the mesh in each stable pose (api display_stable_poses)."""
    n = max(len(poses), 1)
    cols = min(n, 3)
    rows = (n + cols - 1) // cols
    fig = plt.figure(figsize=(4 * cols, 4 * rows))
    for i, pose in enumerate(poses):
        ax = fig.add_subplot(rows, cols, i + 1, projection="3d")
        t = np.eye(4)
        t[:3, :3] = pose["r"]
        m = mesh.transform(t)
        plot_mesh(m, ax=ax)
        ax.set_title(f"p={pose['p']:.3f}")
    if show:
        plt.show()
    return fig


def plot_grasp_2d(image, grasp_center_px, grasp_axis_px, width_px,
                  ax=None, color="r", show=False):
    """2-D grasp jaw arrows over an image (visualizer2d.py:45)."""
    fig, ax = (ax.figure, ax) if ax is not None else plt.subplots()
    ax.imshow(image, cmap="gray")
    c = np.asarray(grasp_center_px, float)
    a = np.asarray(grasp_axis_px, float)
    a = a / max(np.linalg.norm(a), 1e-12)
    g1 = c - 0.5 * width_px * a
    g2 = c + 0.5 * width_px * a
    ax.plot([g1[0], g2[0]], [g1[1], g2[1]], color=color, linewidth=2)
    ax.scatter(*c, color=color, marker="x")
    jaw = np.array([-a[1], a[0]]) * width_px * 0.15
    for g in (g1, g2):
        ax.plot([g[0] - jaw[0], g[0] + jaw[0]],
                [g[1] - jaw[1], g[1] + jaw[1]], color=color, linewidth=2)
    if show:
        plt.show()
    return fig
