"""Visualization (matplotlib; the reference uses mayavi for 3-D —
reference: dex-net/src/dexnet/visualization/visualizer3d.py:57-116 and
visualizer2d.py:45. mayavi is not available here, so the 3-D views use
matplotlib's 3-D axes; the 2-D grasp plots match the reference's style)."""

from .plots import (
    plot_grasp_2d,
    plot_grasps_3d,
    plot_gripper_3d,
    plot_mesh,
    plot_stable_poses,
)

__all__ = ["plot_grasp_2d", "plot_grasps_3d", "plot_gripper_3d", "plot_mesh",
           "plot_stable_poses"]
