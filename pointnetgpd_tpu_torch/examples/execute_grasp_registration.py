"""Register database grasps to the robot frame and pick the best.

Port of ``examples/execute_grasp_registration.py`` (reference:
dex-net/examples/execute_grasp_registration.py): look up an object's stored
grasps, transform them through the object's registered pose into the robot
frame, filter them by collisions and emit the best gripper pose.

Self-contained: builds a synthetic sphere object and an HDF5 database in a
temporary directory (needs h5py). The database's SDF, labels and the
collision test run on ``--device``.

Run: python -m pointnetgpd_tpu_torch.examples.execute_grasp_registration
         [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

from ..api import DexNet
from ..geometry.io import write_obj
from ..geometry.mesh import Mesh3D
from ..grasping.collision_checker import GraspCollisionChecker
from ..grasping.grasp import rotated_full_axis
from ..grasping.gripper import Gripper


def make_sphere_obj(tmp, radius=0.05):
    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                  [0, 0, 1], [0, 0, -1]], float)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    m = Mesh3D(v, f).subdivide().subdivide()
    m = Mesh3D(radius * m.vertices / np.linalg.norm(m.vertices, axis=1,
                                                    keepdims=True),
               m.triangles)
    path = f"{tmp}/sphere.obj"
    write_obj(path, m.vertices, m.triangles)
    return path


def run(tmp, device="cuda", draws=None):
    """The registration in ``tmp``: returns a dict with the stored grasps
    (``configs``, ``metrics``), the robot-frame ``robot_configs``, the
    collision mask ``collides`` and the ``best`` grasp's index. ``draws``:
    the labeling's draws (default: those of seed 0)."""
    api = DexNet({"sdf_dim": 32, "sdf_padding": 3, "grasps_per_class": 3,
                  "cache_dir": f"{tmp}/cache"}, device=device)
    api.open_database(f"{tmp}/demo.hdf5")
    try:
        api.open_dataset("demo")
        key = api.add_object(make_sphere_obj(tmp))
        api.compute_simulation_data(key, seed=0, draws=draws)
        configs, metrics = api.get_grasps(key)
        print(f"{len(configs)} stored grasps")

        # registered object pose in the robot frame (e.g. from perception)
        t_obj_robot = np.eye(4)
        t_obj_robot[:3, 3] = [0.45, 0.1, 0.08]

        # transform grasps into the robot frame
        robot_configs = configs.copy()
        robot_configs[:, 0:3] = configs[:, 0:3] @ t_obj_robot[:3, :3].T \
            + t_obj_robot[:3, 3]
        robot_configs[:, 3:6] = configs[:, 3:6] @ t_obj_robot[:3, :3].T

        # filter by table collisions
        checker = GraspCollisionChecker(Gripper(), device=device)
        checker.set_table(0.0)
        frames = []
        for cfg in robot_configs:
            rot = rotated_full_axis(torch.as_tensor(cfg[3:6]),
                                    torch.as_tensor(cfg[7])).numpy()
            frames.append(np.stack([cfg[0:3], rot[:, 0], cfg[3:6],
                                    rot[:, 2]]))
        collides = checker.grasps_in_collision(np.stack(frames))
        ok = ~collides

        scores = metrics["robust_ferrari_canny"]
        ranked = np.argsort(-scores * ok)
        best = int(ranked[0])
        print(f"best collision-free grasp #{best}: "
              f"center={robot_configs[best, :3].round(3).tolist()} "
              f"quality={scores[best]:.4f} collision_free={bool(ok[best])}")
    finally:
        api.close_database()
    return {"configs": configs, "metrics": metrics,
            "robot_configs": robot_configs, "collides": collides,
            "best": best}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(tempfile.mkdtemp(), device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
