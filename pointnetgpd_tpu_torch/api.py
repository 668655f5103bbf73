"""DexNet-style high-level API facade.

Port of ``pointnetgpd_tpu/api.py``. Re-design of the reference facade
(reference: dex-net/src/dexnet/api.py:62-787): one object wrapping
database management, object ingestion (mesh -> processed mesh + SDF +
stable poses), grasp sampling + metric computation, and exports — but the
compute paths drive the batched device programs (kernel K3 in the
voxelizer; the samplers, friction ladder and Ferrari-Canny of the labeling
path) on the facade's ``device`` instead of per-grasp host loops. Every
draw goes through a ``draws.Draws`` (default ``Draws(seed, device)``), so
a caller can inject its own.
"""

from __future__ import annotations

import os

import numpy as np

from .database import Hdf5Database, MeshProcessor, READ_WRITE_ACCESS
from .draws import Draws
from .grasping.gripper import Gripper

DEFAULT_CONFIG = {
    # mirrors cfg/api_defaults.yaml's main knobs (api.py:59,109)
    "sdf_dim": 100,
    "sdf_padding": 5,
    "stp_min_prob": 0.01,
    "obj_target_scale": 0.040,
    "obj_rescaling_type": "relative",
    "target_num_grasps": 25,
    "friction_coef": 2.0,
    "grasps_per_class": 20,
    "cache_dir": ".dexnet",
}


class DexNet:
    """(api.py:62-178 lifecycle: open_database / open_dataset / close)."""

    def __init__(self, config: dict | None = None, device="cuda"):
        self.device = device
        self.database: Hdf5Database | None = None
        self.dataset = None
        self.config = dict(DEFAULT_CONFIG)
        if config:
            self.config.update(config)

    # ------------------------------------------------------------------
    def open_database(self, database_path: str, create_db: bool = True):
        """(api.py:180-214)."""
        if not database_path.endswith(".hdf5"):
            raise ValueError("database must end in .hdf5")
        if not os.path.exists(database_path) and not create_db:
            raise ValueError(f"database {database_path} does not exist")
        self.database = Hdf5Database(database_path, READ_WRITE_ACCESS,
                                     device=self.device)
        return self.database

    def open_dataset(self, dataset_name: str, create_ds: bool = True):
        """(api.py:216-252)."""
        self._check_db()
        if dataset_name in self.database.dataset_names:
            self.dataset = self.database.dataset(dataset_name)
        elif create_ds:
            self.dataset = self.database.create_dataset(dataset_name)
        else:
            raise ValueError(f"dataset {dataset_name} does not exist")
        return self.dataset

    def close_database(self):
        if self.database is not None:
            self.database.flush()
            self.database.close()
            self.database = None
            self.dataset = None

    def _check_db(self):
        if self.database is None:
            raise RuntimeError("open a database first")

    def _check_ds(self):
        self._check_db()
        if self.dataset is None:
            raise RuntimeError("open a dataset first")

    # ------------------------------------------------------------------
    def add_object(self, filepath: str, key: str | None = None,
                   mass: float = 1.0, category: str = ""):
        """Mesh file -> processed graspable in the dataset (api.py:254-286)."""
        self._check_ds()
        proc = MeshProcessor(filepath, cache_dir=self.config["cache_dir"],
                             device=self.device)
        mesh, sdf, stable_poses = proc.generate_graspable(self.config)
        key = key or proc.key
        self.dataset.create_graspable(key, mesh=mesh, sdf=sdf,
                                      stable_poses=stable_poses, mass=mass,
                                      category=category)
        return key

    def list_objects(self):
        self._check_ds()
        return self.dataset.object_keys

    def delete_object(self, key: str):
        self._check_ds()
        self.dataset.delete_graspable(key)

    # ------------------------------------------------------------------
    def sample_grasps(self, key: str, gripper: Gripper | None = None,
                      target_num_grasps: int | None = None, seed: int = 0,
                      draws=None):
        """Antipodal sampling for one object (api.py:288-351 first half);
        each round takes ``draws.next_round()`` (default
        ``Draws(seed, device)``)."""
        from .grasping import samplers

        self._check_ds()
        gripper = gripper or Gripper()
        target = target_num_grasps or self.config["target_num_grasps"]
        sdf = self.dataset.sdf(key)
        if draws is None:
            draws = Draws(seed, self.device)

        fn = lambda d: samplers.antipodal_sample_grasps(
            sdf, d, max_width=gripper.max_width, min_width=gripper.min_width,
            friction_coef=self.config["friction_coef"])
        configs, _, _ = samplers.sample_until(fn, draws, 2 * target)
        return samplers.dedupe_grasps(np.asarray(configs),
                                      min_dist=0.0025)[:target]

    def compute_simulation_data(self, key: str, gripper: Gripper | None = None,
                                seed: int = 0, store: bool = True,
                                draws=None):
        """Sample + label grasps with the friction ladder + Ferrari-Canny and
        store them (api.py:288-351 == the dataset-generation path); the
        draws default to ``Draws(seed, device)``."""
        from .pipelines.generate_dataset import label_grasps_for_object

        self._check_ds()
        gripper = gripper or Gripper()
        sdf = self.dataset.sdf(key)
        com = self.dataset.mesh(key).center_of_mass()
        if draws is None:
            draws = Draws(seed, self.device)
        rows, counts, _ = label_grasps_for_object(
            sdf, com, gripper, draws,
            grasps_per_class=self.config["grasps_per_class"])
        if store and len(rows):
            self.dataset.store_grasps(
                key, rows[:, :10], gripper=gripper.name,
                metrics={"friction": rows[:, 10],
                         "robust_ferrari_canny": rows[:, 11]},
                force_overwrite=True)
        return rows, counts

    def get_grasps(self, key: str, gripper_name: str = "robotiq_85"):
        self._check_ds()
        return (self.dataset.grasps(key, gripper_name),
                self.dataset.grasp_metrics(key, gripper_name))

    # ------------------------------------------------------------------
    def export_objects(self, output_dir: str, scale: float = 1.0):
        """(api.py:600+): write every object's mesh as OBJ."""
        self._check_ds()
        os.makedirs(output_dir, exist_ok=True)
        return [self.dataset.obj_mesh_filename(k, scale=scale,
                                               output_dir=output_dir)
                for k in self.dataset.object_keys]

    def display_object(self, key: str, show: bool = False):
        """Matplotlib 3-D view (the reference uses mayavi, api.py:650+)."""
        from .visualization import plot_mesh

        self._check_ds()
        return plot_mesh(self.dataset.mesh(key), show=show)

    def display_grasps(self, key: str, gripper_name: str = "robotiq_85",
                       metric: str = "robust_ferrari_canny", show: bool = False):
        from .visualization import plot_grasps_3d

        self._check_ds()
        configs, metrics = self.get_grasps(key, gripper_name)
        return plot_grasps_3d(self.dataset.mesh(key), configs,
                              scores=metrics.get(metric), show=show)

    def display_stable_poses(self, key: str, show: bool = False):
        from .visualization import plot_stable_poses

        self._check_ds()
        return plot_stable_poses(self.dataset.mesh(key),
                                 self.dataset.stable_poses(key), show=show)
