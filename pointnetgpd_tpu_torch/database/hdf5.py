"""HDF5-backed object/grasp database.

Port of ``pointnetgpd_tpu/database/hdf5.py`` (reference:
dex-net/src/dexnet/database/database.py:82-789 + hdf5_factory.py) on the
same schema (``keys.py``): the same groups, attributes, dataset names,
dtypes and shapes, so a database written by either package reads in the
other. Objects carry mesh + SDF + mass + category + stable poses; grasps are
stored per gripper as configuration vectors with per-metric scores.

Storage is host work in both packages. The database's ``device`` is where
``sdf(key)`` puts the grid that the labeling path queries; arrays handed
to a ``store_*`` method may be numpy arrays or tensors on any device.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..constants import READ_ONLY_ACCESS, READ_WRITE_ACCESS  # noqa: F401 (canonical values)
from ..geometry.mesh import Mesh3D
from ..geometry.sdf import SdfGrid, make_sdf
from . import keys as K


def _host(a):
    """A numpy array of ``a`` in its own dtype (a tensor leaves its device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class Hdf5Database:
    """Top-level database: a set of named datasets (database.py:82-214)."""

    def __init__(self, database_filename: str,
                 access_level: str = READ_ONLY_ACCESS, device="cuda"):
        import h5py

        if not database_filename.endswith(".hdf5"):
            raise ValueError("database filename must end in .hdf5")
        self.filename = database_filename
        self.access_level = access_level
        self.device = device
        mode = "r" if access_level == READ_ONLY_ACCESS else "a"
        exists = os.path.exists(database_filename)
        if not exists and access_level == READ_ONLY_ACCESS:
            raise ValueError(f"database {database_filename} does not exist")
        self._f = h5py.File(database_filename, mode)
        if not exists:
            self._f.attrs[K.CREATION_KEY] = time.asctime()
            self._f.create_group(K.DATASETS_KEY)
        self._load_datasets()

    def _load_datasets(self):
        self.datasets = [
            Hdf5Dataset(name, self._f[K.DATASETS_KEY][name], self.device)
            for name in self._f[K.DATASETS_KEY].keys()
        ]

    @property
    def dataset_names(self):
        return [d.name for d in self.datasets]

    def dataset(self, name: str) -> "Hdf5Dataset":
        for d in self.datasets:
            if d.name == name:
                return d
        raise KeyError(name)

    def __getitem__(self, name):
        return self.dataset(name)

    def create_dataset(self, name: str, obj_keys=()) -> "Hdf5Dataset":
        group = self._f[K.DATASETS_KEY].create_group(name)
        group.create_group(K.OBJECTS_KEY)
        group.create_group(K.METRICS_KEY)
        ds = Hdf5Dataset(name, group, self.device)
        self.datasets.append(ds)
        return ds

    def delete_dataset(self, name: str):
        del self._f[K.DATASETS_KEY][name]
        self._load_datasets()

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


class Hdf5Dataset:
    """One dataset: objects with mesh/sdf/grasps/poses + metric configs
    (database.py:222-789)."""

    def __init__(self, name: str, group, device="cuda"):
        self.name = name
        self._g = group
        self.device = device

    # ------------------------------------------------------------------
    @property
    def _objects(self):
        return self._g[K.OBJECTS_KEY]

    @property
    def object_keys(self):
        return list(self._objects.keys())

    @property
    def num_objects(self):
        return len(self._objects)

    def __contains__(self, key):
        return key in self._objects

    def __iter__(self):
        return iter(self.object_keys)

    # ------------------------------------------------------------------
    def create_graspable(self, key: str, mesh: Mesh3D | None = None,
                         sdf: SdfGrid | None = None, stable_poses=None,
                         mass: float = 1.0, category: str = ""):
        """(database.py:453-499)."""
        obj = self._objects.create_group(key)
        obj.attrs[K.MASS_KEY] = mass
        obj.attrs[K.CATEGORY_KEY] = category
        obj.create_group(K.GRASPS_KEY)
        if mesh is not None:
            self.store_mesh(key, mesh)
        if sdf is not None:
            self.store_sdf(key, sdf)
        if stable_poses is not None:
            self.store_stable_poses(key, stable_poses)

    def delete_graspable(self, key: str):
        del self._objects[key]

    def store_mesh(self, key: str, mesh: Mesh3D, force_overwrite=False):
        obj = self._objects[key]
        if K.MESH_KEY in obj:
            if not force_overwrite:
                raise ValueError(f"mesh exists for {key}")
            del obj[K.MESH_KEY]
        g = obj.create_group(K.MESH_KEY)
        g.create_dataset(K.MESH_VERTICES_KEY, data=np.asarray(mesh.vertices))
        g.create_dataset(K.MESH_TRIANGLES_KEY, data=np.asarray(mesh.triangles))
        g.attrs[K.MESH_DENSITY_KEY] = mesh.density

    def store_sdf(self, key: str, sdf: SdfGrid, force_overwrite=False):
        obj = self._objects[key]
        if K.SDF_KEY in obj:
            if not force_overwrite:
                raise ValueError(f"sdf exists for {key}")
            del obj[K.SDF_KEY]
        g = obj.create_group(K.SDF_KEY)
        g.create_dataset(K.SDF_DATA_KEY, data=_host(sdf.data))
        g.create_dataset(K.SDF_ORIGIN_KEY, data=_host(sdf.origin))
        g.attrs[K.SDF_RES_KEY] = float(sdf.resolution)

    def store_stable_poses(self, key: str, poses, force_overwrite=False):
        """(database.py:564-583); poses: list of {p, r, x0} dicts."""
        obj = self._objects[key]
        if K.STP_KEY in obj:
            if not force_overwrite:
                raise ValueError(f"stable poses exist for {key}")
            del obj[K.STP_KEY]
        g = obj.create_group(K.STP_KEY)
        g.attrs[K.NUM_STP_KEY] = len(poses)
        for i, pose in enumerate(poses):
            pg = g.create_group(f"pose_{i}")
            pg.attrs[K.STABLE_POSE_PROB_KEY] = float(pose["p"])
            pg.create_dataset(K.STABLE_POSE_ROT_KEY, data=np.asarray(pose["r"]))
            pg.create_dataset(K.STABLE_POSE_PT_KEY, data=np.asarray(pose["x0"]))

    # ------------------------------------------------------------------
    def mesh(self, key: str) -> Mesh3D:
        g = self._objects[key][K.MESH_KEY]
        return Mesh3D(np.asarray(g[K.MESH_VERTICES_KEY]),
                      np.asarray(g[K.MESH_TRIANGLES_KEY], np.int32),
                      float(g.attrs.get(K.MESH_DENSITY_KEY, 1.0)))

    def sdf(self, key: str) -> SdfGrid:
        """The object's SDF on the database's device."""
        g = self._objects[key][K.SDF_KEY]
        return make_sdf(np.asarray(g[K.SDF_DATA_KEY]),
                        np.asarray(g[K.SDF_ORIGIN_KEY]),
                        float(g.attrs[K.SDF_RES_KEY]), device=self.device)

    def mass(self, key: str) -> float:
        return float(self._objects[key].attrs[K.MASS_KEY])

    def category(self, key: str) -> str:
        return str(self._objects[key].attrs.get(K.CATEGORY_KEY, ""))

    def stable_poses(self, key: str):
        g = self._objects[key][K.STP_KEY]
        poses = []
        for i in range(int(g.attrs[K.NUM_STP_KEY])):
            pg = g[f"pose_{i}"]
            poses.append({"p": float(pg.attrs[K.STABLE_POSE_PROB_KEY]),
                          "r": np.asarray(pg[K.STABLE_POSE_ROT_KEY]),
                          "x0": np.asarray(pg[K.STABLE_POSE_PT_KEY])})
        return poses

    # ------------------------------------------------------------------
    def store_grasps(self, key: str, configurations, gripper: str = "gripper",
                     metrics: dict | None = None, force_overwrite=False):
        """(database.py:930+ analogue): (N, 10) configurations + optional
        {metric_name: (N,) scores}."""
        grasps_group = self._objects[key][K.GRASPS_KEY]
        if gripper in grasps_group:
            if not force_overwrite:
                raise ValueError(f"grasps exist for {key}/{gripper}")
            del grasps_group[gripper]
        g = grasps_group.create_group(gripper)
        configurations = _host(configurations)
        g.attrs[K.NUM_GRASPS_KEY] = len(configurations)
        g.create_dataset(K.GRASP_CONFIGURATION_KEY, data=configurations)
        g.attrs[K.GRASP_TIMESTAMP_KEY] = time.asctime()
        mg = g.create_group(K.GRASP_METRICS_KEY)
        for name, vals in (metrics or {}).items():
            mg.create_dataset(name, data=_host(vals))

    def grasps(self, key: str, gripper: str = "gripper"):
        g = self._objects[key][K.GRASPS_KEY][gripper]
        return np.asarray(g[K.GRASP_CONFIGURATION_KEY])

    def grasp_metrics(self, key: str, gripper: str = "gripper"):
        mg = self._objects[key][K.GRASPS_KEY][gripper][K.GRASP_METRICS_KEY]
        return {name: np.asarray(mg[name]) for name in mg.keys()}

    def has_grasps(self, key: str, gripper: str = "gripper") -> bool:
        return gripper in self._objects[key][K.GRASPS_KEY]

    def delete_grasps(self, key: str, gripper: str = "gripper"):
        del self._objects[key][K.GRASPS_KEY][gripper]

    # ------------------------------------------------------------------
    def store_convex_pieces(self, key: str, pieces, force_overwrite=False):
        """(database.py:531-563): store convex-decomposition piece meshes."""
        obj = self._objects[key]
        if K.CONVEX_PIECES_KEY in obj:
            if not force_overwrite:
                raise ValueError(f"convex pieces exist for {key}")
            del obj[K.CONVEX_PIECES_KEY]
        g = obj.create_group(K.CONVEX_PIECES_KEY)
        g.attrs["num_pieces"] = len(pieces)
        for i, piece in enumerate(pieces):
            pg = g.create_group(f"piece_{i}")
            pg.create_dataset(K.MESH_VERTICES_KEY,
                              data=np.asarray(piece.vertices))
            pg.create_dataset(K.MESH_TRIANGLES_KEY,
                              data=np.asarray(piece.triangles))

    def convex_pieces(self, key: str):
        """(database.py:760-788)."""
        g = self._objects[key][K.CONVEX_PIECES_KEY]
        return [
            Mesh3D(np.asarray(g[f"piece_{i}"][K.MESH_VERTICES_KEY]),
                   np.asarray(g[f"piece_{i}"][K.MESH_TRIANGLES_KEY], np.int32))
            for i in range(int(g.attrs["num_pieces"]))
        ]

    def store_rendered_images(self, key: str, images, stable_pose_id: str = "",
                              image_type: str = "depth",
                              force_overwrite=False):
        """Rendered image stacks per object[/stable pose]
        (database.py:340-350 accessors + hdf5_factory serializers)."""
        obj = self._objects[key]
        group_name = K.RENDERED_IMAGES_KEY + (
            f"_{stable_pose_id}" if stable_pose_id else "")
        if group_name in obj:
            if not force_overwrite:
                raise ValueError(f"rendered images exist for {key}")
            del obj[group_name]
        g = obj.create_group(group_name)
        g.attrs["image_type"] = image_type
        g.create_dataset("images", data=np.stack([_host(im) for im in images]))

    def rendered_images(self, key: str, stable_pose_id: str = ""):
        group_name = K.RENDERED_IMAGES_KEY + (
            f"_{stable_pose_id}" if stable_pose_id else "")
        g = self._objects[key][group_name]
        return np.asarray(g["images"]), str(g.attrs["image_type"])

    # ------------------------------------------------------------------
    def create_metadata(self, name: str, attrs: dict):
        """Dataset-level metadata definitions (database.py:298-311)."""
        if "metadata" not in self._g:
            self._g.create_group("metadata")
        mg = self._g["metadata"].create_group(name)
        for k, v in attrs.items():
            mg.attrs[k] = v

    @property
    def metadata_names(self):
        return list(self._g["metadata"].keys()) if "metadata" in self._g else []

    def object_metadata(self, key: str) -> dict:
        """Per-object metadata values stored as attributes."""
        obj = self._objects[key]
        return {k: obj.attrs[k] for k in obj.attrs}

    def set_object_metadata(self, key: str, name: str, value):
        self._objects[key].attrs[name] = value

    # ------------------------------------------------------------------
    def create_metric(self, metric_name: str, metric_config: dict):
        """(database.py:789-822): store a metric config as attrs."""
        mg = self._g[K.METRICS_KEY].create_group(metric_name)
        for k, v in metric_config.items():
            if isinstance(v, dict):
                sub = mg.create_group(k)
                for k2, v2 in v.items():
                    sub.attrs[k2] = v2
            else:
                mg.attrs[k] = v

    @property
    def metric_names(self):
        return list(self._g[K.METRICS_KEY].keys())

    def metric(self, metric_name: str) -> dict:
        mg = self._g[K.METRICS_KEY][metric_name]
        out = dict(mg.attrs)
        for k in mg.keys():
            out[k] = dict(mg[k].attrs)
        return out

    def has_metric(self, metric_name: str) -> bool:
        return metric_name in self._g[K.METRICS_KEY]

    def delete_metric(self, metric_name: str):
        del self._g[K.METRICS_KEY][metric_name]

    # ------------------------------------------------------------------
    def obj_mesh_filename(self, key: str, scale: float = 1.0,
                          output_dir: str = ".", overwrite=False) -> str:
        """Export the mesh to OBJ (database.py:635-667)."""
        from ..geometry.io import write_obj

        path = os.path.join(output_dir, f"{key}.obj")
        if overwrite or not os.path.exists(path):
            mesh = self.mesh(key).rescale(scale)
            write_obj(path, mesh.vertices, mesh.triangles)
        return path
