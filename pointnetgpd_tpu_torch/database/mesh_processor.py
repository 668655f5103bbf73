"""Mesh file -> cleaned/rescaled mesh + SDF + stable poses.

Port of ``pointnetgpd_tpu/database/mesh_processor.py`` (reference:
dex-net/src/dexnet/database/mesh_processor.py:40-342): load, clean, rescale
(RescalingType min/med/max/diag/relative), generate the SDF and stable poses,
with cached ``_proc.obj``/``.sdf`` intermediates. The SDF step runs the
voxelizer (``ops/mesh_to_sdf.py``, kernel K3 on CUDA) instead of the
external SDFGen binary.
"""

from __future__ import annotations

import os

from ..constants import OBJ_EXT, PROC_TAG, SDF_EXT
from ..geometry.io import read_obj, read_off, read_sdf, write_obj, write_sdf
from ..geometry.mesh import Mesh3D


class RescalingType:
    """(mesh_processor.py:40-48)."""

    FIT_MIN_DIM = "min"
    FIT_MED_DIM = "med"
    FIT_MAX_DIM = "max"
    FIT_DIAG = "diag"
    RELATIVE = "relative"


class MeshProcessor:
    def __init__(self, filename: str, cache_dir: str = ".dexnet",
                 device="cuda"):
        self.filename = filename
        self.cache_dir = cache_dir
        self.device = device
        self.key = os.path.splitext(os.path.basename(filename))[0]
        os.makedirs(cache_dir, exist_ok=True)
        self.mesh: Mesh3D | None = None
        self.sdf = None
        self.stable_poses_ = None

    @property
    def obj_filename(self):
        return os.path.join(self.cache_dir, self.key + PROC_TAG + OBJ_EXT)

    @property
    def sdf_filename(self):
        return os.path.join(self.cache_dir, self.key + SDF_EXT)

    def generate_graspable(self, config: dict | None = None):
        """Full pipeline (mesh_processor.py:76-122): load -> clean -> rescale
        -> SDF -> stable poses. config keys (reference names): obj_scale /
        obj_target_scale / obj_rescaling_type, sdf_dim, sdf_padding,
        stp_min_prob, use_cache."""
        config = config or {}
        self._load_mesh()
        self._clean_mesh(config)
        self._rescale_mesh(config)
        write_obj(self.obj_filename, self.mesh.vertices, self.mesh.triangles)
        self._generate_sdf(config)
        self._generate_stable_poses(config)
        return self.mesh, self.sdf, self.stable_poses_

    def _load_mesh(self):
        ext = os.path.splitext(self.filename)[1].lower()
        if ext == ".obj":
            v, f = read_obj(self.filename)
        elif ext == ".off":
            v, f = read_off(self.filename)
        else:
            raise ValueError(f"unsupported mesh format {ext}")
        self.mesh = Mesh3D(v, f)
        return self.mesh

    def _clean_mesh(self, config):
        self.mesh = (self.mesh.remove_bad_tris()
                     .remove_unreferenced_vertices())

    def _rescale_mesh(self, config):
        scale = config.get("obj_scale", 1.0)
        target = config.get("obj_target_scale")
        mode = config.get("obj_rescaling_type", RescalingType.FIT_MAX_DIM)
        if target is not None and mode != RescalingType.RELATIVE:
            self.mesh = self.mesh.rescale_dimension(target, mode)
        elif scale != 1.0:
            self.mesh = self.mesh.rescale(scale)

    def _generate_sdf(self, config):
        # a cached .sdf newer than the source mesh is read back, not rebuilt
        if os.path.exists(self.sdf_filename) and config.get("use_cache", True) \
                and os.path.getmtime(self.sdf_filename) > os.path.getmtime(self.filename):
            self.sdf = read_sdf(self.sdf_filename, device=self.device)
            return self.sdf
        from ..ops.mesh_to_sdf import mesh_to_sdf

        self.sdf = mesh_to_sdf(self.mesh, dim=config.get("sdf_dim", 100),
                               padding=config.get("sdf_padding", 5),
                               device=self.device)
        write_sdf(self.sdf_filename, self.sdf)
        return self.sdf

    def _generate_stable_poses(self, config):
        self.stable_poses_ = self.mesh.stable_poses(
            min_prob=config.get("stp_min_prob", 0.0))
        return self.stable_poses_
