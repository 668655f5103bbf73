"""Graspable object container: SDF + mesh (+ key/mass).

Port of ``pointnetgpd_tpu/grasping/graspable_object.py`` (reference:
dex-net/src/dexnet/grasping/graspable_object.py:40-231 — GraspableObject3D
bundles Sdf3D + Mesh3D with moment_arm/rescale/transform helpers).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..geometry.mesh import Mesh3D
from ..geometry.sdf import SdfGrid, make_sdf, rescale as sdf_rescale


@dataclass
class GraspableObject3D:
    sdf: SdfGrid
    mesh: Mesh3D
    key: str = ""
    model_name: str = ""
    mass: float = 1.0

    @property
    def center_of_mass(self) -> np.ndarray:
        return self.mesh.center_of_mass()

    def moment_arm(self, x) -> np.ndarray:
        """(graspable_object.py:125-137)."""
        return np.asarray(x) - self.center_of_mass

    def rescale(self, scale: float) -> "GraspableObject3D":
        """(graspable_object.py:139-163)."""
        return GraspableObject3D(sdf_rescale(self.sdf, scale),
                                 self.mesh.rescale(scale), self.key,
                                 self.model_name, self.mass)

    def transform(self, t_4x4) -> "GraspableObject3D":
        """(graspable_object.py:165-189): transform the mesh; the SDF grid is
        axis-aligned, so a pure translation moves its origin and any rotation
        re-voxelizes the moved mesh (``ops/mesh_to_sdf.py``, kernel K3 on
        CUDA) on the SDF's device."""
        t = np.asarray(t_4x4)
        new_mesh = self.mesh.transform(t)
        dev = self.sdf.data.device
        if np.allclose(t[:3, :3], np.eye(3)):
            new_sdf = make_sdf(self.sdf.data,
                               self.sdf.origin.cpu().numpy() + t[:3, 3],
                               float(self.sdf.resolution), device=dev)
        else:
            from ..ops.mesh_to_sdf import mesh_to_sdf

            new_sdf = mesh_to_sdf(new_mesh, dim=self.sdf.data.shape[0],
                                  device=dev)
        return GraspableObject3D(new_sdf, new_mesh, self.key,
                                 self.model_name, self.mass)
