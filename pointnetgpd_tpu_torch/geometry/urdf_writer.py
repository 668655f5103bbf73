"""URDF export + convex decomposition.

Port of ``pointnetgpd_tpu/geometry/urdf_writer.py``. Re-design of the
reference writer (reference: meshpy/meshpy/urdf_writer.py:76-280:
``convex_decomposition`` via trimesh's vhacd binding and UrdfWriter
exporting per-piece OBJs + a URDF). The vhacd binary is replaced by a
native voxel-based approximate convex decomposition
(:mod:`pointnetgpd_tpu_torch.geometry.decomposition`: voxelization through
kernel K3 on CUDA, greedy plane splitting on the host), which returns one
convex hull for convex inputs and multiple pieces for concave ones.

One deliberate difference from the JAX package, which falls back to the
convex hull on any exception of the decomposition: here only qhull's own
failure on a cluster (``scipy.spatial.QhullError``) falls back. Every error
of the voxelization (``mesh_to_sdf``, the kernel's build, launch and
argument checks) propagates, so that a failing kernel is never hidden
behind a hull.
"""

from __future__ import annotations

import os
from xml.etree import ElementTree as ET
from xml.dom import minidom

from .io import write_obj
from .mesh import Mesh3D


def convex_decomposition(mesh: Mesh3D, device="cuda", **kwargs):
    """(urdf_writer.py:76): list of convex pieces via the native voxel-based
    splitter (vhacd replacement) on ``device``. kwargs forward to
    :func:`approximate_convex_decomposition` (max_pieces, concavity_tol,
    dim); falls back to the single convex hull where qhull fails on a
    cluster, and on nothing else."""
    from scipy.spatial import QhullError

    from .decomposition import approximate_convex_decomposition

    try:
        return approximate_convex_decomposition(mesh, device=device, **kwargs)
    except QhullError:
        return [mesh.convex_hull()]


class UrdfWriter:
    """(urdf_writer.py:137-280): write a URDF with one link per convex piece."""

    def __init__(self, output_dir: str, device="cuda"):
        self.output_dir = output_dir
        self.device = device
        os.makedirs(output_dir, exist_ok=True)

    def write(self, mesh: Mesh3D, name: str | None = None,
              pieces=None) -> str:
        name = name or os.path.basename(self.output_dir.rstrip("/"))
        pieces = (pieces if pieces is not None
                  else convex_decomposition(mesh, device=self.device))

        robot = ET.Element("robot", name=name)
        prev_link = None
        for i, piece in enumerate(pieces):
            obj_name = f"{name}_piece_{i}.obj"
            write_obj(os.path.join(self.output_dir, obj_name),
                      piece.vertices, piece.triangles)
            link = ET.SubElement(robot, "link", name=f"link_{i}")
            inertial = ET.SubElement(link, "inertial")
            ET.SubElement(inertial, "origin", xyz="0 0 0", rpy="0 0 0")
            ET.SubElement(inertial, "mass", value=str(piece.mass()))
            inertia = piece.inertia()
            ET.SubElement(
                inertial, "inertia",
                ixx=str(inertia[0, 0]), ixy=str(inertia[0, 1]),
                ixz=str(inertia[0, 2]), iyy=str(inertia[1, 1]),
                iyz=str(inertia[1, 2]), izz=str(inertia[2, 2]))
            for tag in ("visual", "collision"):
                el = ET.SubElement(link, tag)
                ET.SubElement(el, "origin", xyz="0 0 0", rpy="0 0 0")
                geom = ET.SubElement(el, "geometry")
                ET.SubElement(geom, "mesh", filename=obj_name,
                              scale="1 1 1")
            if prev_link is not None:
                joint = ET.SubElement(robot, "joint",
                                      name=f"joint_{i}", type="fixed")
                ET.SubElement(joint, "parent", link=prev_link)
                ET.SubElement(joint, "child", link=f"link_{i}")
            prev_link = f"link_{i}"

        urdf_path = os.path.join(self.output_dir, f"{name}.urdf")
        xml = minidom.parseString(ET.tostring(robot)).toprettyxml(indent="  ")
        with open(urdf_path, "w") as f:
            f.write(xml)
        return urdf_path
