"""Virtual cameras + viewsphere pose grids over the native renderer.

Re-design of the reference camera stack (reference:
meshpy/meshpy/mesh_renderer.py:24-764): ``ViewsphereDiscretizer`` enumerates
camera poses on a sphere around the object (radius x elevation x azimuth x
roll grid), ``VirtualCamera.images()`` renders depth / shaded color /
segmask per pose through the native rasterizer, and ``SceneObject`` adds
static extra geometry (e.g. a table).

A copy of ``pointnetgpd_tpu/render/camera.py`` over the port's ``Mesh3D``
and its own rasterizer binding (``render/native.py``); the rendering runs
on the host, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..geometry.mesh import Mesh3D
from .native import render_mesh


class RenderMode:
    """(reference: meshpy/meshpy/render_modes.py:5-18)."""

    SEGMASK = "segmask"
    DEPTH = "depth"
    SCALED_DEPTH = "scaled_depth"
    COLOR = "color"
    GRAYSCALE = "gray"
    DEPTH_SCENE = "depth_scene"


@dataclass(frozen=True)
class CameraIntrinsics:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def k(self) -> np.ndarray:
        return np.array([[self.fx, 0, self.cx],
                         [0, self.fy, self.cy],
                         [0, 0, 1.0]])


@dataclass
class SceneObject:
    """Static extra geometry rendered alongside the target
    (mesh_renderer.py:377+)."""

    mesh: Mesh3D
    t_obj_world: np.ndarray  # 4x4


def look_at_pose(camera_center, target=np.zeros(3), up=np.array([0, 0, 1.0])):
    """4x4 world->camera transform for a camera at ``camera_center`` looking
    at ``target`` (z forward, x right, y down: OpenCV convention)."""
    z = np.asarray(target, float) - np.asarray(camera_center, float)
    z = z / max(np.linalg.norm(z), 1e-12)
    x = np.cross(z, up)
    if np.linalg.norm(x) < 1e-8:
        x = np.cross(z, np.array([0, 1.0, 0]))
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    rot = np.stack([x, y, z])         # rows: camera axes in world coords
    t = np.eye(4)
    t[:3, :3] = rot
    t[:3, 3] = -rot @ np.asarray(camera_center, float)
    return t


class ViewsphereDiscretizer:
    """Grid of camera poses on a view sphere (mesh_renderer.py:24-176):
    radii x elevations x azimuths (x rolls) around the object origin."""

    def __init__(self, min_radius: float, max_radius: float, num_radii: int,
                 min_elev: float = 0.0, max_elev: float = np.pi / 2,
                 num_elev: int = 4, num_az: int = 8, num_roll: int = 1):
        self.radii = np.linspace(min_radius, max_radius, num_radii)
        self.elevs = np.linspace(min_elev, max_elev, num_elev)
        self.azimuths = np.linspace(0, 2 * np.pi, num_az, endpoint=False)
        self.rolls = np.linspace(0, 2 * np.pi, num_roll, endpoint=False)

    def object_to_camera_poses(self):
        """List of (T_world_camera 4x4, camera_center (3,)) pose samples."""
        poses = []
        for r in self.radii:
            for elev in self.elevs:
                for az in self.azimuths:
                    center = r * np.array([
                        np.cos(az) * np.cos(elev),
                        np.sin(az) * np.cos(elev),
                        np.sin(elev),
                    ])
                    # avoid exact degeneracy at the pole
                    if abs(elev - np.pi / 2) < 1e-9:
                        center = center + np.array([1e-6, 0, 0])
                    for roll in self.rolls:
                        t = look_at_pose(center)
                        if roll != 0.0:
                            c, s = np.cos(roll), np.sin(roll)
                            rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
                            t[:3, :] = rz @ t[:3, :]
                        poses.append((t, center))
        return poses


class VirtualCamera:
    """Renders a mesh from camera poses (mesh_renderer.py:439-560)."""

    def __init__(self, intrinsics: CameraIntrinsics):
        self.intrinsics = intrinsics

    def images(self, mesh: Mesh3D, camera_poses, render_mode: str = RenderMode.DEPTH,
               scene_objects=()):
        """Render ``mesh`` (+ scene objects) for each (T_world_camera,
        camera_center) pose. Returns a list of images per the render mode
        (SEGMASK -> uint8 mask, DEPTH -> float32 depth, COLOR/GRAYSCALE ->
        float32 shaded intensity)."""
        verts = [np.asarray(mesh.vertices, float)]
        tris = [np.asarray(mesh.triangles, np.int32)]
        offset = len(mesh.vertices)
        for so in scene_objects:
            v = np.asarray(so.mesh.vertices, float)
            v = v @ so.t_obj_world[:3, :3].T + so.t_obj_world[:3, 3]
            verts.append(v)
            tris.append(np.asarray(so.mesh.triangles, np.int32) + offset)
            offset += len(v)
        verts = np.concatenate(verts)
        tris = np.concatenate(tris)

        k = self.intrinsics.k
        out = []
        for t_wc, center in camera_poses:
            proj = k @ t_wc[:3, :]
            depth, color, mask = render_mesh(
                proj, center, self.intrinsics.width, self.intrinsics.height,
                verts, tris)
            if render_mode == RenderMode.SEGMASK:
                out.append(mask)
            elif render_mode in (RenderMode.DEPTH, RenderMode.DEPTH_SCENE,
                                 RenderMode.SCALED_DEPTH):
                out.append(depth)
            else:
                out.append(color)
        return out

    def images_viewsphere(self, mesh: Mesh3D, vs_disc: ViewsphereDiscretizer,
                          render_mode: str = RenderMode.DEPTH):
        """(mesh_renderer.py:560+): render every viewsphere pose."""
        return self.images(mesh, vs_disc.object_to_camera_poses(), render_mode)
