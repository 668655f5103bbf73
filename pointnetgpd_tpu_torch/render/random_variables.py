"""Camera-pose random variables for domain randomization.

(reference: meshpy/meshpy/random_variables.py:45-510 —
CameraSample/UniformViewsphereRandomVariable/UniformPlanarWorksurfaceRandomVariable
draw random camera poses on a viewsphere or above a work surface and render
images through the virtual camera.)

A copy of ``pointnetgpd_tpu/render/random_variables.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .camera import CameraIntrinsics, RenderMode, VirtualCamera, look_at_pose


@dataclass
class UniformViewsphereRandomVariable:
    """Uniform camera poses on a spherical shell around the origin
    (random_variables.py:45-155)."""

    min_radius: float
    max_radius: float
    min_elev: float = 0.0
    max_elev: float = np.pi / 2
    min_az: float = 0.0
    max_az: float = 2 * np.pi

    def sample(self, size: int = 1, rng=None):
        rng = rng or np.random.RandomState()
        poses = []
        for _ in range(size):
            r = rng.uniform(self.min_radius, self.max_radius)
            elev = rng.uniform(self.min_elev, self.max_elev)
            az = rng.uniform(self.min_az, self.max_az)
            center = r * np.array([np.cos(az) * np.cos(elev),
                                   np.sin(az) * np.cos(elev),
                                   np.sin(elev)])
            poses.append((look_at_pose(center), center))
        return poses


@dataclass
class UniformPlanarWorksurfaceRandomVariable:
    """Uniform camera poses over a planar work surface: radius/elevation
    about a target point jittered in the plane (random_variables.py:157-388)."""

    min_radius: float
    max_radius: float
    min_elev: float
    max_elev: float
    min_x: float = -0.1
    max_x: float = 0.1
    min_y: float = -0.1
    max_y: float = 0.1

    def sample(self, size: int = 1, rng=None):
        rng = rng or np.random.RandomState()
        poses = []
        for _ in range(size):
            target = np.array([rng.uniform(self.min_x, self.max_x),
                               rng.uniform(self.min_y, self.max_y), 0.0])
            r = rng.uniform(self.min_radius, self.max_radius)
            elev = rng.uniform(self.min_elev, self.max_elev)
            az = rng.uniform(0, 2 * np.pi)
            center = target + r * np.array([np.cos(az) * np.cos(elev),
                                            np.sin(az) * np.cos(elev),
                                            np.sin(elev)])
            poses.append((look_at_pose(center, target=target), center))
        return poses


@dataclass
class RenderedImageRandomVariable:
    """Rendered images under random camera poses
    (random_variables.py:389-510)."""

    mesh: object
    intrinsics: CameraIntrinsics
    pose_rv: object
    render_mode: str = RenderMode.DEPTH

    def sample(self, size: int = 1, rng=None):
        cam = VirtualCamera(self.intrinsics)
        poses = self.pose_rv.sample(size, rng)
        return cam.images(self.mesh, poses, self.render_mode)
