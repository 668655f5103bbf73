"""Geometry core: SDF grids (torch), triangle meshes, file IO, stable poses;
the names of ``pointnetgpd_tpu/geometry/__init__.py``."""

from .decomposition import approximate_convex_decomposition
from .io import read_obj, read_off, read_sdf, write_obj, write_sdf
from .mesh import Mesh3D
from .sdf import (
    SdfGrid,
    gradient,
    grid_to_world,
    make_sdf,
    on_surface,
    signed_distance,
    surface_normal,
    world_to_grid,
)
from .stable_pose import StablePose, read_stp, write_stp

__all__ = [s for s in dir() if not s.startswith("_")]
