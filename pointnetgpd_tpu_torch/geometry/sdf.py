"""Signed-distance-field grid on a torch device.

Port of ``pointnetgpd_tpu/geometry/sdf.py`` (reference: meshpy/meshpy/
sdf.py:205-766) for the object-preparation path: the grid container, its
host-side constructor, coordinate maps, trilinear lookup with the
reference's out-of-bounds fallback, and rescaling. ``gradient``,
``surface_normal``, ``curvature`` and ``transform_dense`` come with the
labeling path.

Semantics mirrored from the reference:
- trilinear interpolation with zero contribution from out-of-grid corners
  (sdf.py:318-339);
- out-of-bounds queries fall back to distance-to-nearest-surface-point plus
  the SDF value there (sdf.py:299-306), over all surface points;
- surface threshold ``resolution * sqrt(2) / 2`` (sdf.py:223);
- grid <-> world: world = origin + resolution * grid (sdf.py:243-249).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SdfGrid(NamedTuple):
    """SDF grid whose tensors live on one device. Build with ``make_sdf``."""

    data: torch.Tensor            # (nx, ny, nz) signed distances (world units)
    origin: torch.Tensor          # (3,) world position of grid index (0,0,0)
    resolution: torch.Tensor      # () world units per cell
    gradients: torch.Tensor       # (3, nx, ny, nz) central differences (np.gradient)
    surface_points: torch.Tensor  # (S, 3) float grid coords of surface cells
    surface_vals: torch.Tensor    # (S,) sdf values at those cells

    @property
    def dims(self):
        return tuple(self.data.shape)

    @property
    def surface_thresh(self):
        return self.resolution * np.sqrt(2) / 2.0


def make_sdf(data, origin, resolution, device="cuda") -> SdfGrid:
    """Host-side precompute (gradients, surface cells) of a grid (an array
    or a tensor on any device), then move it to ``device``."""
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    data = np.asarray(data, dtype=np.float32)
    thresh = float(resolution) * np.sqrt(2) / 2.0
    sx, sy, sz = np.where(np.abs(data) < thresh)
    surface = np.stack([sx, sy, sz], axis=1).astype(np.float32)
    vals = data[sx, sy, sz]
    grads = np.stack(np.gradient(data), axis=0).astype(np.float32)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return SdfGrid(
        data=dev(data),
        origin=dev(np.asarray(origin, np.float32)),
        resolution=dev(np.float32(resolution)),
        gradients=dev(grads),
        surface_points=dev(surface),
        surface_vals=dev(vals),
    )


def grid_to_world(sdf: SdfGrid, coords):
    return sdf.origin + sdf.resolution * coords


def world_to_grid(sdf: SdfGrid, points):
    return (points - sdf.origin) / sdf.resolution


def is_out_of_bounds(sdf: SdfGrid, coords):
    """coords: (..., 3) grid coords -> (...) bool (sdf.py:176-190)."""
    dims = torch.tensor(sdf.dims, dtype=coords.dtype, device=coords.device)
    return torch.any((coords < 0) | (coords >= dims), dim=-1)


def _trilinear(volume, coords, dims):
    """Trilinear interp of (nx,ny,nz) volume at (..., 3) float coords; corner
    samples outside the grid contribute zero (sdf.py:330-337)."""
    top = torch.tensor(dims, dtype=coords.dtype, device=coords.device) - 1.0
    c = torch.minimum(torch.clamp(coords, min=0.0), top)
    lo = torch.floor(c)
    frac = c - lo
    out = torch.zeros(coords.shape[:-1], dtype=volume.dtype,
                      device=volume.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                corner = lo + torch.tensor([dx, dy, dz], dtype=coords.dtype,
                                           device=coords.device)
                inb = torch.all((corner >= 0) & (corner <= top), dim=-1)
                ci = torch.minimum(torch.clamp(corner, min=0), top).to(
                    torch.int64)
                v = volume[ci[..., 0], ci[..., 1], ci[..., 2]]
                w = ((frac[..., 0] if dx else 1.0 - frac[..., 0])
                     * (frac[..., 1] if dy else 1.0 - frac[..., 1])
                     * (frac[..., 2] if dz else 1.0 - frac[..., 2]))
                out = out + torch.where(inb, w, 0.0) * v
    return out


def signed_distance(sdf: SdfGrid, coords):
    """Interpolated SDF at (..., 3) float grid coords, with the reference's
    out-of-bounds fallback (sdf.py:277-339)."""
    inside_val = _trilinear(sdf.data, coords, sdf.dims)
    flat = coords.reshape(-1, 3)
    d2 = torch.sum((flat[:, None, :] - sdf.surface_points[None, :, :]) ** 2,
                   dim=-1)
    nearest = torch.argmin(d2, dim=1)
    dist_world = torch.sqrt(torch.gather(d2, 1, nearest[:, None]))[:, 0]
    oob_val = (dist_world * sdf.resolution
               + sdf.surface_vals[nearest]).reshape(coords.shape[:-1])
    return torch.where(is_out_of_bounds(sdf, coords), oob_val, inside_val)


def signed_distance_fast(sdf: SdfGrid, coords):
    """Clamped trilinear lookup without the out-of-bounds scan."""
    return _trilinear(sdf.data, coords, sdf.dims)


def rescale(sdf: SdfGrid, scale: float) -> SdfGrid:
    """Rescale the SDF by a scale factor (sdf.py:575+): world distances and
    resolution scale linearly."""
    return make_sdf(sdf.data.cpu().numpy() * scale,
                    sdf.origin.cpu().numpy() * scale,
                    float(sdf.resolution) * scale, device=sdf.data.device)
