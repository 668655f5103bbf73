"""Signed-distance-field grid on a torch device.

Port of ``pointnetgpd_tpu/geometry/sdf.py`` (reference: meshpy/meshpy/
sdf.py:205-766) for the object-preparation path: the grid container, its
host-side constructor, coordinate maps, trilinear lookup with the
reference's out-of-bounds fallback and rescaling; and for the labeling
path, the gradient, curvature and surface-normal queries and the dense
rigid resampling. Every query is batched over leading dimensions of its
(..., 3) coordinates.

Semantics mirrored from the reference:
- trilinear interpolation with zero contribution from out-of-grid corners
  (sdf.py:318-339);
- out-of-bounds queries fall back to distance-to-nearest-surface-point plus
  the SDF value there (sdf.py:299-306), over all surface points;
- surface threshold ``resolution * sqrt(2) / 2`` (sdf.py:223);
- surface normal by a plane fit over the <=26-neighborhood sphere-projected
  surface samples, oriented outward by an SDF probe (sdf.py:466-546);
- grid <-> world: world = origin + resolution * grid (sdf.py:243-249).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.fp import fma, norm3, sqrt


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
        resolution=torch.tensor(np.float32(resolution), device=device),
        gradients=dev(grads),
        surface_points=dev(surface),
        surface_vals=dev(vals),
    )


def grid_to_world(sdf: SdfGrid, coords):
    """origin + resolution * coords, rounded once (an FMA) as XLA fuses it
    into the labeling programs."""
    return fma(sdf.resolution, coords, sdf.origin)


def world_to_grid(sdf: SdfGrid, points):
    return (points - sdf.origin) / sdf.resolution


def grid_to_world_dir(sdf: SdfGrid, direction):
    """Direction vectors only rotate (identity here), unit-normalized."""
    return direction / norm3(direction)[..., None]


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
                # NaN coords read cell 0 with weight 0, as XLA converts NaN
                ci = torch.nan_to_num(torch.minimum(
                    torch.clamp(corner, min=0), top), nan=0.0).to(torch.int64)
                v = volume[ci[..., 0], ci[..., 1], ci[..., 2]]
                w = ((frac[..., 0] if dx else 1.0 - frac[..., 0])
                     * (frac[..., 1] if dy else 1.0 - frac[..., 1])
                     * (frac[..., 2] if dz else 1.0 - frac[..., 2]))
                out = out + torch.where(inb, w, 0.0) * v
    return out


# (query, surface cell) pairs per chunk of the out-of-bounds scan
_OOB_PAIRS = 1 << 24


def signed_distance(sdf: SdfGrid, coords):
    """Interpolated SDF at (..., 3) float grid coords, with the reference's
    out-of-bounds fallback (sdf.py:277-339), its nearest-surface scan in
    query chunks."""
    inside_val = _trilinear(sdf.data, coords, sdf.dims)
    flat = coords.reshape(-1, 3)
    n_surf = max(int(sdf.surface_points.shape[0]), 1)
    step = max(1, _OOB_PAIRS // n_surf)
    parts = []
    for c0 in range(0, flat.shape[0], step):
        d2 = torch.sum((flat[c0:c0 + step, None, :]
                        - sdf.surface_points[None, :, :]) ** 2, dim=-1)
        nearest = torch.argmin(d2, dim=1)
        dist_world = sqrt(torch.gather(d2, 1, nearest[:, None]))[:, 0]
        parts.append(dist_world * sdf.resolution + sdf.surface_vals[nearest])
    oob_val = (torch.cat(parts) if parts else flat[:, 0]).reshape(
        coords.shape[:-1])
    return torch.where(is_out_of_bounds(sdf, coords), oob_val, inside_val)


def signed_distance_fast(sdf: SdfGrid, coords):
    """Clamped trilinear lookup without the out-of-bounds scan."""
    return _trilinear(sdf.data, coords, sdf.dims)


def signed_distance_oob_big(sdf: SdfGrid, coords):
    """Trilinear lookup with out-of-bounds queries mapped to a large positive
    value (definitely not on the surface): the contact-search and normal
    queries only ever ask the fallback "is this a surface point"."""
    val = _trilinear(sdf.data, coords, sdf.dims)
    big = 1e3 * sdf.resolution * float(max(sdf.dims))
    return torch.where(is_out_of_bounds(sdf, coords), big, val)


def gradient(sdf: SdfGrid, coords):
    """Interpolated SDF gradient at (..., 3) grid coords (sdf.py:362-426)."""
    return torch.stack([_trilinear(sdf.gradients[i], coords, sdf.dims)
                        for i in range(3)], dim=-1)


def on_surface(sdf: SdfGrid, coords):
    """(is_on_surface, sdf_value) (sdf.py:156-174)."""
    v = signed_distance(sdf, coords)
    return torch.abs(v) < sdf.surface_thresh, v


def curvature(sdf: SdfGrid, coords, delta: float = 0.001):
    """Symmetrized finite-difference Hessian (sdf.py:428-464): (..., 3, 3)."""
    eye = torch.eye(3, dtype=coords.dtype, device=coords.device) * delta
    ups = torch.stack([gradient(sdf, coords + e) for e in eye])
    downs = torch.stack([gradient(sdf, coords - e) for e in eye])
    curv = torch.movedim((ups - downs) / (4.0 * delta), 0, -2)
    return curv + curv.transpose(-1, -2)


def _sphere_offsets(delta: float) -> np.ndarray:
    """The 26-neighborhood offsets projected onto the delta-sphere, plus the
    center (sdf.py:509-529): (27, 3)."""
    offs = []
    for dx in (-delta, 0.0, delta):
        for dy in (-delta, 0.0, delta):
            for dz in (-delta, 0.0, delta):
                d = np.array([dx, dy, dz])
                if dx != 0 or dy != 0 or dz != 0:
                    d = delta * d / np.linalg.norm(d)
                offs.append(d)
    return np.asarray(offs, dtype=np.float32)


def surface_normal(sdf: SdfGrid, coords, delta: float = 1.5):
    """Outward surface normal by a masked plane fit (sdf.py:466-546).

    coords: (..., 3) grid coords. Returns (normal (..., 3), valid (...));
    entries off the surface or with fewer than 3 surface samples get a zero
    normal. The plane normal is the eigenvector of the smallest eigenvalue
    of the 3x3 scatter of the centered samples (``torch.linalg.eigh``).
    The mean, the scatter and the eigenvectors are computed in float64 and
    rounded to float32: float32 reductions and eigensolvers round
    differently on the card and on the CPU, and the normal feeds the
    samplers' discrete decisions.
    """
    offsets = torch.as_tensor(_sphere_offsets(delta), device=coords.device)
    flat = coords.reshape(-1, 3)
    thresh = sdf.surface_thresh
    center_val = signed_distance_oob_big(sdf, flat)                 # (N,)
    on_surf = torch.abs(center_val) < thresh
    pts = flat[:, None, :] + offsets                                # (N,27,3)
    mask = torch.abs(signed_distance_oob_big(sdf, pts)) < thresh    # (N,27)
    n_valid = mask.sum(dim=1)
    mean = (torch.where(mask[..., None], pts, 0.0).double().sum(dim=1)
            / torch.clamp(n_valid, min=1)[:, None]).float()
    centered = torch.where(mask[..., None], pts - mean[:, None], 0.0)
    centered = centered.double()
    scatter = centered.transpose(1, 2) @ centered                   # (N,3,3)
    # non-finite coords (a config with a zero axis) give a NaN normal, as
    # eigh does in the JAX package; torch's eigh would raise on them
    finite = torch.isfinite(scatter).all(dim=(1, 2))
    n = torch.linalg.eigh(torch.where(finite[:, None, None], scatter,
                                      0.0))[1][..., 0].float()
    n = torch.where(finite[:, None], n, torch.nan)
    probe_up = signed_distance_oob_big(sdf, flat + n * 0.01)
    n = torch.where((probe_up < center_val)[:, None], -n, n)
    valid = on_surf & (n_valid >= 3)
    n = torch.where(valid[:, None], n, 0.0)
    return n.reshape(coords.shape), valid.reshape(coords.shape[:-1])


def transform_dense(sdf: SdfGrid, t_4x4, *, detailed: bool = True) -> SdfGrid:
    """Resample the grid under a rigid transform (sdf.py:592-660): each new
    cell reads the old grid at the inverse-transformed location by trilinear
    interpolation (rotations leave distances invariant). ``detailed`` is
    the JAX package's keyword, which its body does not read either."""
    t = np.asarray(t_4x4, np.float64)
    rot, trans = t[:3, :3], t[:3, 3]
    dims = sdf.dims
    origin = sdf.origin.cpu().numpy()
    res = float(sdf.resolution)
    idx = [np.arange(d, dtype=np.float64) for d in dims]
    ii, jj, kk = np.meshgrid(*idx, indexing="ij")
    new_world = origin + res * np.stack([ii, jj, kk], axis=-1)
    old_world = (new_world.reshape(-1, 3) - trans) @ rot
    old_grid = (old_world - origin) / res
    vals = signed_distance(sdf, torch.as_tensor(
        old_grid, dtype=torch.float32, device=sdf.data.device))
    return make_sdf(vals.reshape(dims), origin, res, device=sdf.data.device)


def rescale(sdf: SdfGrid, scale: float) -> SdfGrid:
    """Rescale the SDF by a scale factor (sdf.py:575+): world distances and
    resolution scale linearly."""
    return make_sdf(sdf.data.cpu().numpy() * scale,
                    sdf.origin.cpu().numpy() * scale,
                    float(sdf.resolution) * scale, device=sdf.data.device)
