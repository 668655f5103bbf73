"""Contact surface windows: local SDF and depth patches at contact points.

Port of ``pointnetgpd_tpu/grasping/surface_window.py`` (reference:
dex-net/src/dexnet/grasping/contacts.py:312-644 — ``surface_window_sdf``,
``_compute_surface_window_projection`` / ``surface_window_projection``,
``surface_information`` and the ``SurfaceWindow`` container): a
tangent-plane grid at each contact is sampled against the SDF (sdf window)
or marched along the contact direction to a zero crossing (projection
window). Every function is batched over contacts x grid cells on the SDF's
device, in plain torch: the JAX package computes them as ``jnp`` under
``jit``, with no Pallas kernel. The reference's bilateral denoising
(contacts.py:437-445, skimage ``denoise_bilateral``) is the unrolled
shifted-window weighted average of the JAX version, on the signed window (a
bilateral filter is shift-invariant).

The grid points and the line samples are rounded as XLA's CPU build rounds
them under ``jit`` (``_linspace``, the FMAs of ``_tangent_grid`` and the
march), so that the crossings land in the same cells as JAX's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..geometry import sdf as sdf_lib
from ..ops.fp import fma
from .quality import tangents_from_direction

# contacts per chunk of the projection march: (chunk, cells, samples, 3)
# float64 line points stay under 100 MB at the default 21 x 21 x 32
_CONTACT_CHUNK = 256


@dataclass
class SurfaceWindow:
    """(contacts.py:645-703): projection window + gradients + curvature."""

    proj_win: np.ndarray   # (num_steps, num_steps) depths
    grad: tuple            # (gx, gy)
    hess_x: tuple
    hess_y: tuple

    @property
    def proj_win_flat(self):
        return self.proj_win.reshape(-1)


def _on(sdf, x):
    return torch.as_tensor(x, dtype=torch.float32, device=sdf.data.device)


def _linspace(start, stop, num: int):
    """``jnp.linspace(start, stop, num)`` of () float32 tensors as XLA's CPU
    build computes it under ``jit``: ``start * (1 - i r) + i (stop r)``,
    r = f32(1 / (num - 1)), the add fused with the second product; the last
    sample is ``stop`` itself."""
    if num == 1:
        return start.reshape(1)
    r = float(np.float32(1.0 / (num - 1)))
    i = torch.arange(num - 1, dtype=start.dtype, device=start.device)
    return torch.cat([fma(i, stop * r, start * (1.0 - i * r)),
                      stop.reshape(1)])


def _tangent_grid(contacts, directions, width, num_steps: int):
    """World points of the num_steps x num_steps grid spanning +-width/2 on
    the tangent plane at each contact (contacts.py:344-380 setup), and the
    unit directions. contacts, directions: (C, 3). Returns ((C, S * S, 3),
    (C, 3))."""
    d, t1, t2 = tangents_from_direction(directions)
    w = torch.as_tensor(width, dtype=torch.float32, device=contacts.device)
    scales = _linspace(-w / 2.0, w / 2.0, num_steps)
    uu, vv = torch.meshgrid(scales, scales, indexing="ij")
    uu, vv = uu.reshape(1, -1, 1), vv.reshape(1, -1, 1)
    pts = fma(vv, t2[:, None, :],
              fma(uu, t1[:, None, :], contacts[:, None, :]))
    return pts, d


def surface_window_sdf(sdf: sdf_lib.SdfGrid, contacts, in_directions,
                       width: float = 1e-2, num_steps: int = 21):
    """SDF values on the tangent grid at each contact (contacts.py:312-342).
    contacts/in_directions: (C, 3). Returns (C, num_steps, num_steps) on the
    SDF's device."""
    contacts, in_directions = _on(sdf, contacts), _on(sdf, in_directions)
    pts, _ = _tangent_grid(contacts, in_directions, width, num_steps)
    vals = sdf_lib.signed_distance_oob_big(sdf,
                                           sdf_lib.world_to_grid(sdf, pts))
    return vals.reshape(-1, num_steps, num_steps)


def _bilateral_window_size(sigma_spatial: float) -> int:
    """skimage's default support: max(5, 2*ceil(3*sigma_spatial)+1)."""
    return max(5, 2 * math.ceil(3.0 * float(sigma_spatial)) + 1)


def bilateral_denoise(windows, sigma_range: float = 0.1,
                      sigma_spatial: float = 1.0, win_size: int = 7):
    """Edge-preserving bilateral filter over (..., H, W) windows
    (contacts.py:437-445: ``denoise_bilateral(window_pos, sigma_range,
    sigma_spatial, mode='nearest')``).

    Each output pixel is the weighted average of its (win_size x win_size)
    neighborhood with weight exp(-d2_px / (2 sigma_spatial^2)) *
    exp(-(I_q - I_p)^2 / (2 sigma_range^2)); edges are 'nearest'-padded
    (``F.pad(mode="replicate")`` on the windows stacked as (N, 1, H, W)).
    The neighborhood loop is win_size^2 shifted elementwise passes over
    every window at once."""
    windows = torch.as_tensor(windows, dtype=torch.float32)
    r = win_size // 2
    lead, (h, w) = windows.shape[:-2], windows.shape[-2:]
    img = windows.reshape(-1, h, w)
    padded = F.pad(img[:, None], (r, r, r, r), mode="replicate")[:, 0]
    f32 = dict(dtype=torch.float32, device=img.device)
    ss = torch.tensor(sigma_spatial, **f32)
    sr = torch.tensor(sigma_range, **f32)
    inv2ss = 1.0 / (2.0 * ss * ss)
    inv2sr = 1.0 / (2.0 * sr * sr)
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    for di in range(-r, r + 1):
        for dj in range(-r, r + 1):
            shifted = padded[:, r + di:r + di + h, r + dj:r + dj + w]
            w_sp = torch.exp(-(di * di + dj * dj) * inv2ss)
            wt = w_sp * torch.exp(-torch.square(shifted - img) * inv2sr)
            num = num + wt * shifted
            den = den + wt
    return (num / den).reshape(lead + (h, w))


def _projection_windows_raw(sdf: sdf_lib.SdfGrid, contacts, in_directions,
                            width: float, num_steps: int, max_depth: float,
                            num_samples: int):
    """Signed depth of the first zero crossing along each cell's line
    through ``[-max_depth, max_depth]`` (linear between the two samples
    that bracket it), ``max_depth`` where the line has none:
    (C, num_steps, num_steps)."""
    contacts, in_directions = _on(sdf, contacts), _on(sdf, in_directions)
    md = torch.as_tensor(max_depth, dtype=torch.float32,
                         device=contacts.device)
    ts = _linspace(-md, md, num_samples)                            # (T,)
    dt = ts[1] - ts[0]
    out = []
    for c0 in range(0, contacts.shape[0], _CONTACT_CHUNK):
        pts, d = _tangent_grid(contacts[c0:c0 + _CONTACT_CHUNK],
                               in_directions[c0:c0 + _CONTACT_CHUNK], width,
                               num_steps)
        line = fma(ts[None, None, :, None], d[:, None, None, :],
                   pts[:, :, None, :])                       # (c, M, T, 3)
        vals = sdf_lib.signed_distance_oob_big(
            sdf, sdf_lib.world_to_grid(sdf, line))           # (c, M, T)
        sign_change = (vals[..., :-1] * vals[..., 1:]) <= 0
        has = torch.any(sign_change, dim=-1)
        first = torch.argmax(sign_change.to(torch.uint8), dim=-1)
        v0 = torch.gather(vals, -1, first[..., None])[..., 0]
        v1 = torch.gather(vals, -1, first[..., None] + 1)[..., 0]
        den = v0 - v1
        frac = v0 / torch.where(torch.abs(den) < 1e-12, 1e-12, den)
        depth = fma(torch.clamp(frac, 0.0, 1.0), dt, ts[first])
        out.append(torch.where(has, depth, md))
    if not out:
        return torch.zeros((0, num_steps, num_steps), dtype=torch.float32,
                           device=contacts.device)
    return torch.cat(out).reshape(-1, num_steps, num_steps)


def surface_window_projection(sdf: sdf_lib.SdfGrid, contacts, in_directions,
                              width: float = 1e-2, num_steps: int = 21,
                              max_depth: float = 1e-2,
                              num_samples: int = 32,
                              sigma_range: float = 0.1,
                              sigma_spatial: float = 1.0):
    """Projected depth window: for each tangent-grid cell, march along the
    contact direction to the surface zero crossing and record the signed
    depth (contacts.py:344-461). Cells with no crossing get max_depth.

    As in the reference (contacts.py:437-445 and the public wrapper defaults
    at contacts.py:461-463), the window is bilateral-denoised when both
    sigmas are positive; pass ``sigma_range=0`` for the raw window.
    Returns (C, num_steps, num_steps) depths in [-max_depth, max_depth]."""
    win = _projection_windows_raw(sdf, contacts, in_directions, width,
                                  num_steps, max_depth, num_samples)
    if sigma_range > 0.0 and sigma_spatial > 0.0:
        win = bilateral_denoise(win, sigma_range, sigma_spatial,
                                win_size=_bilateral_window_size(sigma_spatial))
    return win


def _window(proj: np.ndarray) -> SurfaceWindow:
    """Finite-difference gradients and Hessian rows of a projection
    window (contacts.py:620-644)."""
    gx, gy = np.gradient(proj)
    hxx, hxy = np.gradient(gx)
    hyx, hyy = np.gradient(gy)
    return SurfaceWindow(proj, (gx, gy), (hxx, hxy), (hyx, hyy))


def surface_information(sdf: sdf_lib.SdfGrid, contact, in_direction,
                        width: float = 2e-2, num_steps: int = 21):
    """Full SurfaceWindow for one contact (contacts.py:564-644): projection
    window + finite-difference gradients and Hessian rows (numpy)."""
    proj = surface_window_projection(
        sdf, _on(sdf, contact)[None], _on(sdf, in_direction)[None],
        width=width, num_steps=num_steps)[0]
    return _window(proj.cpu().numpy())


def grasp_surface_information(sdf, contacts, width: float = 2e-2,
                              num_steps: int = 21):
    """SurfaceWindows at both contact points of closed grasps
    (reference: grasp.py:949-968 surface_information — patch features at the
    jaw contacts). contacts: a Contacts batch (grasping/grasp.py); returns a
    list of (window_c1, window_c2) per grasp. All 2G windows are one
    projection call."""
    points = _on(sdf, contacts.points).reshape(-1, 2, 3)
    dirs = _on(sdf, contacts.in_directions).reshape(-1, 2, 3)
    proj = surface_window_projection(
        sdf, points.reshape(-1, 3), dirs.reshape(-1, 3), width=width,
        num_steps=num_steps).cpu().numpy().reshape(
            -1, 2, num_steps, num_steps)
    return [(_window(p[0]), _window(p[1])) for p in proj]
