"""Exact k-NN plane normals in one launch (kernel K5).

``ops/cloud.py`` ``estimate_normals_knn`` routes every CUDA cloud here
(``takes``); on the CPU it takes ``_normals_plain``, the kernel's plain
version. Nothing here waits on the device: sizes come from shapes, and a
camera on the host is passed by value, one already on the device by
pointer.

``normals`` launches ``csrc/knn_normals.cu``: per point its k nearest
neighbours within its cloud, exact and with ties toward the lower index, in
the same rounding as the plain version (its neighbour sets equal the plain
version's), then the least eigenvector of their covariance in float64,
turned toward the camera.
"""

from __future__ import annotations

import torch

from .. import _build

launches = 0             # kernel launches (one per call)

KMAX = 32                # the largest k (csrc/knn_normals.cu KMAX)


def takes(points) -> bool:
    """Whether the normals of ``points`` run on K5: on a CUDA device."""
    return points.is_cuda


def _camera(camera_pos, dev):
    """(device tensor or None, three float32 values): a CUDA camera by
    pointer, any other by value, rounded to float32 as the plain version
    rounds it."""
    if isinstance(camera_pos, torch.Tensor) and camera_pos.is_cuda:
        cam = camera_pos.to(dev, torch.float32).reshape(3).contiguous()
        return cam, (0.0, 0.0, 0.0)
    cam = torch.as_tensor(camera_pos, dtype=torch.float32).reshape(3)
    return None, tuple(cam.tolist())


def normals(points, camera_pos, *, k: int = 30, idx_out=None):
    """K5: points (P, 3) or (B, P, 3) float32 on a CUDA device, camera_pos
    (3,) (a sequence, a host tensor or a device tensor). Returns the unit
    normals, shaped as ``points``. ``idx_out``, where given, an int64
    (B, P, min(k, P)) tensor on the same device, receives each point's
    neighbours, nearest first. Raises on a dtype other than float32 and on
    k above ``KMAX``."""
    global launches
    if points.dtype != torch.float32:
        raise ValueError(f"K5 takes float32 points, got {points.dtype}")
    if points.dim() not in (2, 3) or points.shape[-1] != 3:
        raise ValueError(f"points must be (P, 3) or (B, P, 3), got "
                         f"{tuple(points.shape)}")
    p_total = points.shape[-2]
    k = min(k, p_total)
    if k > KMAX:
        raise ValueError(f"K5 keeps at most {KMAX} neighbours, asked for {k}")
    pts = (points if points.dim() == 3 else points[None]).contiguous()
    b = pts.shape[0]
    if idx_out is not None and (
            idx_out.dtype != torch.int64 or idx_out.device != pts.device
            or tuple(idx_out.shape) != (b, p_total, k)
            or not idx_out.is_contiguous()):
        raise ValueError(f"idx_out must be a contiguous ({b}, {p_total}, "
                         f"{k}) int64 tensor on {pts.device}")
    if k == 0 or b == 0:
        return torch.zeros_like(points)
    out = torch.empty_like(pts)
    cam, (cx, cy, cz) = _camera(camera_pos, pts.device)
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    _build.check(_build.library().knn_normals_launch(
        pts.data_ptr(), b, p_total, k,
        None if cam is None else cam.data_ptr(), cx, cy, cz, out.data_ptr(),
        None if idx_out is None else idx_out.data_ptr(), stream),
        "knn_normals_launch")
    launches += 1
    return out if points.dim() == 3 else out[0]
