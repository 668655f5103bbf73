"""PointNet++ sampling and grouping indices (kernel K7) and their plain
versions.

``models/pointnet2.py`` asks this module for every farthest-point sample
and ball query. On a CUDA device (``takes``) each call is one launch of
``csrc/pointnet2_sample.cu``, inside a ``pn2.kernel`` span; on the CPU it
takes ``fps_plain`` or ``ball_query_plain``, the kernel's plain versions,
and opens no such span. Nothing here waits on the device.

The semantics (Qi et al., arXiv:1706.02413, as the PyTorch ports of
``pointnet2`` compute them):

- farthest-point sampling starts at index 0; each further index is the
  point whose least squared distance to the points chosen so far is the
  largest, the lowest index winning a tie;
- the ball query keeps, per centroid, the first ``nsample`` points in index
  order with d^2 < r^2 (``r2``: ``radius * radius`` rounded to float32) and
  fills the slots left with the first index found (0 where none was).

Each squared distance is ``(dx * dx + dy * dy) + dz * dz`` with
``d = point - centroid``, every operation rounded to float32 on its own,
in the kernel and in the plain versions alike, so their indices are equal.
"""

from __future__ import annotations

import torch

from .. import _build
from ..utils.profiling import span

launches = 0               # kernel launches (one per call)

FPS_MAX_POINTS = 12800     # a cloud K7's FPS holds in shared memory
#                            (csrc/pointnet2_sample.cu FPS_MAX_POINTS)


def takes(points) -> bool:
    """Whether sampling and grouping on ``points`` run on K7: on a CUDA
    device."""
    return points.is_cuda


def sqdist(points, centroids):
    """``(dx * dx + dy * dy) + dz * dz`` of ``points - centroids``
    (broadcast), each operation rounded to float32."""
    d = points - centroids
    dx, dy, dz = d.unbind(-1)
    return dx * dx + dy * dy + dz * dz


def radius2(radius: float):
    """The squared radius as both versions compare with it: float32."""
    return torch.tensor(radius * radius, dtype=torch.float32).item()


def _check(name, *tensors):
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"K7 {name} takes float32 points, got "
                             f"{t.dtype}")
        if t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"K7 {name} takes (B, N, 3) points, got "
                             f"{tuple(t.shape)}")
    if tensors[0].shape[1] == 0:
        raise ValueError(f"K7 {name} has no point to choose from an empty "
                         f"cloud")


def fps_plain(xyz, npoint: int):
    """xyz (B, N, 3) -> (B, npoint) int64 indices of farthest-point
    sampling, one batched pass a point chosen."""
    b, n, _ = xyz.shape
    out = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
    mind = torch.full((b, n), float("inf"), dtype=xyz.dtype,
                      device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    last = out[:, 0]
    for it in range(1, npoint):
        mind = torch.minimum(mind, sqdist(xyz, xyz[rows, last][:, None]))
        last = mind.argmax(dim=1)
        out[:, it] = last
    return out


def ball_query_plain(xyz, centroids, radius: float, nsample: int):
    """xyz (B, N, 3), centroids (B, S, 3) -> (B, S, nsample) int64: the
    first ``nsample`` points in index order inside each ball, the rest of
    the slots the first of them."""
    n = xyz.shape[1]
    inside = sqdist(xyz[:, None], centroids[:, :, None]) < radius2(radius)
    order = torch.arange(n, device=xyz.device)
    key = torch.where(inside, order, n)
    if n < nsample:
        key = torch.cat([key, key.new_full(key.shape[:-1] + (nsample - n,),
                                           n)], dim=-1)
    idx = key.sort(dim=-1).values[..., :nsample]
    first = idx[..., :1]
    idx = torch.where(idx == n, first, idx)
    return torch.where(idx == n, 0, idx)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def fps_kernel(xyz, npoint: int):
    """K7's farthest-point sampling: xyz (B, N, 3) float32 on a CUDA
    device -> (B, npoint) int64. Raises on other dtypes, an empty cloud and
    clouds above ``FPS_MAX_POINTS``."""
    global launches
    _check("fps", xyz)
    b, n, _ = xyz.shape
    if n > FPS_MAX_POINTS:
        raise ValueError(f"K7 fps holds at most {FPS_MAX_POINTS} points a "
                         f"cloud, got {n}")
    xyz = xyz.contiguous()
    out = torch.empty((b, npoint), dtype=torch.int64, device=xyz.device)
    _build.check(_build.library().pn2_fps_launch(
        xyz.data_ptr(), b, n, npoint, out.data_ptr(), _stream(xyz)),
        "pn2_fps_launch")
    launches += 1
    return out


def ball_query_kernel(xyz, centroids, radius: float, nsample: int):
    """K7's ball query: xyz (B, N, 3), centroids (B, S, 3) float32 on one
    CUDA device -> (B, S, nsample) int64. Raises on other dtypes, devices
    or batch sizes and on an empty cloud."""
    global launches
    _check("ball query", xyz, centroids)
    if centroids.device != xyz.device or centroids.shape[0] != xyz.shape[0]:
        raise ValueError(f"centroids {tuple(centroids.shape)} on "
                         f"{centroids.device} for points "
                         f"{tuple(xyz.shape)} on {xyz.device}")
    b, n, _ = xyz.shape
    s = centroids.shape[1]
    xyz, centroids = xyz.contiguous(), centroids.contiguous()
    out = torch.empty((b, s, nsample), dtype=torch.int64, device=xyz.device)
    _build.check(_build.library().pn2_ball_query_launch(
        xyz.data_ptr(), b, n, centroids.data_ptr(), s, radius2(radius),
        nsample, out.data_ptr(), _stream(xyz)), "pn2_ball_query_launch")
    launches += 1
    return out


def farthest_point_sample(xyz, npoint: int):
    """(B, npoint) int64 indices: K7 on a CUDA device, else the plain
    version."""
    if takes(xyz):
        with span("pn2.kernel"):
            return fps_kernel(xyz, npoint)
    return fps_plain(xyz, npoint)


def ball_query(xyz, centroids, radius: float, nsample: int):
    """(B, S, nsample) int64 indices: K7 on a CUDA device, else the plain
    version."""
    if takes(xyz):
        with span("pn2.kernel"):
            return ball_query_kernel(xyz, centroids, radius, nsample)
    return ball_query_plain(xyz, centroids, radius, nsample)
