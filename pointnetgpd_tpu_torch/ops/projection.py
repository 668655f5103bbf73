"""GPD projection features: 60x60 occupancy + normal images, batched.

Port of ``pointnetgpd_tpu/ops/projection.py`` (reference
PointNetGPD/model/dataset.py:88-198). The cropped closing-region cloud is
voxelized at res = gripper_width / (size - margin); each occupied voxel
accumulates the normals of its first ``voxel_point_num`` points (first come,
dataset.py:178-184); each (u, v) image cell takes the count and mean normal
of its occupied voxel of largest w (np.unique's last, dataset.py:186-194);
occupancy is max-normalized. Per-voxel ranks come from a stable sort,
sums from ``index_add_``. Every function takes a leading batch axis of
clouds: points (B, P, 3), one gripper width per cloud.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span

_ORDERS = ((0, 1, 2), (1, 2, 0), (0, 2, 1))


def project_to_image(points, normals, valid, gripper_width, order, *,
                     size: int = 60, margin: int = 1,
                     voxel_point_num: int = 50):
    """One projection image pair for one axis ``order`` per cloud.

    points / normals (B, P, 3), valid (B, P) real points, gripper_width
    (B,). Returns (occupy (B, size, size, 1), norm (B, size, size, 3))."""
    bsz, p_total, _ = points.shape
    dev = points.device
    # XLA multiplies by the float32 reciprocal of the constant (size -
    # margin) where the JAX code divides by it
    inv = torch.tensor(1.0 / (size - margin), dtype=torch.float32)
    res = (gripper_width * inv.to(dev))[:, None, None]
    coords = torch.floor(points / res + size / 2.0).to(torch.int64)
    coords = coords[..., list(order)]
    in_range = torch.all((coords >= 0) & (coords < size), dim=-1) & valid
    u, v, w = coords.unbind(-1)
    n_vox = size * size * size
    vid = torch.where(in_range, (u * size + v) * size + w, n_vox)

    # per-point rank within its voxel (a stable sort keeps first-come
    # order): the reference's cap of voxel_point_num points per voxel
    sorted_vid, sort_idx = torch.sort(vid, dim=1, stable=True)
    first = torch.ones_like(sorted_vid, dtype=torch.bool)
    first[:, 1:] = sorted_vid[:, 1:] != sorted_vid[:, :-1]
    ar = torch.arange(p_total, device=dev).expand(bsz, p_total)
    run_start = torch.cummax(torch.where(first, ar, 0), dim=1).values
    rank = torch.empty_like(vid).scatter_(1, sort_idx, ar - run_start)
    counted = in_range & (rank < voxel_point_num)

    seg = torch.where(counted, vid, n_vox)
    flat = (seg + torch.arange(bsz, device=dev)[:, None] * (n_vox + 1))
    flat = flat.reshape(-1)
    counts = torch.zeros(bsz * (n_vox + 1), dtype=torch.int64, device=dev)
    counts.index_add_(0, flat, torch.ones_like(flat))
    norm_sums = torch.zeros((bsz * (n_vox + 1), 3), dtype=points.dtype,
                            device=dev)
    norm_sums.index_add_(0, flat, torch.where(counted[..., None], normals,
                                              0.0).reshape(-1, 3))
    counts3 = counts.reshape(bsz, n_vox + 1)[:, :n_vox].reshape(
        bsz, size, size, size)
    norm3 = norm_sums.reshape(bsz, n_vox + 1, 3)[:, :n_vox].reshape(
        bsz, size, size, size, 3)

    # per (u, v) cell: the occupied voxel of largest w
    w_idx = torch.arange(size, device=dev)
    w_pick = torch.where(counts3 > 0, w_idx, -1).amax(dim=3)
    any_occ = w_pick >= 0
    w_safe = torch.clamp(w_pick, min=0)[..., None]
    cell_count = torch.gather(counts3, 3, w_safe)[..., 0]
    cell_norm = torch.gather(norm3, 3, w_safe[..., None].expand(
        -1, -1, -1, 1, 3))[..., 0, :]
    cell_count = torch.where(any_occ, cell_count, 0)
    denom = torch.clamp(cell_count, min=1).to(points.dtype)
    norm_pic = torch.where(any_occ[..., None], cell_norm / denom[..., None],
                           0.0)
    occupy = cell_count.to(points.dtype)[..., None]
    max_occ = occupy.amax(dim=(1, 2, 3), keepdim=True)
    return occupy / torch.clamp(max_occ, min=1.0), norm_pic


def gpd_projection_features(points, normals, valid, gripper_width, *,
                            project_chann: int = 12, size: int = 60,
                            margin: int = 1, voxel_point_num: int = 50):
    """GPD input features (dataset.py:88-120), (B, size, size, C) NHWC: 3
    channels (the normal image of order (0, 1, 2)) or 12 (occupancy and
    normal images over orders (0, 1, 2), (1, 2, 0), (0, 2, 1), in the
    reference's dstack order). Each ``project_to_image`` call is a
    ``gpd.project`` span."""
    if project_chann not in (3, 12):
        raise NotImplementedError("project_chann must be 3 or 12")
    kw = dict(size=size, margin=margin, voxel_point_num=voxel_point_num)
    images = []
    for order in _ORDERS[:1 if project_chann == 3 else 3]:
        with span("gpd.project"):
            occupy, norm = project_to_image(points, normals, valid,
                                            gripper_width, order, **kw)
        images += [norm] if project_chann == 3 else [occupy, norm]
    return torch.cat(images, dim=-1)
