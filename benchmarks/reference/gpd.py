"""Plain GPD baseline: the projection-CNN grasp classifier of ten Pas,
Gualtieri, Saenko and Platt, *Grasp Pose Detection in Point Clouds* (IJRR
2017, arXiv:1706.09911), as PointNetGPD trains it (main_fullv_gpd.py,
model/gpd.py, model/dataset.py; arXiv:1809.06267), in plain torch.

Per sample:

1. Crop (dataset.py:50-69). The points of the sample's own cloud strictly
   inside the grasp's training box (x, z in +-w/4, y in +-w/2 of the
   grasp frame; frames and frame coordinates from ``crop.py``), visited in
   the order of their selection keys, highest first (ties: the lower key
   slot). More than ``num_out`` inside: the first ``num_out``; otherwise
   ``num_out`` ranks drawn with replacement. Fewer than ``min_points``
   inside: invalid, all zero.
2. Normals. For each point of the crop its ``k`` nearest neighbours within
   the crop (itself included), exact in float64; the least eigenvector of
   their covariance (``torch.linalg.eigh``, float64), flipped toward the
   camera at (-1, 0, 0) of the gripper frame (kinect2grasp.py:137-144).
3. Projection (dataset.py:88-198). Voxels of res = w / (size - margin) on
   a size^3 grid centred on the grasp; each voxel keeps the normals of its
   first ``voxel_point_num`` points in crop order. For each axis order
   (0, 1, 2), (1, 2, 0), (0, 2, 1), each (u, v) cell takes the count and the
   mean normal of its occupied voxel of largest w; occupancy is divided by
   its image's largest. 12 channels: [occupancy, normal] per order, in that
   order; 3 channels: the normal image of the first order.
4. CNN (model/gpd.py:5-31). Conv2d(C -> 20, 5x5), max-pool 2,
   Conv2d(20 -> 50, 5x5), max-pool 2 (no activation between), Linear(7200
   -> 500), ReLU, Linear(500 -> 2), log-softmax; NCHW flattening.
5. Masked NLL over the samples that count, divided by their number; Adam
   written out (``train.adam_step``).

Departures from the source, each shared with the system under test:

- exact k-NN where the source uses open3d's hybrid KD-tree search;
- normals estimated within the crop, not on the whole merged cloud
  (dataset.py:93-95 estimates them on the cloud it is given);
- the crop's selection keys and ranks are inputs (the program's draws), not
  numpy's generator; ``key_slots`` says where each point's key sits;
- res is w times float32(1 / (size - margin)) and voxel coordinates are
  floor(p / res + size / 2) in float32, as the system under test is
  specified to round them, so that a point on a voxel face falls on the
  same side.

Everything runs in float32 (normals in float64, rounded to float32), with
TF32 off (``strict_fp32``); ``tf32=True`` rounds every operand of the
convolutions and products to TF32 instead (the control). Nothing of the
program is imported.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from .crop import to_frame, training_frames
from .pointnet import _mm, to_tf32
from .train import adam_step

CAMERA = (-1.0, 0.0, 0.0)
ORDERS = ((0, 1, 2), (1, 2, 0), (0, 2, 1))
SEGMENTS, DIRECT_MAX = 16, 4096


@contextlib.contextmanager
def strict_fp32():
    """cuDNN's and cuBLAS's TF32 off for the block, restored after."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, mm.allow_tf32
    cudnn.allow_tf32 = mm.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = saved


def param_shapes(c: int, conv=((20, 5), (50, 5)), fc=(500,), k: int = 2,
                 size: int = 60) -> list[tuple[str, tuple]]:
    """(name, shape) of every parameter, the source's state_dict names."""
    out, cin, side = [], c, size
    for i, (cout, kern) in enumerate(conv, 1):
        out += [(f"conv{i}.weight", (cout, cin, kern, kern)),
                (f"conv{i}.bias", (cout,))]
        cin, side = cout, (side - kern + 1) // 2
    dims = (cin * side * side,) + tuple(fc) + (k,)
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]), 1):
        out += [(f"fc{i}.weight", (b, a)), (f"fc{i}.bias", (b,))]
    return out


# ---------------------------------------------------------------- crop

def key_slots(p: int, device):
    """(p,) slot of each point's selection key: the point itself up to
    4,096 points; above, the strided interleave of 16 segments (segment s
    holds points s, s + 16, ...; ceil(p / 16) slots a segment)."""
    i = torch.arange(p, device=device)
    if p <= DIRECT_MAX:
        return i
    return (i % SEGMENTS) * -(-p // SEGMENTS) + i // SEGMENTS


def key_width(p: int) -> int:
    """Slots a cloud of p points draws keys for."""
    return p if p <= DIRECT_MAX else SEGMENTS * -(-p // SEGMENTS)


def crop(grasps, clouds, transforms, keys, ranks, *, num_out: int,
         min_points: int):
    """grasps (B, >=8), clouds (B, P, 3), transforms (B, 4, 4); keys (B,
    key_width(P)) float32; ``ranks(counts)`` -> (B, num_out) ranks in [0,
    max(count, 1)). Returns (points (B, num_out, 3) in the grasp frames,
    counts (B,), valid (B,))."""
    b, p = clouds.shape[:2]
    centers, rows, half = training_frames(grasps, transforms)
    frame = to_frame(clouds, centers, rows)                   # (B, P, 3)
    inside = torch.all((frame > -half[:, None]) & (frame < half[:, None]),
                       dim=-1)
    counts = inside.sum(dim=1)
    r = ranks(counts)
    slot = key_slots(p, clouds.device)
    by_slot = torch.argsort(slot)
    pts = torch.zeros((b, num_out, 3), dtype=frame.dtype,
                      device=clouds.device)
    for i in range(b):
        n = int(counts[i])
        if n == 0:
            continue
        # points in slot order, then by key, highest first (stable: ties
        # keep the lower slot first)
        cand = by_slot[inside[i, by_slot]]
        order = cand[torch.sort(keys[i, slot[cand]], descending=True,
                                stable=True).indices]
        pick = order[:num_out] if n > num_out else order[r[i].long()]
        pts[i] = frame[i, pick]
    valid = counts >= min_points
    return torch.where(valid[:, None, None], pts, 0.0), counts, valid


# ------------------------------------------------------------- normals

def normals(points, *, k: int = 30, camera=CAMERA, flip: bool = True,
            block: int = 8):
    """(B, N, 3) crops -> (B, N, 3) float64 unit normals: exact k-NN within
    each crop (float64 distances, ties toward the lower index), the least
    eigenvector of the neighbours' covariance, turned toward ``camera``
    (``flip=False`` leaves the sign eigh gives: a planted fault)."""
    p = points.double()
    k = min(k, p.shape[1])
    cam = torch.tensor(camera, dtype=torch.float64, device=p.device)
    out = []
    for x in p.split(block):
        d2 = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
        nbr = torch.sort(d2, dim=-1, stable=True).indices[..., :k]
        q = torch.gather(x[:, None].expand(-1, x.shape[1], -1, -1), 2,
                         nbr[..., None].expand(-1, -1, -1, 3))
        c = q - q.mean(dim=2, keepdim=True)
        n = torch.linalg.eigh(c.transpose(-1, -2) @ c).eigenvectors[..., 0]
        if flip:
            n = torch.where((((cam - x) * n).sum(-1) < 0)[..., None], -n, n)
        out.append(n / n.norm(dim=-1, keepdim=True))
    return torch.cat(out)


# ---------------------------------------------------------- projection

def project(points, nrm, width: float, order, *, size: int = 60,
            margin: int = 1, voxel_point_num: int = 50):
    """One crop's image pair for one axis ``order``, by a walk over its
    points: points (N, 3) float32, nrm (N, 3), width a float32 number.
    Returns (occupancy (size, size), normal image (size, size, 3)),
    float32."""
    res = torch.tensor(width, dtype=torch.float32) \
        * torch.tensor(1.0 / (size - margin), dtype=torch.float32)
    coords = torch.floor(points.float().cpu() / res + size / 2.0).long()
    coords = coords[:, list(order)]
    inside = torch.all((coords >= 0) & (coords < size), dim=1)
    voxels = {}
    for c, n in zip(coords[inside].tolist(),
                    nrm.double().cpu()[inside].tolist()):
        acc = voxels.setdefault(tuple(c), [0, 0.0, 0.0, 0.0])
        if acc[0] < voxel_point_num:       # the first points only
            acc[0] += 1
            for j in range(3):
                acc[1 + j] += n[j]
    top = {}
    for u, v, w in voxels:
        if w > top.get((u, v), -1):
            top[(u, v)] = w
    cells = [(u, v, voxels[(u, v, w)]) for (u, v), w in top.items()]
    occ = torch.zeros((size, size), dtype=torch.float64)
    img = torch.zeros((size, size, 3), dtype=torch.float64)
    if cells:
        u, v, acc = zip(*cells)
        acc = torch.tensor(acc, dtype=torch.float64)
        occ[u, v] = acc[:, 0]
        img[u, v] = acc[:, 1:] / acc[:, :1]
    occ = occ / max(float(occ.max()), 1.0)
    return occ.float(), img.float()


def features(points, nrm, widths, *, chann: int = 12, orders=ORDERS,
             **kw):
    """(B, N, 3) crops, their normals and (B,) widths -> (B, size, size,
    chann) float32 NHWC on the crops' device. ``orders``: the three axis
    orders (a planted fault swaps two)."""
    out = []
    for x, n, w in zip(points, nrm, widths.tolist()):
        images = []
        for order in orders[:1 if chann == 3 else 3]:
            occ, img = project(x, n, w, order, **kw)
            images += [img] if chann == 3 else [occ[..., None], img]
        out.append(torch.cat(images, dim=-1))
    return torch.stack(out).to(points.device)


# ----------------------------------------------------------------- CNN

class _TF32Conv(torch.autograd.Function):
    """Valid conv2d with its operands rounded to TF32, forward and
    backward (the control's precision)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv2d(to_tf32(x), to_tf32(w))

    @staticmethod
    def backward(ctx, g):
        x, w = (to_tf32(t) for t in ctx.saved_tensors)
        g = to_tf32(g)
        return (torch.nn.grad.conv2d_input(x.shape, w, g),
                torch.nn.grad.conv2d_weight(x, w.shape, g))


def _conv(x, w, b, tf32):
    y = _TF32Conv.apply(x, w) if tf32 else F.conv2d(x, w)
    return y + b[:, None, None]


def forward(params: dict, feats, *, tf32: bool = False):
    """(B, size, size, C) NHWC features -> (B, 2) log-probabilities."""
    x = feats.permute(0, 3, 1, 2)
    for i in (1, 2):
        x = F.max_pool2d(_conv(x, params[f"conv{i}.weight"],
                               params[f"conv{i}.bias"], tf32), 2)
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(_mm(x, params["fc1.weight"].t(), tf32)
                   + params["fc1.bias"])
    return torch.log_softmax(_mm(x, params["fc2.weight"].t(), tf32)
                             + params["fc2.bias"], dim=-1)


def gradients(params: dict, feats, labels, weights, tf32: bool = False):
    """(loss, gradients by name) of the masked NLL loss."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with strict_fp32():
        logp = forward(leaves, feats.to(next(iter(leaves.values())).dtype),
                       tf32=tf32)
        nll = -logp.gather(1, labels[:, None].long())[:, 0]
        w = weights.to(nll.dtype)
        loss = (nll * w).sum() / w.sum().clamp(min=1.0)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def run_steps(params: dict, batches, *, lr, tf32: bool = False):
    """Train ``params`` (changed in place) from fresh Adam moments on
    ``batches`` [(features, labels, weights), ...]; ``lr(t)`` is update t's
    learning rate. Returns (losses, the first step's gradients)."""
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first = [], None
    for t, (x, labels, weights) in enumerate(batches):
        loss, grads = gradients(params, x, labels, weights, tf32)
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        adam_step(params, grads, m, v, t + 1, lr(t))
        losses.append(loss)
    return losses, first
