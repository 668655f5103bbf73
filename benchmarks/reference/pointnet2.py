"""Plain PointNet++ SSG classifier (Qi et al., arXiv:1706.02413) in float32
torch operations: sampling, grouping, the train-mode forward, the masked
NLL loss, gradients by autograd and Adam.

The widths of ``charlesq34/pointnet2`` ``models/pointnet2_cls_ssg.py``, as
the configuration lists them (``sa``, ``fc``, ``k``):

- each set-abstraction level with a ``npoint`` samples that many centroids
  by farthest-point sampling (first index 0; then the point whose least
  squared distance to the chosen ones is the largest, the first such index
  on a tie), groups per centroid the first ``nsample`` points in index order
  with d^2 < r^2 (r^2 rounded to float32; the slots left repeat the first
  point found, index 0 where none was), centres their xyz on the centroid
  and puts the previous level's features after it;
- the level without one groups every point, its uncentred xyz first;
- a shared MLP of linear -> BatchNorm (batch statistics in train mode,
  summed in float64) -> ReLU layers, then a max over each group; the head
  1024 -> 512 -> 256 -> k with log-softmax. The crop is first scaled by
  ``xyz_scale``.

Departures from the published model, listed under ``assumed`` in the
configuration: no dropout in the head; d^2 < r^2 where the TF original
compares sqrt(d^2) < r. Each squared distance is (dx * dx + dy * dy) +
dz * dz in float32, every operation rounded on its own.

Nothing here imports the program. Parameters are a dict under the program's
state_dict names. The sampling indices are computed once per batch on the
crop (``sample``, in the crop's type) and handed to ``forward``, so that
the float64 witness and the TF32 control group the points the float32
crop groups.
"""

from __future__ import annotations

import torch

from . import pointnet
from .train import adam_step

FAULTS = ("fps_random_start", "pad_zero")


def param_shapes(config: dict) -> list[tuple[str, tuple]]:
    """(name, shape) of every parameter and BatchNorm statistic, in one
    fixed order; 1x1 convolution weights are (out, in, 1)."""
    out = []

    def bn(prefix, n):
        out.extend([(f"{prefix}.weight", (n,)), (f"{prefix}.bias", (n,)),
                    (f"{prefix}.running_mean", (n,)),
                    (f"{prefix}.running_var", (n,))])

    chann = 0
    for i, sa in enumerate(config["sa"], 1):
        dims = (chann + 3,) + tuple(sa["mlp"])
        for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            out.extend([(f"feat.sa{i}.mlp_convs.{j}.weight", (b, a, 1)),
                        (f"feat.sa{i}.mlp_convs.{j}.bias", (b,))])
        for j, b in enumerate(sa["mlp"]):
            bn(f"feat.sa{i}.mlp_bns.{j}", b)
        chann = sa["mlp"][-1]
    dims = (chann,) + tuple(config["fc"]) + (config["k"],)
    for j, (a, b) in enumerate(zip(dims[:-1], dims[1:]), 1):
        out.extend([(f"fc{j}.weight", (b, a)), (f"fc{j}.bias", (b,))])
    for j, b in enumerate(config["fc"], 1):
        bn(f"bn{j}", b)
    return out


def _sq(points, centre):
    """Squared distances of ``points`` from ``centre`` (broadcast), every
    operation rounded to float32 on its own."""
    dx = points[..., 0] - centre[..., 0]
    dy = points[..., 1] - centre[..., 1]
    dz = points[..., 2] - centre[..., 2]
    return dx * dx + dy * dy + dz * dz


def fps(xyz, npoint: int, start=None):
    """xyz (B, N, 3) -> (B, npoint) int64. ``start`` (B,) int64: the first
    indices (0 in the published algorithm; a planted fault draws them)."""
    b, n, _ = xyz.shape
    rows = torch.arange(b, device=xyz.device)
    cur = (torch.zeros(b, dtype=torch.int64, device=xyz.device)
           if start is None else start)
    least = torch.full((b, n), float("inf"), device=xyz.device)
    out = []
    for _ in range(npoint):
        out.append(cur)
        least = torch.minimum(least, _sq(xyz, xyz[rows, cur][:, None]))
        cur = torch.argmax(least, dim=1)
    return torch.stack(out, dim=1)


def ball_query(xyz, centroids, radius: float, nsample: int,
               pad_zero: bool = False):
    """xyz (B, N, 3), centroids (B, S, 3) -> (B, S, nsample) int64: the
    first ``nsample`` points in index order inside each ball, the slots
    left the first of them (``pad_zero``, a planted fault: index 0)."""
    r2 = torch.tensor(radius * radius, dtype=torch.float32)
    inside = _sq(xyz[:, None], centroids[:, :, None]) < r2.item()
    rank = torch.cumsum(inside, dim=-1) - 1
    keep = inside & (rank < nsample)
    b, s, n = keep.nonzero(as_tuple=True)
    out = torch.zeros(inside.shape[:2] + (nsample,), dtype=torch.int64,
                      device=xyz.device)
    out[b, s, rank[b, s, n]] = n
    found = inside.sum(dim=-1).clamp(max=nsample)
    first = torch.where(inside.any(dim=-1), inside.int().argmax(dim=-1), 0)
    fill = torch.zeros_like(first) if pad_zero else first
    slot = torch.arange(nsample, device=xyz.device)
    return torch.where(slot < found[..., None], out, fill[..., None])


def _gather(points, idx):
    rows = torch.arange(points.shape[0], device=points.device)
    return points[rows.view((-1,) + (1,) * (idx.dim() - 1)), idx]


def sample(x, config: dict, fault=None, gen=None) -> dict:
    """The sampling and grouping indices of every level with a ``npoint``,
    on the crop x (B, N, 3), in its type: {"sa1.fps": (B, S1), "sa1.ball":
    (B, S1, K1), ...}. ``fault`` plants ``fps_random_start`` (each FPS
    starts at an index drawn from ``gen``) or ``pad_zero``."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; faults: {FAULTS}")
    xyz = x * config["xyz_scale"]
    out = {}
    for i, sa in enumerate(config["sa"], 1):
        if sa["npoint"] is None:
            break
        start = None
        if fault == "fps_random_start":
            start = torch.randint(0, xyz.shape[1], (xyz.shape[0],),
                                  generator=gen, device=gen.device)
            start = start.to(xyz.device)
        picked = fps(xyz, sa["npoint"], start)
        centroids = _gather(xyz, picked)
        out[f"sa{i}.fps"] = picked
        out[f"sa{i}.ball"] = ball_query(xyz, centroids, sa["radius"],
                                        sa["nsample"],
                                        pad_zero=fault == "pad_zero")
        xyz = centroids
    return out


def _bn(p, name, x, train: bool):
    """BatchNorm over every axis but the channel axis: in train mode the
    batch's mean and biased variance, each summed in float64 and rounded to
    x's type (a float32 sum over the 2 million grouped rows of SA1 loses
    the digits that x - mean keeps where |mean| >> std); in eval mode the
    running statistics."""
    if not train:
        return pointnet._bn(p, name, x, False)
    axes = tuple(range(x.dim() - 1))
    mean = x.mean(dim=axes, dtype=torch.float64).to(x.dtype)
    var = ((x - mean) ** 2).mean(dim=axes, dtype=torch.float64).to(x.dtype)
    return (x - mean) / torch.sqrt(var + pointnet.BN_EPS) \
        * p[f"{name}.weight"] + p[f"{name}.bias"]


def _mlp(p, prefix, h, n_layers, train, tf32):
    for j in range(n_layers):
        h = torch.relu(_bn(
            p, f"{prefix}.mlp_bns.{j}",
            pointnet._linear(p, f"{prefix}.mlp_convs.{j}", h, tf32), train))
    return h


def forward(p: dict, x, config: dict, indices: dict, *, train: bool = True,
            tf32: bool = False):
    """x (B, N, 3) -> log-probabilities (B, k), grouped by ``indices``
    (``sample``'s). ``tf32``: every product in TF32 (the control)."""
    xyz = x * config["xyz_scale"]
    feats = None
    for i, sa in enumerate(config["sa"], 1):
        if sa["npoint"] is None:
            h = xyz if feats is None else torch.cat([xyz, feats], dim=-1)
        else:
            idx = indices[f"sa{i}.ball"]
            centroids = _gather(xyz, indices[f"sa{i}.fps"])
            h = _gather(xyz, idx) - centroids[:, :, None]
            if feats is not None:
                h = torch.cat([h, _gather(feats, idx)], dim=-1)
            xyz = centroids
        feats = _mlp(p, f"feat.sa{i}", h, len(sa["mlp"]), train,
                     tf32).amax(dim=-2)
    g = feats
    for j in range(1, len(config["fc"]) + 1):
        g = torch.relu(_bn(p, f"bn{j}", pointnet._linear(p, f"fc{j}", g,
                                                         tf32), train))
    last = f"fc{len(config['fc']) + 1}"
    return torch.log_softmax(pointnet._linear(p, last, g, tf32), dim=-1)


def loss_fn(params, x, labels, weights, config, indices, tf32=False):
    logp = forward(params, x, config, indices, tf32=tf32)
    nll = -logp.gather(1, labels[:, None].long())[:, 0]
    return (nll * weights).sum() / weights.sum().clamp(min=1.0)


def gradients(params: dict, x, labels, weights, config, indices,
              tf32=False):
    """(loss, gradients by name) of the trainable leaves of ``params``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()
              if pointnet.is_trainable(k)}
    loss = loss_fn(dict(params, **leaves), x, labels, weights, config,
                   indices, tf32)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def run_steps(params: dict, batches, config: dict, *, lr,
              tf32: bool = False):
    """Train ``params`` (changed in place) from fresh Adam moments on
    ``batches`` [(x, labels, weights, indices), ...]; ``lr(t)`` is update
    t's learning rate. Returns (losses, the first step's gradients)."""
    trainable = {k: v for k, v in params.items() if pointnet.is_trainable(k)}
    m = {k: torch.zeros_like(v) for k, v in trainable.items()}
    v = {k: torch.zeros_like(p) for k, p in trainable.items()}
    losses, first = [], None
    for t, (x, labels, weights, indices) in enumerate(batches):
        loss, grads = gradients(params, x, labels, weights, config, indices,
                                tf32)
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        adam_step(trainable, grads, m, v, t + 1, lr(t))
        losses.append(loss)
    return losses, first
