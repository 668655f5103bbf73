"""Plain closing-region crops: the points of a cloud inside a grasp's box,
in the grasp's frame, picked by rank from a shuffled order.

Semantics (kinect2grasp.py collect_pc for the online box, dataset.py:50-69
for the training box): a point is in the box when each frame coordinate
lies strictly between the box's bounds. The cloud is visited in the order of
a shuffle; with more than ``num_out`` points inside, the crop takes a cyclic
window of ``num_out`` consecutive ranks from a drawn start, otherwise
``num_out`` ranks drawn with replacement. A crop with fewer than
``min_points`` points is invalid and all zero.

Frame coordinates decide membership, so they are rounded as the system under
test is specified to round them: ``a0*x + a1*y + a2*z`` with the products
of the second and first terms fused into single roundings (each ``fma``
below is one float64 multiply-add rounded once to float32), unit vectors
divided by their correctly rounded norm. Written here from that
specification alone; nothing of the program is imported.
"""

from __future__ import annotations

import torch


def fma(a, b, c):
    """float32 ``a * b + c`` rounded once."""
    f = torch.float64
    return (torch.as_tensor(a, dtype=torch.float32).to(f)
            * torch.as_tensor(b, dtype=torch.float32).to(f)
            + torch.as_tensor(c, dtype=torch.float32).to(f)).float()


def lin3(a0, x, a1, y, a2, z):
    return fma(a2, z, fma(a0, x, a1 * y))


def norm3(v):
    s = fma(v[..., 2], v[..., 2], fma(v[..., 1], v[..., 1],
                                      v[..., 0] * v[..., 0]))
    return torch.sqrt(s.double()).float()


def unit(v):
    return v / norm3(v)[..., None]


def to_frame(pts, centers, rows):
    """pts (P, 3) or (G, P, 3); centers (G, 3); rows (G, 3, 3) ->
    (G, P, 3) coordinates along the rows."""
    d = [pts[..., i] - centers[:, i, None] for i in range(3)]
    return torch.stack([lin3(d[0], rows[:, i, 0, None], d[1],
                             rows[:, i, 1, None], d[2], rows[:, i, 2, None])
                        for i in range(3)], dim=-1)


def select_ranks(mask, t):
    """mask (G, P) in the visiting order, t (G, N) 1-based ranks -> (G, N)
    positions of the t-th point inside."""
    cum = torch.cumsum(mask.to(torch.int32), dim=1).contiguous()
    pos = torch.searchsorted(cum, t.to(torch.int32).contiguous())
    return pos.clamp(max=mask.shape[1] - 1)


def crop(pc_visit, centers, rows, lo, hi, windows, num_out: int,
         min_points: int):
    """pc_visit: (P, 3) shared or (G, P, 3) per grasp, already in visiting
    order; lo, hi (G, 3) float32 bounds; ``windows(count)`` draws the ranks
    (r (G, num_out), start (G, 1)) for the counts inside. Returns (points
    (G, num_out, 3), counts (G,), valid (G,))."""
    g = centers.shape[0]
    frame = to_frame(pc_visit, centers, rows)
    mask = torch.all((frame > lo[:, None]) & (frame < hi[:, None]), dim=-1)
    count = mask.sum(dim=1)
    r, start = windows(count)
    cmax = count.clamp(min=1)[:, None]
    window = (start + torch.arange(num_out, device=pc_visit.device)) % cmax
    t = torch.where((count > num_out)[:, None], window + 1, r + 1)
    pos = select_ranks(mask, t)
    rows_idx = torch.arange(g, device=pc_visit.device)[:, None]
    pts = frame[rows_idx, pos]
    valid = count >= min_points
    pts = torch.where(valid[:, None, None], pts, 0.0)
    return pts, count, valid


def check_shuffled_window(points: int, candidates: int) -> None:
    """``crop`` follows the program's selection on a shared cloud of more
    than 4,096 points with 32 candidates or more (one shuffle, then a
    window of ranks); smaller calls draw other numbers (top-k keys)."""
    if points <= 4096 or candidates < 32:
        raise ValueError(f"{candidates} candidates over {points} points: "
                         f"the reference covers more than 4,096 points and "
                         f"32 candidates or more")


def online_box(g: int, hand_depth: float, width: float, device):
    """(lo, hi) of the online crop: x in (0, depth), y in +-width/2, z in
    +-width/4 from the hand's bottom centre."""
    hd = torch.tensor(hand_depth, dtype=torch.float32, device=device)
    w = torch.tensor(width, dtype=torch.float32, device=device)
    zero = torch.zeros_like(w)
    lo = torch.stack([zero, -w / 2.0, -w / 4.0]).expand(g, 3)
    hi = torch.stack([hd, w / 2.0, w / 4.0]).expand(g, 3)
    return lo, hi


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def training_frames(grasps, transforms):
    """Grasp rows (B, >=8: centre, axis, width, approach angle) under (B, 4,
    4) transforms -> (centres (B, 3), rows (B, 3, 3), half box (B, 3)) of
    the training crop (dataset.py:16-69): binormal = the axis, approach the
    x axis perpendicular to it turned by the angle about it, box x and z in
    +-width/4, y in +-width/2 around the centre."""
    center, axis = grasps[:, 0:3], grasps[:, 3:6]
    width, angle = grasps[:, 6], grasps[:, 7]
    axis = axis / norm3(axis)[:, None]
    zero = torch.zeros_like(axis[:, 0])
    ax = torch.stack([axis[:, 1], -axis[:, 0], zero], dim=1)
    ax = torch.where((norm3(ax) == 0)[:, None],
                     torch.tensor([1.0, 0.0, 0.0], device=grasps.device), ax)
    ax = ax / norm3(ax)[:, None]
    az = _cross(ax, axis)
    approach = fma(az, torch.sin(angle)[:, None],
                   ax * torch.cos(angle)[:, None])
    approach = approach / norm3(approach)[:, None]
    minor = _cross(axis, approach)
    rot = transforms[:, :3, :3]

    def rotate(v):
        return torch.stack([lin3(rot[:, i, 0], v[:, 0], rot[:, i, 1], v[:, 1],
                                 rot[:, i, 2], v[:, 2]) for i in range(3)],
                           dim=1)

    center = rotate(center) + transforms[:, :3, 3]
    rows = torch.stack([rotate(approach), rotate(axis), rotate(minor)], dim=1)
    half = torch.stack([width / 4.0, width / 2.0, width / 4.0], dim=1)
    return center, rows, half
