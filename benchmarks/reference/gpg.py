"""Plain GPG candidate search (GpgGraspSamplerPcl.sample_grasps,
grasp_sampler.py:1389-1656) on a voxel cloud, in float64: how many of the
(seed, theta) hand frames are valid candidates.

- Seeds: the ``num_seeds`` points above the table with the largest drawn
  uniforms (one uniform per row of the padded cloud, ties to the lower row).
- A seed's neighbors: its ``max_neighbors`` nearest points among the
  ``window`` points around it in Morton (Z) order over the cloud's box, 10
  bits an axis from the float32 coordinates, as the configuration's windowed
  normals define it (the whole cloud where it holds at most two windows).
  Each neighbor's normal is the least-variance axis of its ``normal_k``
  nearest window points, turned toward the camera.
- The seed's frame: the normals' summed outer products (neighbors within
  ``r_ball``, the seed itself left out); the normal is their greatest axis,
  turned as the seed's own normal, the minor axis their least. Where the
  least two are equal (a flat patch) the minor axis is the normal crossed
  with the coordinate axis least along it. Its sign is the eigen-solver's
  choice, and it decides which valid dy the scan picks (the middle one,
  counted from the major axis' negative end), so both signs are followed:
  the count of a seed lies between its counts under the two.
- Decisions that a near tie can turn, which float32 and float64 turn
  differently: where the least two eigenvalues differ by less than one
  neighbor's share (``min_axis_gap``) but are not equal, the minor axis
  swings with which points tie for the last neighbor places, so the seed
  may count anything from none to all of its turns; where the seed's own
  normal is nearly square to the frame's normal, or to the camera
  (``min_turn``), the frame's normal is followed both ways.
- Each frame, normal and major axis turned about the minor axis by theta:
  the dy scan along the major axis (open panel holds a point, no other panel
  any), the downward guard, the approach along the normal to the first
  collision, backed off 3 steps, the table clearance, and the final check
  (open panel holds more than ``min_open_points`` points, no other panel
  any). The panels are ``frame.panel_boxes``.

Written from that description; nothing of the program is imported.
"""

from __future__ import annotations

import torch

from .frame import hand_points, panel_boxes

F64 = torch.float64


def morton_codes(points, lo, hi, bits: int = 10):
    """(P, 3) float32 points -> (P,) Morton codes over the box (lo, hi),
    quantized in float32; far padding clamps to the box's corner."""
    span = torch.clamp(hi - lo, min=1e-12)
    top = float(2 ** bits - 1)
    q = torch.clamp((points - lo) / span * top, 0.0, top).to(torch.int64)
    code = torch.zeros(points.shape[0], dtype=torch.int64,
                       device=points.device)
    for b in range(bits):
        for a in range(3):
            code = code | (((q[:, a] >> b) & 1) << (3 * b + a))
    return code


def _nearest(d2, k):
    """(values, indices) of the k smallest along the last axis, ties to the
    lower index."""
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _d2(a, b):
    """Squared distances between (..., N, 3) and (..., M, 3), float64."""
    return ((a * a).sum(-1)[..., :, None] - 2.0 * a @ b.transpose(-1, -2)
            + (b * b).sum(-1)[..., None, :])


def seed_frames(points, n_real, uniforms, camera, *, num_seeds, above_z,
                max_neighbors, normal_k, window, r_ball, min_axis_gap=0.25,
                min_turn=0.2):
    """points (P, 3) float32, the voxel cloud in its first ``n_real`` rows
    and far padding after; uniforms (P,). Returns (seed_ok (S,), seeds (S,
    3), normal, major, minor (S, 3), frame_ok, firm_minor, firm_normal
    (S,)), float64."""
    dev = points.device
    p_total = points.shape[0]
    real = points[:n_real]
    lo, hi = real.amin(dim=0), real.amax(dim=0)
    above = points[:, 2] > above_z
    key = torch.where(above, uniforms, -torch.inf)
    seed_idx = torch.sort(key, descending=True, stable=True)[1][:num_seeds]
    seed_ok = above[seed_idx]

    pts = points.to(F64)
    if p_total <= 2 * window or p_total <= max_neighbors:
        win = torch.arange(p_total, device=dev).expand(seed_idx.shape[0], -1)
    else:
        order = torch.argsort(morton_codes(points, lo, hi), stable=True)
        rank = torch.argsort(order, stable=True)
        starts = torch.clamp(rank[seed_idx] - window // 2, 0,
                             p_total - window)
        win = order[starts[:, None] + torch.arange(window, device=dev)]
    seeds = pts[seed_idx]
    cand = pts[win]                                            # (S, W, 3)
    pd2, nb = _nearest(((cand - seeds[:, None]) ** 2).sum(-1),
                       min(max_neighbors, win.shape[1]))
    nbr = torch.gather(cand, 1, nb[..., None].expand(-1, -1, 3))  # (S, K, 3)
    _, nb2 = _nearest(_d2(nbr, cand), normal_k)                # (S, K, k)
    pk = torch.gather(cand[:, None].expand(-1, nbr.shape[1], -1, -1), 2,
                      nb2[..., None].expand(-1, -1, -1, 3))    # (S, K, k, 3)
    centered = pk - pk.mean(dim=-2, keepdim=True)
    cov = torch.einsum("...ki,...kj->...ij", centered, centered)
    normals = torch.linalg.eigh(cov)[1][..., 0]
    cam = torch.as_tensor(camera, dtype=F64, device=dev)
    toward = ((cam - nbr) * normals).sum(-1) < 0
    normals = torch.where(toward[..., None], -normals, normals)
    seed_normal = normals[:, 0]                   # nearest: the seed itself

    w = ((pd2 <= r_ball * r_ball) & (pd2 > 1e-8)).to(F64)
    m = torch.einsum("sk,ski,skj->sij", w, normals, normals)
    frame_ok = m.abs().sum(dim=(1, 2)) > 0
    evals, evecs = torch.linalg.eigh(m)
    normal, minor = evecs[..., 2], evecs[..., 0]
    flat = (evals[:, 1] - evals[:, 0]) <= 1e-9 * evals[:, 2].abs().clamp(
        min=1e-300)
    clean = torch.where(normal.abs() < 1e-9, 0.0, normal)
    axis = torch.eye(3, dtype=F64, device=dev)[clean.abs().argmin(dim=1)]
    alt = torch.linalg.cross(clean, axis)
    alt = alt / alt.norm(dim=1, keepdim=True).clamp(min=1e-300)
    minor = torch.where(flat[:, None], alt, minor)
    major = torch.linalg.cross(minor, normal)
    major = major / major.norm(dim=1, keepdim=True).clamp(min=1e-300)
    along = (seed_normal * normal).sum(-1)
    normal = torch.where((along < 0)[:, None], -normal, normal)
    minor = torch.where((along < 0)[:, None], -minor, minor)
    view = cam - seeds
    facing = (view * seed_normal).sum(-1) / view.norm(dim=1)
    firm_minor = flat | ((evals[:, 1] - evals[:, 0]) >= min_axis_gap)
    firm_normal = (along.abs() >= min_turn) & (facing.abs() >= min_turn)
    return (seed_ok, seeds, normal, major, minor, frame_ok, firm_minor,
            firm_normal)


def _rotate(axis, thetas, v):
    """v (S, 3) turned about unit ``axis`` (S, 3) by each of ``thetas``
    (T,) -> (S, T, 3) (Rodrigues)."""
    c = torch.cos(thetas)[None, :, None]
    s = torch.sin(thetas)[None, :, None]
    a, v = axis[:, None], v[:, None]
    return (c * v + s * torch.linalg.cross(a.expand_as(v), v)
            + (1 - c) * (a * v).sum(-1, keepdim=True) * a)


class _Panels:
    """Panel membership of a block of frames' points, in hand coordinates
    (x along the normal, y along the major axis, z along the minor)."""

    def __init__(self, gripper):
        boxes = panel_boxes(gripper)
        self.boxes = [boxes[k] for k in ("open", "bottom", "left", "right")]

    def counts(self, x, y, z, dx, dy):
        """x, y, z (F, P) local coordinates about the seed; dx, dy (F, N)
        hand offsets -> (F, N, 4) counts with the bottom centre at the
        offsets."""
        out = []
        for lo, hi in self.boxes:
            xs = x[:, None] - dx[..., None]
            ys = y[:, None] - dy[..., None]
            inside = ((xs > lo[0]) & (xs < hi[0]) & (ys > lo[1])
                      & (ys < hi[1]) & (z[:, None] > lo[2])
                      & (z[:, None] < hi[2]))
            out.append(inside.sum(-1))
        return torch.stack(out, dim=-1)


def _block_valid(cloud, seeds, t_normal, t_major, minor, gripper, g, panels):
    """Validity of a block of frames under each sign of the minor axis:
    (F, 2) bool; column 0 picks the middle valid dy counted from the major
    axis' negative end, column 1 from its positive end."""
    dev = cloud.device
    rel = cloud[None] - seeds[:, None]                          # (F, P, 3)
    x = (rel * t_normal[:, None]).sum(-1)
    y = (rel * t_major[:, None]).sum(-1)
    z = (rel * minor[:, None]).sum(-1)
    f = seeds.shape[0]
    bite, step, hd = gripper["init_bite"], g["approach_step_m"], \
        gripper["hand_depth"]
    dys = torch.arange(-g["num_dy"], g["num_dy"] + 1, dtype=F64,
                       device=dev) * gripper["finger_width"]
    c1 = panels.counts(x, y, z, torch.full((f, 1), -bite, dtype=F64,
                                           device=dev),
                       dys.expand(f, -1))
    oks = (c1[..., 0] > 0) & (c1[..., 1:] == 0).all(-1)         # (F, D)
    n_ok = oks.sum(dim=1)
    target = torch.ceil(n_ok / 2.0).long()
    from_lo = torch.cumsum(oks.long(), dim=1)
    from_hi = torch.flip(torch.cumsum(torch.flip(oks.long(), [1]), 1), [1])
    steps = torch.arange(g["approach_steps"], dtype=F64, device=dev) * step
    hp = torch.as_tensor(hand_points(gripper)[1:], dtype=F64, device=dev)
    out = []
    for cum in (from_lo, from_hi):
        pick = torch.argmax(((cum == target[:, None]) & oks).long(), dim=1)
        dy = dys[pick]
        base = seeds + dy[:, None] * t_major
        bc = base - bite * t_normal
        downward = (bc[:, 2] + hd * t_normal[:, 2]) < bc[:, 2] - hd * 0.5
        c2 = panels.counts(x, y, z, (-bite + steps).expand(f, -1),
                           dy[:, None].expand(f, steps.shape[0]))
        collides = (c2[..., 1:] > 0).any(-1)
        hit = collides.any(dim=1)
        s_hit = steps[torch.argmax(collides.long(), dim=1)]
        x_bc2 = (-bite + s_hit) - step * 3.0
        bc2 = base + x_bc2[:, None] * t_normal
        world = (bc2[:, None] + hp[None, :, :1] * t_normal[:, None]
                 + hp[None, :, 1:2] * t_major[:, None]
                 + hp[None, :, 2:] * minor[:, None])            # (F, 20, 3)
        low = world[torch.arange(f, device=dev), world[..., 2].argmin(1)]
        nz = torch.where(t_normal[:, 2].abs() < 1e-9, 1e-9, t_normal[:, 2])
        table = torch.stack([-low[:, 2] * t_normal[:, 0] / nz + low[:, 0],
                             -low[:, 2] * t_normal[:, 1] / nz + low[:, 1],
                             torch.zeros_like(nz)], dim=1)
        back = (low - table).norm(dim=1) + g["safety_above_table_m"]
        x_mod = x_bc2 - torch.where(low[:, 2] < g["safety_above_table_m"],
                                    back, 0.0)
        c3 = panels.counts(x, y, z, x_mod[:, None], dy[:, None])[:, 0]
        final = (c3[:, 0] > g["min_open_points"]) & (c3[:, 1:] == 0).all(-1)
        out.append((n_ok > 0) & downward & hit & final)
    return torch.stack(out, dim=1)


def valid_count_bounds(points, n_real, uniforms, camera, gripper: dict,
                       g: dict, *, block: int = 64) -> tuple[int, int]:
    """(least, most) number of valid (seed, theta) frames the GPG search
    finds on the padded voxel cloud ``points`` (first ``n_real`` rows real)
    with the seed uniforms ``uniforms``; ``g`` holds the search's settings
    (see the frame mix). The two differ by the seeds whose count turns on a
    sign or a near tie (above)."""
    r_ball = max(gripper["hand_outer_diameter"] - gripper["finger_width"],
                 gripper["hand_depth"], gripper["hand_height"] / 2.0)
    (seed_ok, seeds, normal, major, minor, frame_ok, firm_minor,
     firm_normal) = seed_frames(
        points, n_real, uniforms, camera, num_seeds=g["num_seeds"],
        above_z=g["above_table_m"], max_neighbors=g["max_neighbors"],
        normal_k=g["normal_k"], window=g["normal_window"], r_ball=r_ball)
    dev = points.device
    s = seeds.shape[0]
    # each seed's frame, and turned over for a seed whose normal may point
    # either way
    turned = torch.nonzero(~firm_normal).flatten()
    owner = torch.cat([torch.arange(s, device=dev), turned])
    normal = torch.cat([normal, -normal[turned]])
    minor = torch.cat([minor, -minor[turned]])
    major, seeds = major[owner], seeds[owner]
    half = g["theta_range_deg"]
    thetas = torch.arange(-half, half + 1, g["theta_step_deg"], dtype=F64,
                          device=dev) / 180.0 * torch.pi
    t = thetas.shape[0]
    t_normal = _rotate(minor, thetas, normal).reshape(-1, 3)
    t_major = _rotate(minor, thetas, major).reshape(-1, 3)
    minor_r = minor[:, None].expand(-1, t, -1).reshape(-1, 3)
    seeds_r = seeds[:, None].expand(-1, t, -1).reshape(-1, 3)
    active = ((seed_ok & frame_ok)[owner][:, None].expand(-1, t).reshape(-1)
              & (t_normal[:, 2] < -0.5 + 1e-3))
    valid = torch.zeros((owner.shape[0] * t, 2), dtype=torch.bool,
                        device=dev)
    cloud = points[:n_real].to(F64)
    panels = _Panels(gripper)
    idx = torch.nonzero(active).flatten()
    for i in range(0, idx.shape[0], block):
        j = idx[i:i + block]
        valid[j] = _block_valid(cloud, seeds_r[j], t_normal[j], t_major[j],
                                minor_r[j], gripper, g, panels)
    counts = valid.reshape(-1, t, 2).sum(dim=1)         # (frames of seeds, 2)
    least = torch.full((s,), t, dtype=counts.dtype, device=dev)
    most = torch.zeros((s,), dtype=counts.dtype, device=dev)
    least = least.scatter_reduce(0, owner, counts.amin(dim=1), "amin")
    most = most.scatter_reduce(0, owner, counts.amax(dim=1), "amax")
    least = torch.where(firm_minor, least, 0)
    most = torch.where(firm_minor, most, t)
    return int(least.sum()), int(most.sum())


def count_gap(emitted: int, bounds: tuple[int, int], num_grasps: int) -> int:
    """How far the number of candidates a frame emitted lies outside what
    the search allows: the first ``num_grasps`` valid frames, so between
    min(num_grasps, least) and min(num_grasps, most)."""
    lo, hi = (min(num_grasps, b) for b in bounds)
    return max(lo - emitted, emitted - hi, 0)
