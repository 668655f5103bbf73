"""Plain antipodal grasp sampling and the friction ladder on a grid of
signed distances, in float64 (or another precision, for the control).

Semantics: dex-net's antipodal sampler (grasp_sampler.py:621-803), its
finger closing and contact search (grasp.py:435-713, 872-947), the plane-fit
surface normal (sdf.py:466-546), the two-contact force-closure test
(quality.py:245-283) and the friction ladder of
generate-dataset-canny.py:109-133, with the documented changes of the
system under test (one fixed-budget batch of attempts, the smallest root of
the contact's quadratic):

- a lookup is the trilinear interpolation of the grid at grid coordinates,
  corners outside the grid contributing nothing; a point outside the grid
  reads a large positive value (no surface there). A surface cell is one
  whose value lies under res * sqrt(2) / 2 in magnitude (C order); a point
  is on the surface where its lookup is;
- a surface normal is the least-variance axis of the on-surface points
  among the point and its 26 neighbours projected onto a sphere of 1.5
  cells, turned outward by a probe 0.01 cells along it; it is valid on the
  surface with 3 or more such points. A contact's normal is turned against
  the finger's closing direction;
- a line of action holds S samples, t = 0 to half its length in S - 1 equal
  steps. At a sample on the surface the quadratic through its triple (its
  neighbours, clamped at the ends) gives the contact: its first root in [0,
  10] along the triple (the vertex where it has none, the line's root where
  it degenerates), valid within one unit of t. The contact is the first
  such sample whose next sample is not nearer the surface;
- an attempt: a drawn surface cell moved by up to a quarter cell, its
  normal; an axis drawn in its friction cone and flipped by a draw; the pair
  of contacts along the axis (from half a cell behind the point, half the
  width; from the far jaw back, the whole width); the grasp between them;
  the first collision-free approach angle of a drawn order of seven
  (-90..90 by 30, used as radians), a jaw's approach colliding where any
  sample of the line 1 world unit behind it lies on the surface; the
  fingers closed again on the grasp; valid where every contact and normal
  was found, an angle is free, the second contact lies ``min_contact`` or
  more from the drawn point, and the closed pair is force closure;
- force closure at friction mu: each inward normal lies within arctan(mu)
  of the line between the contacts, either way along it, and the contacts
  are apart. The ladder's rung is the last friction of the run of
  successes from its first (highest), -1 where the first fails.

Decisions that rounding can turn (a lookup at the surface threshold, a next
sample as near the surface, the axis between a drawn pair of contacts that
nearly coincide, a closure test at its cone's edge, two closed contacts
that coincide, a plane fit with two equal least axes) are found two ways:
``Grid.variants`` runs the reference again with every lookup and the drawn
pair's second contact moved by a small seeded amount either way, and
margins on the tests mark a grasp ``tie``. Such a grasp counts either
way.

Written from that description; nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64
SPHERE_CELLS = 1.5
PROBE_CELLS = 0.01
APPROACH_ANGLES = (-90.0, -60.0, -30.0, 0.0, 30.0, 60.0, 90.0)
APPROACH_DIST = 1.0
BACKUP_CELLS = 0.5
# contacts nearer than this are the accepted coincident pairs: the closure
# test's direction is then a difference of two equal points (rounding)
COINCIDENT_M = 1e-4
# a lookup of a variant moves by up to this share of a cell times the
# resolution; float32 coordinates near 100 cells round by about 1e-5 cell
TIE_CELLS = 1e-4
# a plane fit whose two least eigenvalues lie this near (relative to the
# largest) has no decided normal
EIG_TIE = 1e-6
# radians: a closure test this near its cone's edge is a tie
FC_TIE = 1e-5
# metres: the sampler's test of the second contact's distance
WIDE_TIE = 1e-7


def norm(v):
    return torch.sqrt((v * v).sum(-1))


def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


class Grid:
    """Signed distances ``data`` (nx, ny, nz, world units) as both sides got
    them, grid index (0, 0, 0) at ``origin``, ``res`` world units a cell,
    held and computed in ``dtype``."""

    def __init__(self, data, origin, res: float, dtype=F64):
        self.dtype, self.dev = dtype, data.device
        self.data = data.to(dtype)
        self.origin = torch.as_tensor(origin, dtype=F64,
                                      device=self.dev).to(dtype)
        self.res = float(res)
        self.dims = tuple(data.shape)
        self.thresh = self.res * float(np.sqrt(2.0)) / 2.0
        self.surface = torch.nonzero(self.data.abs() < self.thresh).to(dtype)
        self.top = torch.tensor(self.dims, dtype=dtype, device=self.dev) - 1
        self.big = 1e3 * self.res * max(self.dims)
        self.noise = None

    def variants(self, seed: int) -> list["Grid"]:
        """This grid, and two copies whose lookups move by the same seeded
        amounts (up to ``TIE_CELLS`` of a cell), up in one and down in the
        other."""
        out = [self]
        for sign in (1.0, -1.0):
            g = object.__new__(Grid)
            g.__dict__.update(self.__dict__)
            gen = torch.Generator(device=self.dev)
            gen.manual_seed(seed)
            g.noise = (gen, sign * TIE_CELLS * self.res)
            out.append(g)
        return out

    def to_grid(self, world):
        return (world - self.origin) / self.res

    def to_world(self, coords):
        return self.origin + self.res * coords

    def __call__(self, coords):
        """Lookups at (..., 3) grid coordinates -> (...)."""
        nan = torch.isnan(coords).any(-1)
        coords = torch.nan_to_num(coords)
        c = torch.minimum(coords.clamp(min=0), self.top)
        lo = torch.floor(c)
        f = c - lo
        i = lo.long()
        j = torch.minimum(i + 1, self.top.long())
        ny, nz = self.dims[1], self.dims[2]
        flat = self.data.reshape(-1)
        out = torch.zeros(coords.shape[:-1], dtype=self.dtype,
                          device=self.dev)
        for dx in (0, 1):
            ix, wx = (j[..., 0], f[..., 0]) if dx else (i[..., 0],
                                                        1 - f[..., 0])
            for dy in (0, 1):
                iy, wy = (j[..., 1], f[..., 1]) if dy else (i[..., 1],
                                                            1 - f[..., 1])
                for dz in (0, 1):
                    iz, wz = (j[..., 2], f[..., 2]) if dz else (
                        i[..., 2], 1 - f[..., 2])
                    out = out + wx * wy * wz * flat[(ix * ny + iy) * nz + iz]
        oob = ((coords < 0) | (coords >= self.top + 1)).any(-1)
        out = torch.where(oob, self.big, out)
        # a point with no coordinates (an axis of zero length) reads 0
        out = torch.where(nan, 0.0, out)
        if self.noise is not None:
            gen, amount = self.noise
            u = torch.rand(out.shape, generator=gen, device=self.dev,
                           dtype=F64)
            out = out + (amount * (0.5 + 0.5 * u)).to(self.dtype)
        return out

    def jitter(self, world):
        """``world`` points moved by the variant's amount (up to it along
        each axis, seeded): the drawn pair of contacts, whose difference
        is the grasp's axis."""
        if self.noise is None:
            return world
        gen, amount = self.noise
        u = torch.rand(world.shape, generator=gen, device=self.dev,
                       dtype=F64)
        return world + (amount * (2.0 * u - 1.0)).to(self.dtype)


def _sphere_offsets(dtype, device):
    offs = []
    for dx in (-1.0, 0.0, 1.0):
        for dy in (-1.0, 0.0, 1.0):
            for dz in (-1.0, 0.0, 1.0):
                n = float(np.sqrt(dx * dx + dy * dy + dz * dz)) or 1.0
                offs.append([SPHERE_CELLS * dx / n, SPHERE_CELLS * dy / n,
                             SPHERE_CELLS * dz / n])
    return torch.tensor(offs, dtype=F64, device=device).to(dtype)


def surface_normal(g: Grid, coords):
    """Outward normals at (N, 3) grid coordinates: (normal (N, 3), valid
    (N,), tie (N,)); invalid normals are zero."""
    center = g(coords)
    pts = coords[:, None, :] + _sphere_offsets(g.dtype, g.dev)
    mask = g(pts).abs() < g.thresh
    count = mask.sum(1)
    mean = torch.where(mask[..., None], pts, 0.0).sum(1) \
        / count.clamp(min=1)[:, None].to(g.dtype)
    cen = torch.where(mask[..., None], pts - mean[:, None], 0.0)
    scatter = (cen[..., :, None] * cen[..., None, :]).sum(1).to(F64)
    finite = torch.isfinite(scatter).all(dim=(1, 2))
    evals, evecs = torch.linalg.eigh(torch.where(finite[:, None, None],
                                                 scatter, 0.0))
    n = evecs[..., 0].to(g.dtype)
    probe = g(coords + n * PROBE_CELLS)
    n = torch.where((probe < center)[:, None], -n, n)
    valid = (center.abs() < g.thresh) & (count >= 3) & finite
    tie = valid & (evals[:, 1] - evals[:, 0]
                   <= EIG_TIE * evals[:, 2].clamp(min=1e-300))
    return torch.where(valid[:, None], n, 0.0), valid, tie


def contact_normal(g: Grid, coords, closing):
    """A contact's normal, turned against the closing direction."""
    n, valid, tie = surface_normal(g, coords)
    n = torch.where((dot(closing, n) > 0)[:, None], -n, n)
    return n, valid, tie


def line_of_action(start, axis, length, samples: int, min_width=0.0):
    """(..., S, 3): start + t axis, t from 0 to length / 2 - min_width / 2
    in S - 1 equal steps."""
    stop = length / 2.0 - min_width / 2.0
    k = torch.arange(samples, dtype=F64, device=start.device) \
        / (samples - 1)
    t = stop[..., None] * k.to(start.dtype)
    return start[..., None, :] + t[..., None] * axis[..., None, :]


def _det3(m):
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def zero_crossing(p0, y0, p1, y1, p2, y2):
    """The crossing of the quadratic through three samples along a line:
    (point (..., 3), valid (...))."""
    seg = norm(p1 - p0)
    u = (p1 - p0) / seg.clamp(min=1e-12)[..., None]
    t1, t2 = seg, norm(p2 - p0)
    zero, one = torch.zeros_like(seg), torch.ones_like(seg)
    x = torch.stack([torch.stack([zero, zero, one], -1),
                     torch.stack([t1 * t1, t1, one], -1),
                     torch.stack([t2 * t2, t2, one], -1)], -2)
    y = torch.stack([y0, y1, y2], -1)
    d = _det3(x)
    singular = d.abs() < 1e-12
    d = torch.where(singular, 1.0, d)

    def solve(col):
        m = x.clone()
        m[..., :, col] = y
        return _det3(m) / d

    a, b, c = solve(0), solve(1), solve(2)
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(disc.clamp(min=0.0))
    a2 = 2.0 * torch.where(a.abs() < 1e-30, 1e-30, a)
    r1, r2 = (-b - sq) / a2, (-b + sq) / a2
    lo, hi = torch.minimum(r1, r2), torch.maximum(r1, r2)
    lo_ok = (disc >= 0) & (lo >= 0) & (lo <= 10.0)
    hi_ok = (disc >= 0) & (hi >= 0) & (hi <= 10.0)
    t = torch.where(lo_ok | hi_ok, torch.where(lo_ok, lo, hi), -b / a2)
    flat = a.abs() < 1e-10
    t = torch.where(flat, -c / torch.where(b.abs() < 1e-30, 1e-30, b), t)
    ok = ~singular & torch.where(flat, b.abs() >= 1e-30, True) \
        & (t.abs() <= 1.0)
    return p0 + t[..., None] * u, ok


def find_contact(g: Grid, loa):
    """Along lines of action (..., S, 3): (found (...), contact (..., 3),
    any sample on the surface (...))."""
    s = loa.shape[-2]
    vals = g(loa)
    on = vals.abs() < g.thresh
    i = torch.arange(s, device=loa.device)
    a = (i - 1).clamp(0, s - 3)
    pts, ok = zero_crossing(loa[..., a, :], vals[..., a],
                            loa[..., a + 1, :], vals[..., a + 1],
                            loa[..., a + 2, :], vals[..., a + 2])
    nearer = vals[..., (i + 1).clamp(max=s - 1)].abs() < vals.abs()
    nearer[..., s - 1] = False
    accept = on & ok & ~nearer
    first = accept.to(torch.int8).argmax(-1)
    point = torch.gather(pts, -2, first[..., None, None].expand(
        *first.shape, 1, 3))[..., 0, :]
    return accept.any(-1), point, on.any(-1)


def tangents(d):
    """(unit d, t1, t2): t1 the unit projection of x onto the plane normal
    to d (of y where x lies along d), t2 = d x t1."""
    d = d / norm(d)[..., None]
    ex = torch.zeros_like(d)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(d)
    ey[..., 1] = 1.0
    t1 = ex - d[..., 0:1] * d
    alt = ey - d[..., 1:2] * d
    n1 = norm(t1)
    t1 = torch.where((n1 > 1e-8)[..., None],
                     t1 / n1.clamp(min=1e-30)[..., None],
                     alt / norm(alt).clamp(min=1e-30)[..., None])
    return d, t1, cross(d, t1)


def closure_margin(p1, n1, p2, n2, mu: float):
    """arctan(mu) less the larger angle between an inward normal and the
    line between the contacts (either way along it): force closure where
    it is 0 or more; -inf where the contacts are one point. Also the
    contacts' distance."""
    diff = p2 - p1
    dist = norm(diff)

    def angle(inward, v):
        proj = dot(inward, v).abs() / norm(inward)
        return torch.arccos((proj / dist.clamp(min=1e-16)).clamp(-1.0, 1.0))

    worst = torch.maximum(angle(-n1, diff), angle(-n2, -diff))
    m = float(np.arctan(mu)) - worst
    return torch.where(dist == 0, -np.inf, m), dist


def signed_cone_angles(contacts, normals):
    """(G, 2): the angle between each inward normal and the direction to the
    other contact, the normals' signs kept."""
    out = []
    for k in (0, 1):
        v = contacts[:, 1 - k] - contacts[:, k]
        inward = -normals[:, k]
        cos = dot(inward, v) / (norm(inward) * norm(v)).clamp(min=1e-30)
        out.append(torch.arccos(cos.clamp(-1.0, 1.0)))
    return torch.stack(out, -1)


def _jaws(g: Grid, configs):
    axis = configs[:, 3:6] / norm(configs[:, 3:6])[:, None]
    half = configs[:, 6:7] / 2.0
    return (axis, g.to_grid(configs[:, 0:3] - half * axis),
            g.to_grid(configs[:, 0:3] + half * axis))


def close_fingers(g: Grid, configs, samples: int):
    """Both jaws closed on (G, 10) configurations, each along half the
    width: (found (G,), contacts (G, 2, 3) world, outward normals (G, 2, 3),
    tie (G,))."""
    axis, g1, g2 = _jaws(g, configs)
    width = configs[:, 6] / g.res
    min_width = configs[:, 9] / g.res
    f1, p1, _ = find_contact(g, line_of_action(g1, axis, width, samples,
                                               min_width))
    f2, p2, _ = find_contact(g, line_of_action(g2, -axis, width, samples,
                                               min_width))
    n1, v1, t1 = contact_normal(g, p1, axis)
    n2, v2, t2 = contact_normal(g, p2, -axis)
    return (f1 & f2 & v1 & v2,
            torch.stack([g.to_world(p1), g.to_world(p2)], 1),
            torch.stack([n1, n2], 1), f1 & f2 & (t1 | t2))


def approach_free(g: Grid, configs, angles, samples: int):
    """(G, A): True where neither jaw's line 1 world unit back along the
    approach direction of angle ``angles`` (G, A) touches the surface."""
    axis, g1, g2 = _jaws(g, configs)
    x = torch.stack([axis[:, 1], -axis[:, 0], torch.zeros_like(axis[:, 0])],
                    -1)
    nx = norm(x)
    ex = torch.zeros_like(x)
    ex[:, 0] = 1.0
    x = torch.where((nx == 0)[:, None], ex, x / nx.clamp(min=1e-30)[:, None])
    z = cross(x, axis)
    ang = angles.to(F64)
    approach = (torch.cos(ang).to(g.dtype)[..., None] * x[:, None]
                + torch.sin(ang).to(g.dtype)[..., None] * z[:, None])
    length = torch.full(angles.shape, APPROACH_DIST / g.res, dtype=g.dtype,
                        device=g.dev)
    hit = torch.zeros(angles.shape, dtype=torch.bool, device=g.dev)
    for jaw in (g1, g2):
        start = jaw[:, None, :].expand(-1, angles.shape[1], -1)
        hit = hit | find_contact(g, line_of_action(start, -approach, length,
                                                   samples))[2]
    return ~hit


def ladder(g: Grid, configs, frictions, samples: int):
    """The friction ladder on (G, 10) configurations: (rung (G,), margins
    (G, L), tie (G,)). A margin is -inf where the fingers found no pair."""
    found, pts, nrm, tie = close_fingers(g, configs, samples)
    margins, dist = [], None
    for mu in frictions:
        m, dist = closure_margin(pts[:, 0], nrm[:, 0], pts[:, 1], nrm[:, 1],
                                 mu)
        margins.append(torch.where(found, m, -np.inf))
    margins = torch.stack(margins, -1)
    ok = (margins >= 0).long()
    rung = torch.cumprod(ok, dim=1).sum(1) - 1
    tie = tie | (found & (dist < COINCIDENT_M))
    tie = tie | (margins[:, 0].abs() < FC_TIE)
    return rung, margins, tie


def antipodal_round(g: Grid, draws, *, max_width: float, friction: float,
                    attempts: int, loa_samples: int, frictions,
                    min_contact: float) -> dict:
    """One fixed-budget round and the ladder on its grasps, with the
    round's draws taken from ``draws`` as the system under test takes them:
    configs (N, 10), contacts, normals (N, 2, 3), valid (N,), rung (N,),
    tie (N,)."""
    dt, dev, n = g.dtype, g.dev, attempts
    surface = g.to_world(g.surface)
    idx = draws.surface_index(surface.shape[0], n).to(dev)
    x1 = surface[idx] + g.res / 2.0 * (
        draws.antipodal_perturb(n).to(dev).to(dt) - 0.5)
    n_out, n_ok, n_tie = surface_normal(g, g.to_grid(x1))
    up = torch.zeros_like(n_out)
    up[:, 2] = 1.0
    _, t1, t2 = tangents(torch.where(n_ok[:, None], -n_out, up))
    u_theta, u_r = draws.antipodal_cone(n)
    theta = 2.0 * np.pi * u_theta.to(dev).to(F64)
    r = (friction * u_r.to(dev).to(dt))[:, None]
    v = n_out + r * torch.cos(theta).to(dt)[:, None] * t1 \
        + r * torch.sin(theta).to(dt)[:, None] * t2
    v = -v / norm(v)[:, None]
    v = torch.where((draws.antipodal_flip(n).to(dev) > 0.5)[:, None], -v, v)

    # the pair along the axis: from half a cell behind the point over half
    # the width, and from the far jaw back over the whole width
    width = max_width / g.res
    c1 = g.to_grid(x1) - BACKUP_CELLS * v
    c2 = c1 + (width - BACKUP_CELLS) * v
    full = torch.full((n,), width, dtype=dt, device=dev)
    f1, p1, _ = find_contact(g, line_of_action(c1, v, full, loa_samples))
    f2, p2, _ = find_contact(g, line_of_action(c2, -v, 2.0 * full,
                                               loa_samples))
    _, v1, s1 = contact_normal(g, p1, v)
    _, v2, s2 = contact_normal(g, p2, -v)
    w1, w2 = g.to_world(p1), g.jitter(g.to_world(p2))
    pair = norm(w2 - w1)
    c_ok = f1 & f2 & v1 & v2 & (pair > 0)
    center = (w1 + w2) / 2.0
    axis = (w2 - w1) / pair.clamp(min=1e-12)[:, None]
    configs = torch.cat([center, axis, torch.full((n, 1), max_width,
                                                  dtype=dt, device=dev),
                         torch.zeros((n, 3), dtype=dt, device=dev)], 1)

    cands = torch.tensor(APPROACH_ANGLES, dtype=F64, device=dev)
    angles = cands[draws.approach_perm(n, len(APPROACH_ANGLES)).to(dev)]
    free = approach_free(g, configs, angles, loa_samples)
    found, pts, nrm, f_tie = close_fingers(g, configs, loa_samples)
    first = free.to(torch.int8).argmax(1)
    configs[:, 7] = angles[torch.arange(n, device=dev), first].to(dt)
    gap = norm(x1 - pts[:, 1])
    margin, dist = closure_margin(pts[:, 0], nrm[:, 0], pts[:, 1],
                                  nrm[:, 1], friction)
    reach = n_ok & c_ok & free.any(1) & found & (gap >= min_contact)
    valid = reach & (margin >= 0)
    rung, _, l_tie = ladder(g, configs, frictions, loa_samples)
    tie = (n_tie | (f1 & f2 & (s1 | s2)) | f_tie
           | ((gap - min_contact).abs() < WIDE_TIE)
           | (reach & ((margin.abs() < FC_TIE) | (dist < COINCIDENT_M)))
           | (valid & l_tie))
    return dict(configs=configs, contacts=pts, normals=nrm, valid=valid,
                rung=rung, tie=tie)


def yield_bounds(variants, draws_of, **kw) -> tuple[int, int]:
    """(least, most) labeled grasps of a round: labeled in every variant
    and tie in none; labeled or tie in some. ``draws_of()`` gives the
    round's draws afresh."""
    firm = most = None
    for g in variants:
        r = antipodal_round(g, draws_of(), **kw)
        labeled = r["valid"] & (r["rung"] >= 0)
        f, m = labeled & ~r["tie"], labeled | r["tie"]
        firm = f if firm is None else firm & f
        most = m if most is None else most | m
    return int(firm.sum()), int(most.sum())


def approach_off(variants, configs, order, samples: int):
    """(G,) True where the emitted approach angle (``configs[:, 7]``) is not
    the first collision-free one of the grasp's drawn order (``order`` (G,
    A), world angles): not among the order, colliding in every variant, or
    behind an angle that no variant finds colliding."""
    at = order == configs[:, 7:8]
    k = torch.where(at.any(1), at.to(torch.int8).argmax(1), -1)
    free_any = torch.zeros_like(at)
    hit_any = torch.zeros_like(at)
    for v in variants:
        free = approach_free(v, configs, order, samples)
        free_any, hit_any = free_any | free, hit_any | ~free
    pos = torch.arange(order.shape[1], device=order.device)
    before_hit = (hit_any | (pos >= k[:, None])).all(1)
    first_free = torch.gather(free_any, 1, k.clamp(min=0)[:, None])[:, 0]
    return ~((k >= 0) & first_free & before_hit)


def judge(variants, configs, contacts, normals, rung, order, *,
          max_width: float, friction: float, loa_samples: int, frictions,
          ladder_tol: float) -> dict:
    """Each labeled grasp (configs (G, 10), contacts and outward normals (G,
    2, 3), rung (G,), as emitted; ``order`` (G, A) its drawn approach
    angles) judged by its own configuration. Returns (G,) flags: ``wide``
    (contacts over ``max_width`` apart), ``off_surface`` (a contact whose
    lookup is off the surface), ``unfound`` (no variant's closing finds a
    pair), ``outside_cone`` (an inward normal outside the friction cone
    towards the other contact), ``approach_off`` (see ``approach_off``),
    ``coincident``, and ``rung_off`` (no variant's rung agrees, its margins
    at every friction between the two rungs over ``ladder_tol``)."""
    g = variants[0]
    dist = norm(contacts[:, 1] - contacts[:, 0])
    coincident = dist < COINCIDENT_M
    surf = g(g.to_grid(contacts.reshape(-1, 3))).reshape(-1, 2)
    found_any = torch.zeros_like(coincident)
    agree = torch.zeros_like(coincident)
    j = torch.arange(len(frictions), device=configs.device)
    for v in variants:
        found, _, _, tie = close_fingers(v, configs, loa_samples)
        found_any = found_any | found | tie
        r, margins, tie = ladder(v, configs, frictions, loa_samples)
        lo = torch.minimum(r, rung)[:, None]
        hi = torch.maximum(r, rung)[:, None]
        sep = (j > lo) & (j <= hi)
        near = torch.where(sep, margins.abs(), np.inf).min(1).values
        agree = agree | (r == rung) | tie | (near <= ladder_tol)
    angles = signed_cone_angles(contacts, normals)
    return dict(
        wide=dist > max_width,
        off_surface=(surf.abs() >= g.thresh).any(1),
        unfound=~found_any,
        outside_cone=~coincident & (angles.max(1).values
                                    > float(np.arctan(friction)) + FC_TIE),
        approach_off=approach_off(variants, configs, order, loa_samples),
        coincident=coincident,
        rung_off=~coincident & ~agree)
