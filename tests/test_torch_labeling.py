"""The labeling path's geometry and metrics against the JAX package: SDF
queries, grasp configurations and contact finding, the gripper and the
collision checker, the quality metrics and their batched evaluation.

The JAX side runs jitted in float32 (``jax.enable_x64(False)``, as the
package runs in production) on the same numpy inputs made from a seed.
Tolerances: discrete results (found, valid, force-closure flags, labels)
equal; contact points and configurations within 1e-5 x (1 + |ref|);
normals within 1e-4 on valid lanes with a clear eigengap; epsilons within
rtol 1e-4, atol 1e-6.

One exception, measured and kept: the zero crossing of ``find_contact`` is
Cramer's rule on a 3x3 Vandermonde system and loses digits where the local
quadratic is nearly flat. On those lanes jitted JAX in float32 is itself
more than 1e-5 from the same computation in float64, and its rounding
depends on how XLA fuses the program. There the port must be as close to
the float64 answer as JAX's float32 is (``_assert_points``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnetgpd_tpu.geometry import sdf as jsdf
from pointnetgpd_tpu.grasping import collision_checker as jcc
from pointnetgpd_tpu.grasping import evaluation as jev
from pointnetgpd_tpu.grasping import grasp as jg
from pointnetgpd_tpu.grasping import gripper as jgr
from pointnetgpd_tpu.grasping import quality as jq
from pointnetgpd_tpu.grasping import quality_config as jqc
from pointnetgpd_tpu.grasping import robust_quality as jrq
from pointnetgpd_tpu_torch.geometry import sdf as tsdf
from pointnetgpd_tpu_torch.grasping import collision_checker as tcc
from pointnetgpd_tpu_torch.grasping import evaluation as tev
from pointnetgpd_tpu_torch.grasping import grasp as tg
from pointnetgpd_tpu_torch.grasping import gripper as tgr
from pointnetgpd_tpu_torch.grasping import quality as tq
from pointnetgpd_tpu_torch.grasping import quality_config as tqc
from pointnetgpd_tpu_torch.grasping import robust_quality as trq

DIM, RES = 24, 0.005
POINT_TOL = 1e-5
EPS_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _f32_jax():
    with jax.enable_x64(False):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(t):
    return t.cpu().numpy()


def ellipsoid_data(dim=DIM, res=RES, radii=(0.03, 0.023, 0.0375)):
    """An ellipsoid's approximate SDF (|p / radii| - 1) * min(radii)."""
    origin = -res * (dim - 1) / 2.0 * np.ones(3)
    ii, jj, kk = np.meshgrid(*(np.arange(dim),) * 3, indexing="ij")
    pts = origin + res * np.stack([ii, jj, kk], -1)
    data = (np.linalg.norm(pts / np.asarray(radii), axis=-1) - 1.0) * min(radii)
    return data.astype(np.float32), origin, res


@pytest.fixture(scope="module")
def sdfs():
    data, origin, res = ellipsoid_data()
    with jax.enable_x64(False):
        j = jsdf.make_sdf(data, origin, res)
    return j, tsdf.make_sdf(data, origin, res, device="cpu")


def random_configs(n, seed, width=0.085):
    rs = np.random.RandomState(seed)
    cfg = np.zeros((n, 10), np.float32)
    cfg[:, 0:3] = (rs.rand(n, 3) - 0.5) * 0.03
    ax = rs.randn(n, 3)
    cfg[:, 3:6] = ax / np.linalg.norm(ax, axis=1, keepdims=True)
    cfg[:, 6] = width
    cfg[:, 7] = rs.rand(n) * 3.0
    return cfg


def _spread(fn, x, *rest):
    """How far the float32 answer ``fn(x, *rest)`` (a (G, ...) array of
    JAX's, or a tensor of the port's from a numpy ``x``) moves, per lane,
    when ``x`` moves by one or two ulps: the float32 conditioning of the
    lane."""
    def run(v):
        out = fn(v, *rest)
        return _n(out) if isinstance(out, torch.Tensor) else np.asarray(out)

    want = run(x)
    out = np.zeros(len(want))
    for step in (np.inf, -np.inf, 2.0, -2.0):
        if np.isinf(step):
            xp = np.nextafter(x, np.float32(step)).astype(np.float32)
        else:
            xp = (x * (1 + step * 2.0 ** -23)).astype(np.float32)
        moved = np.abs(run(xp) - want)
        out = np.maximum(out, moved.reshape(len(want), -1).max(axis=1))
    return out


def qhull_eps(rows):
    """Float64 oracle of the force-only Ferrari-Canny epsilon of (G, M, 3)
    rows: scipy's qhull hull of each row set; epsilon is the least distance
    from the origin to a facet plane, 0 unless the origin lies inside by
    more than 1e-10 (a flat or non-finite row set: 0)."""
    from scipy.spatial import ConvexHull, QhullError

    rows = np.asarray(rows, np.float64)
    out = np.zeros(rows.shape[:-2], np.float32)
    for i in np.ndindex(out.shape):
        try:
            margin = -ConvexHull(rows[i]).equations[:, 3].max()
        except (QhullError, ValueError):     # flat, empty or not finite
            continue
        out[i] = margin if margin > 1e-10 else 0.0
    return out


class exact_jax_canny:
    """Within this context the JAX package's force-only metric is the
    float64 oracle ``qhull_eps``, reached from its jitted programs through
    a host callback, and its jit caches are cleared on entry and exit. That
    is the port's metric (float64 on float32 rows). The JAX package computes
    it in float32, where coplanar friction-cone edges are kept or dropped by
    rounding (``test_ferrari_canny_force_only_float32_rounding``)."""

    def __enter__(self):
        def exact(g3):
            return jax.pure_callback(
                lambda g: qhull_eps(g), jax.ShapeDtypeStruct(
                    g3.shape[:-2], jnp.float32), g3,
                vmap_method="expand_dims")

        self.orig = jq.ferrari_canny_l1_force_only
        jq.ferrari_canny_l1_force_only = exact
        jax.clear_caches()
        return self

    def __exit__(self, *exc):
        jq.ferrari_canny_l1_force_only = self.orig
        jax.clear_caches()


def _assert_points(got, want, mask, spread=None):
    """Contact points within 1e-5 x (1 + |ref|), except on the lanes whose
    float32 answer is ill-conditioned: JAX itself moves by more than the
    tolerance under a one- or two-ulp change of its input (``spread``).
    Such lanes are at most 1% of the mask."""
    scale = (1 + np.abs(want)).reshape(len(got), -1).max(axis=1)
    err = np.abs(got - want).reshape(len(got), -1).max(axis=1) / scale
    bad = mask & (err > POINT_TOL)
    if spread is not None and bad.any():
        ill = bad & (spread / scale > POINT_TOL)
        assert ill.sum() <= max(2, mask.sum() // 100)
        bad = bad & ~ill
    assert not bad.any(), (np.where(bad)[0], err.max())


def _assert_stable_lanes(got, want, spread_jax, spread_port, min_stable):
    """Epsilons within EPS_TOL on the lanes whose value is stable, in JAX
    and in the port, under a one- or two-ulp change of the input (all but
    1% of them: the two stacks' inputs differ by a few ulps), and those
    lanes at least ``min_stable`` of all; the means within 2%. The
    force-only metric's support test decides coplanar cone edges with a
    1e-10 relative tolerance, so in float32 a lane's epsilon can move by
    tens of percent under one ulp of input, in JAX itself."""
    tol = EPS_TOL["rtol"] * np.abs(want) + EPS_TOL["atol"]
    stable = (spread_jax <= tol) & (spread_port <= tol)
    assert abs(got.mean() - want.mean()) <= 0.02 * want.mean() + 1e-6
    assert stable.mean() >= min_stable, stable.mean()
    off = stable & (np.abs(got - want) > tol)
    assert off.sum() <= max(1, stable.sum() // 100), np.where(off)[0]


def _clear_gap(jsdf32, coords):
    """Lanes whose plane-fit scatter has its two smallest eigenvalues
    apart (the plane normal is unique there)."""
    offs = jnp.asarray(jsdf._sphere_offsets(1.5))
    pts = coords[:, None, :] + np.asarray(offs)
    vals = np.asarray(jsdf.signed_distance_oob_big(jsdf32, jnp.asarray(pts)))
    mask = np.abs(vals) < float(jsdf32.surface_thresh)
    n = np.maximum(mask.sum(1), 1)[:, None]
    mean = np.where(mask[..., None], pts, 0).sum(1) / n
    c = np.where(mask[..., None], pts - mean[:, None], 0).astype(np.float64)
    w = np.linalg.eigvalsh(np.einsum("npi,npj->nij", c, c))
    return (w[:, 1] - w[:, 0]) > 1e-3 * np.maximum(w[:, 2], 1e-12)


# ---------------------------------------------------------------------------
# SDF queries
# ---------------------------------------------------------------------------

def test_sdf_queries_match_jax(sdfs):
    j, t = sdfs
    rs = np.random.RandomState(0)
    q = (rs.rand(400, 3) * (DIM + 6) - 3).astype(np.float32)   # some OOB
    jit = jax.jit
    np.testing.assert_allclose(_n(tsdf.gradient(t, _t(q))),
                               np.asarray(jit(jsdf.gradient)(j, q)),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(
        _n(tsdf.curvature(t, _t(q), 0.5)),
        np.asarray(jit(jsdf.curvature, static_argnums=2)(j, q, 0.5)),
        rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_n(tsdf.signed_distance(t, _t(q))),
                               np.asarray(jit(jsdf.signed_distance)(j, q)),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(
        _n(tsdf.signed_distance_oob_big(t, _t(q))),
        np.asarray(jit(jsdf.signed_distance_oob_big)(j, q)),
        rtol=1e-6, atol=1e-8)
    on_j, v_j = jit(jsdf.on_surface)(j, q)
    on_t, v_t = tsdf.on_surface(t, _t(q))
    assert (_n(on_t) == np.asarray(on_j)).all()
    d = rs.randn(50, 3).astype(np.float32)
    np.testing.assert_allclose(_n(tsdf.grid_to_world_dir(t, _t(d))),
                               np.asarray(jsdf.grid_to_world_dir(j, d)),
                               rtol=1e-6, atol=1e-7)


def test_surface_normal_matches_jax(sdfs):
    j, t = sdfs
    rs = np.random.RandomState(1)
    surf = np.asarray(j.surface_points)
    q = (surf[rs.randint(0, len(surf), 600)]
         + rs.rand(600, 3).astype(np.float32) - 0.5).astype(np.float32)
    q = np.concatenate([q, (rs.rand(100, 3) * DIM).astype(np.float32)])
    nj, vj = (np.asarray(a) for a in jsdf.surface_normal(j, q))
    nt, vt = (_n(a) for a in tsdf.surface_normal(t, _t(q)))
    assert (vt == vj).all() and vj.sum() > 300
    gap = vj & _clear_gap(j, q)
    assert gap.sum() > 0.9 * vj.sum()
    np.testing.assert_allclose(nt[gap], nj[gap], atol=1e-4)
    assert (nt[~vj] == 0).all()


def test_transform_dense_matches_jax(sdfs):
    j, t = sdfs
    c, s = np.cos(0.3), np.sin(0.3)
    tf = np.eye(4)
    tf[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    tf[:3, 3] = [0.004, -0.002, 0.003]
    want = jsdf.transform_dense(j, tf)
    got = tsdf.transform_dense(t, tf)
    np.testing.assert_allclose(_n(got.data), np.asarray(want.data),
                               rtol=1e-5, atol=1e-7)
    assert got.surface_points.shape == want.surface_points.shape


# ---------------------------------------------------------------------------
# Grasp configurations and contact finding
# ---------------------------------------------------------------------------

def test_configuration_helpers_match_jax():
    rs = np.random.RandomState(2)
    cfg = random_configs(40, 2)
    r = np.linalg.qr(rs.randn(3, 3))[0].astype(np.float32)
    tc = _t(cfg)
    for jf, tf_ in ((jg.t_grasp_obj, tg.t_grasp_obj),
                    (lambda c: jg.rotated_full_axis(c[3:6], c[7]),
                     lambda c: tg.rotated_full_axis(c[..., 3:6], c[..., 7])),
                    (lambda c: jg.parallel_table(c, r),
                     lambda c: tg.parallel_table(c, _t(r))),
                    (lambda c: jg.perpendicular_table(c, r),
                     lambda c: tg.perpendicular_table(c, _t(r))),
                    (lambda c: jnp.stack(jg.grasp_angles_from_stp_z(c, r)),
                     lambda c: torch.stack(tg.grasp_angles_from_stp_z(
                         c, _t(r)), -1)),
                    (lambda c: jnp.stack(jg.endpoints(c)),
                     lambda c: torch.stack(tg.endpoints(c), -2)),
                    (lambda c: jg.grasp_distance(c, c[::-1] * 0 + cfg[0]),
                     lambda c: tg.grasp_distance(c, _t(cfg[0])))):
        want = np.asarray(jax.jit(jax.vmap(jf))(cfg))
        np.testing.assert_allclose(_n(tf_(tc)), want, rtol=1e-5, atol=1e-6)
    g1, g2 = rs.randn(2, 30, 3).astype(np.float32)
    want = np.asarray(jax.vmap(lambda a, b: jg.grasp_from_endpoints(
        a, b, approach_angle=0.3))(g1, g2))
    got = tg.grasp_from_endpoints(_t(g1), _t(g2), approach_angle=0.3)
    np.testing.assert_allclose(_n(got), want, rtol=1e-5, atol=1e-6)
    want = np.asarray(jax.vmap(lambda c, a, w: jg.configuration_from_params(
        c, a, w, 0.2, 0.01, 0.003))(g1, g2, np.abs(g1[:, 0])))
    got = tg.configuration_from_params(_t(g1), _t(g2), _t(np.abs(g1[:, 0])),
                                       0.2, 0.01, 0.003)
    np.testing.assert_allclose(_n(got), want, rtol=1e-5, atol=1e-6)
    for a, b in zip(tg.params_from_configuration(tc),
                    jax.vmap(jg.params_from_configuration)(cfg)):
        np.testing.assert_array_equal(_n(a), np.asarray(b))


@pytest.mark.parametrize("res,width", [(0.005, 0.085), (0.0008, 0.085),
                                       (0.0001, 0.2)])
def test_adaptive_num_samples_matches_jax(res, width):
    class G:
        resolution = res

    assert tg.adaptive_num_samples(G, width) == jg.adaptive_num_samples(
        G, width)


def test_vacuum_helpers_match_jax():
    cfg = tg.vacuum_configuration_from_params([1, 2, 3], [0, 0.6, 0.8])
    np.testing.assert_array_equal(
        cfg, jg.vacuum_configuration_from_params([1, 2, 3], [0, 0.6, 0.8]))
    for a, b in zip(tg.vacuum_params_from_configuration(cfg),
                    jg.vacuum_params_from_configuration(cfg)):
        np.testing.assert_array_equal(a, b)
    for bad in ([0, 0, 2.0],):
        with pytest.raises(ValueError):
            tg.vacuum_configuration_from_params([0, 0, 0], bad)
    with pytest.raises(ValueError):
        tg.vacuum_params_from_configuration(np.zeros(5))


def test_quadratic_zero_crossing_matches_jax():
    rs = np.random.RandomState(3)
    n = 3000
    p0 = (rs.rand(n, 3) * 20).astype(np.float32)
    ax = rs.randn(n, 3)
    ax = (ax / np.linalg.norm(ax, axis=1, keepdims=True)).astype(np.float32)
    p1 = (p0 + 0.7 * ax).astype(np.float32)
    p2 = (p0 + 1.4 * ax).astype(np.float32)
    # well-conditioned quadratics: a clear curvature, a root in [0, 2]
    r = rs.rand(n) * 1.4
    y = np.stack([(t - r) * (1 + 0.5 * t) for t in (0.0, 0.7, 1.4)], 1)
    y = y.astype(np.float32)
    pj, vj = jax.jit(jax.vmap(jg._quadratic_zero_crossing))(
        p0, y[:, 0], p1, y[:, 1], p2, y[:, 2])
    pt, vt = tg._quadratic_zero_crossing(_t(p0), _t(y[:, 0]), _t(p1),
                                         _t(y[:, 1]), _t(p2), _t(y[:, 2]))
    assert (_n(vt) == np.asarray(vj)).all() and 0 < int(vj.sum()) < n
    _assert_points(_n(pt), np.asarray(pj), np.asarray(vj))


def test_find_contact_matches_jax(sdfs):
    j, t = sdfs
    cfg = random_configs(200, 4)
    axis = cfg[:, 3:6]
    start = np.asarray(jsdf.world_to_grid(
        j, cfg[:, 0:3] - 0.0425 * axis)).astype(np.float32)
    loa = np.asarray(jax.vmap(lambda s, a: jg.line_of_action(
        s, a, 0.085 / RES, 40))(start, axis))
    np.testing.assert_allclose(
        _n(tg.line_of_action(_t(start), _t(axis), torch.tensor(0.085 / RES),
                             40)), loa, rtol=1e-6, atol=1e-5)
    fj, pj, sj = (np.asarray(a) for a in jax.jit(jax.vmap(
        jg.find_contact, in_axes=(None, 0)))(j, loa))
    ft, pt, st = (_n(a) for a in tg.find_contact(t, _t(loa)))
    assert (ft == fj).all() and (st == sj).all() and fj.sum() > 50
    fc = jax.jit(jax.vmap(jg.find_contact, in_axes=(None, 0)))
    _assert_points(pt, pj, fj, _spread(lambda x: fc(j, x)[1], loa))


@pytest.mark.parametrize("check_approach", [False, True])
def test_close_fingers_matches_jax(sdfs, check_approach):
    j, t = sdfs
    cfg = random_configs(600, 5)
    kw = dict(num_samples=40, check_approach=check_approach)
    cj = jg.close_fingers(j, jnp.asarray(cfg), **kw)
    ct = tg.close_fingers(t, _t(cfg), **kw)
    found = np.asarray(cj.found)
    assert (_n(ct.found) == found).all() and found.sum() > 100
    spread = _spread(lambda c: jg.close_fingers(j, c, **kw).points, cfg)
    _assert_points(_n(ct.points), np.asarray(cj.points), found, spread)
    np.testing.assert_array_equal(_n(ct.in_directions),
                                  np.asarray(cj.in_directions))
    # normals where the contact points agree and the plane fit has a gap
    same = found & (np.abs(_n(ct.points) - np.asarray(cj.points)).max(
        axis=(1, 2)) <= POINT_TOL)
    pts_grid = (np.asarray(cj.points) - np.asarray(j.origin)) / RES
    gap = same & _clear_gap(j, pts_grid[:, 0]) & _clear_gap(j, pts_grid[:, 1])
    np.testing.assert_allclose(_n(ct.normals)[gap],
                               np.asarray(cj.normals)[gap], atol=1e-4)


def test_approach_collision_free_matches_jax(sdfs):
    j, t = sdfs
    cfg = random_configs(100, 6)
    angles = np.tile(np.arange(-90, 120, 30, dtype=np.float32), (100, 1))
    want = np.asarray(jax.vmap(lambda c, a: jg.approach_collision_free(
        j, c, a, num_samples=40))(cfg, angles))
    got = _n(tg.approach_collision_free(t, _t(cfg), _t(angles),
                                        num_samples=40))
    assert (got == want).all() and 0 < want.sum() < want.size


def test_grasp_from_contact_and_axis_matches_jax(sdfs):
    j, t = sdfs
    rs = np.random.RandomState(7)
    surf = np.asarray(jsdf.grid_to_world(j, j.surface_points))
    c1 = surf[rs.randint(0, len(surf), 300)].astype(np.float32)
    ax = rs.randn(300, 3).astype(np.float32)
    # contacts at least 2.5 mm apart, as the antipodal sampler keeps them
    # (min_contact_dist): nearer pairs give an ill-conditioned axis
    cj, conj, vj = jax.vmap(lambda c, a: jg.grasp_from_contact_and_axis(
        j, c, a, 0.085, num_samples=40, min_width_world=0.0025))(c1, ax)
    ct, cont, vt = tg.grasp_from_contact_and_axis(
        t, _t(c1), _t(ax), 0.085, num_samples=40, min_width_world=0.0025)
    vj = np.asarray(vj)
    assert (_n(vt) == vj).all() and vj.sum() > 50
    fn = jax.vmap(lambda c, a: jg.grasp_from_contact_and_axis(
        j, c, a, 0.085, num_samples=40, min_width_world=0.0025))
    _assert_points(_n(cont.points), np.asarray(conj.points), vj,
                   _spread(lambda c: fn(c, ax)[1].points, c1))
    _assert_points(_n(ct), np.asarray(cj), vj,
                   _spread(lambda c: fn(c, ax)[0], c1))


# ---------------------------------------------------------------------------
# Gripper and collision checker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["robotiq_85", "baxter", "yumi_metal_spline"])
def test_named_grippers_match_jax(name, tmp_path):
    assert tgr.Gripper.named(name).__dict__ == jgr.Gripper.named(name).__dict__
    for k, v in tgr.named_transforms(name).items():
        np.testing.assert_array_equal(v, jgr.named_transforms(name)[k])
    cfg = random_configs(5, 8)[0].astype(np.float64)
    tf = tgr.named_transforms(name)["t_grasp_gripper"]
    np.testing.assert_allclose(
        tgr.Gripper.named(name).gripper_pose(cfg, tf),
        np.asarray(jgr.Gripper.named(name).gripper_pose(jnp.asarray(cfg), tf)),
        atol=1e-6)
    path = tmp_path / "params.json"
    path.write_text('{"max_width": 0.07, "finger_width": 0.02, "x": 1}')
    assert (tgr.Gripper.from_json(str(path)).__dict__
            == jgr.Gripper.from_json(str(path)).__dict__)
    with pytest.raises(KeyError):
        tgr.Gripper.named("nope")


def test_collides_with_table_matches_jax():
    cfg = random_configs(30, 9)
    cfg[:, 2] = np.linspace(-0.1, 0.2, 30)
    g = tgr.Gripper()
    jgrip = jgr.Gripper()
    got = [g.collides_with_table(c, 0.0, 0.01) for c in cfg]
    want = [jgrip.collides_with_table(c, 0.0, 0.01) for c in cfg]
    assert got == want and 0 < sum(got) < len(got)


def test_box_counts_match_jax():
    rs = np.random.RandomState(10)
    pts = (rs.rand(400, 3) - 0.5).astype(np.float32) * 0.3
    frames = (rs.randn(8, 4, 3) * 0.02).astype(np.float32)
    frames[:, 1:] = np.linalg.qr(rs.randn(8, 3, 3))[0].transpose(0, 2, 1)
    boxes = jgr.panel_box_array(jgr.Gripper()).astype(np.float32)
    pf_j = np.asarray(jax.vmap(lambda f: jgr.points_in_frame(
        f[0], f[1], f[2], f[3], pts))(frames))
    ft = _t(frames)
    pf_t = _n(tgr.points_in_frame(ft[:, 0], ft[:, 1], ft[:, 2], ft[:, 3],
                                  _t(pts)))
    np.testing.assert_allclose(pf_t, pf_j, rtol=1e-6, atol=1e-7)
    want = np.asarray(jax.vmap(lambda p: jgr.collision_and_open_counts(
        p, boxes))(pf_j))
    got = _n(tgr.collision_and_open_counts(_t(pf_j), _t(boxes)))
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0
    np.testing.assert_array_equal(
        _n(tgr.count_in_box(_t(pf_j), boxes[0, 0], boxes[0, 1])),
        np.asarray(jax.vmap(lambda p: jgr.count_in_box(
            p, boxes[0, 0], boxes[0, 1]))(pf_j)))


def test_collision_checker_matches_jax(sdfs):
    j, t = sdfs
    rs = np.random.RandomState(11)
    cj, ct = jcc.GraspCollisionChecker(), tcc.GraspCollisionChecker(
        device="cpu")
    pose = np.eye(4)
    pose[:3, 3] = [0.0, 0.0, 0.04]
    cj.set_graspable_object(j, pose)
    ct.set_graspable_object(t, pose)
    cloud = (rs.rand(50, 3) * 0.05).astype(np.float32)
    cj.add_graspable_object(cloud)
    ct.add_graspable_object(cloud)
    np.testing.assert_allclose(ct.scene_points, cj.scene_points, rtol=1e-6,
                               atol=1e-8)
    frames = np.zeros((60, 5, 3), np.float32)
    frames[:, 0] = (rs.rand(60, 3) - 0.5) * 0.3 + [0, 0, 0.05]
    frames[:, 1:4] = np.linalg.qr(rs.randn(60, 3, 3))[0].transpose(0, 2, 1)
    for table in (None, 0.0):
        if table is not None:
            cj.set_table(table)
            ct.set_table(table)
        want = cj.grasps_in_collision(frames)
        assert (ct.grasps_in_collision(frames) == want).all()
        assert 0 < want.sum() < len(want)
    assert (ct.collides_along_approach(frames[3], 0.05)
            == cj.collides_along_approach(frames[3], 0.05))
    assert ct.grasp_in_collision(frames[0]) == cj.grasp_in_collision(frames[0])


# ---------------------------------------------------------------------------
# Quality metrics
# ---------------------------------------------------------------------------

def _contact_pairs(n, seed):
    rs = np.random.RandomState(seed)
    p1 = rs.randn(n, 3).astype(np.float32) * 0.02
    d = rs.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p2 = (p1 + 0.05 * d).astype(np.float32)
    tilt = rs.randn(2, n, 3) * rs.rand(1, n, 1) * 1.5
    n1 = -d + tilt[0]
    n2 = d + tilt[1]
    n1 /= np.linalg.norm(n1, axis=1, keepdims=True)
    n2 /= np.linalg.norm(n2, axis=1, keepdims=True)
    return p1, n1.astype(np.float32), p2, n2.astype(np.float32)


def test_force_closure_matches_jax():
    p1, n1, p2, n2 = _contact_pairs(3000, 12)
    mu = np.random.RandomState(13).rand(3000).astype(np.float32) * 2
    p2[:5] = p1[:5]
    want = np.asarray(jax.jit(jax.vmap(jq.force_closure))(p1, n1, p2, n2, mu))
    got = _n(tq.force_closure(*map(_t, (p1, n1, p2, n2, mu))))
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(want) and (want[:5] == 0).all()


def test_cones_and_wrench_basis_match_jax():
    rs = np.random.RandomState(14)
    d = rs.randn(200, 3).astype(np.float32)
    for a, b in zip(tq.tangents_from_direction(_t(d)),
                    jax.vmap(jq.tangents_from_direction)(d)):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    mu = rs.rand(200).astype(np.float32)
    np.testing.assert_allclose(
        _n(tq.friction_cone(_t(d), _t(mu), 8)),
        np.asarray(jax.vmap(lambda x, m: jq.friction_cone(x, m, 8))(d, mu)),
        rtol=1e-5, atol=1e-6)
    f = rs.randn(16, 3).astype(np.float32)
    arm = rs.randn(3).astype(np.float32)
    np.testing.assert_allclose(_n(tq.torques_from_forces(_t(arm), _t(f))),
                               np.asarray(jq.torques_from_forces(arm, f)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        _n(tq.normal_force_magnitude(_t(d), _t(f[:1]).expand(200, 3))),
        np.asarray(jax.vmap(jq.normal_force_magnitude, (0, None))(d, f[0])),
        rtol=1e-5, atol=1e-6)
    for soft in (False, True):
        np.testing.assert_allclose(
            _n(tq.grasp_matrix(_t(f), _t(f[::-1]), _t(d[:2]),
                               torque_scaling=3.0, soft_fingers=soft)),
            np.asarray(jq.grasp_matrix(f, f[::-1], d[:2], torque_scaling=3.0,
                                       soft_fingers=soft)),
            rtol=1e-5, atol=1e-6)


def _wrench_sets(g, m, seed, d=3):
    rs = np.random.RandomState(seed)
    w = rs.randn(g, m, d).astype(np.float32)
    w[: g // 3] += 1.5 * rs.randn(g // 3, 1, d).astype(np.float32)
    return w


def _assert_iterate(got, want, want64):
    """A fixed-count FISTA min norm sqrt(x'Gx): within EPS_TOL where the
    hull is well away from the origin (norm > 0.1). Smaller norms come
    after cancellation in x'Gx, and where the origin is inside the hull the
    iterates are rounding noise; there both float32 answers lie within
    3e-4 of each other, the float32 noise floor of these sets, and on the
    same side of the 6-D metric's 1e-3 guard."""
    far = want64 > 0.1
    np.testing.assert_allclose(got[far], want[far], **EPS_TOL)
    assert (np.abs(got - want)[~far] <= 3e-4).all()
    assert ((got <= 1e-3) == (want <= 1e-3)).all()
    assert far.sum() >= len(far) // 4


@pytest.mark.parametrize("batch", [False, True])
def test_min_norm_in_simplex_matches_jax(batch):
    w = _wrench_sets(40, 16, 15, d=6)
    if batch:
        def fn(v):
            return jq.min_norm_in_simplex_batch(v, num_iters=300)
        mt, xt = tq.min_norm_in_simplex_batch(_t(w), num_iters=300)
    else:
        def fn(v):
            return jax.vmap(lambda u: jq.min_norm_in_simplex(
                u, num_iters=200))(v)
        mt, xt = tq.min_norm_in_simplex(_t(w), num_iters=200)
    mj, xj = (np.asarray(a) for a in fn(w))
    with jax.enable_x64(True):
        m64 = np.asarray(fn(jnp.asarray(w, jnp.float64))[0])
    _assert_iterate(_n(mt), mj, m64)
    assert (mj <= 1e-3).sum() >= 3


def test_closest_point_on_triangle_matches_jax():
    """Against jitted JAX on triangles and points; on degenerate segments
    against the oracle's own arithmetic (eager), whose edge priority the
    port keeps (edge bc last). Under ``jit`` XLA contracts va = d3 d6 -
    d5 d4 into an FMA, so a b == c segment no longer has va == 0 and moves
    to another region; the 3-D metric masks degenerate facets either way
    (``nondegenerate``)."""
    rs = np.random.RandomState(16)
    tri = rs.randn(3, 2000, 3).astype(np.float32)
    tri[:, :50, :] = tri[0, :50]                    # points
    tri[2, 50:100] = tri[1, 50:100]                 # b == c segments
    tri[1, 100:150] = tri[0, 100:150]               # a == b segments
    fn = jax.vmap(jq.closest_point_on_triangle_to_origin)
    got = _n(tq.closest_point_on_triangle_to_origin(*map(_t, tri)))
    want = np.asarray(jax.jit(fn)(*tri))
    keep = np.r_[0:50, 150:2000]
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-5, atol=1e-7)
    want = np.asarray(fn(*tri[:, 50:150]))
    np.testing.assert_allclose(got[50:150], want, rtol=1e-5, atol=1e-7)


def jax_canny64(rows):
    """The JAX package's force-only metric run in float64 on the rows."""
    with jax.enable_x64(True):
        return np.asarray(jax.jit(jax.vmap(jq.ferrari_canny_l1_force_only))(
            jnp.asarray(rows, jnp.float64))).astype(np.float32)


def test_ferrari_canny_force_only_matches_jax():
    """The port runs the metric in float64 (see
    ``test_ferrari_canny_force_only_float32_rounding``): equal to the JAX
    package's metric run in float64 and to the qhull oracle."""
    w = _wrench_sets(60, 16, 17)
    w[5] = w[5] * [1, 1, 0]                          # coplanar: 0
    w[6] = np.abs(w[6])                              # origin outside: 0
    want = jax_canny64(w)
    got = _n(tq.ferrari_canny_l1_force_only(_t(w)))
    np.testing.assert_allclose(got, want, **EPS_TOL)
    np.testing.assert_allclose(got, qhull_eps(w), **EPS_TOL)
    assert (want > 0).sum() > 10 and want[5] == 0 and want[6] == 0


def _cone_rows(g, seed):
    """Force rows of two 8-edge friction cones at nearly opposite contacts,
    mu from the 'less' ladder, each cone scaled by its normal force: the
    rows the dataset's label metric sees."""
    rs = np.random.RandomState(seed)
    n1 = rs.randn(g, 3)
    n2 = -n1 / np.linalg.norm(n1, axis=1, keepdims=True) + 0.2 * rs.randn(g, 3)
    mu = _t(rs.choice([2.0, 1.6, 0.6], g).astype(np.float32))
    cones = [tq.friction_cone(_t(n.astype(np.float32)), mu)
             * _t(rs.uniform(0.1, 1.0, (g, 1, 1)).astype(np.float32))
             for n in (n1, n2)]
    return _n(torch.cat(cones, dim=1))


@pytest.mark.parametrize("kind", ["cones", "random"])
def test_ferrari_canny_force_only_float32_rounding(kind):
    """The support test compares every point's offset from a triple's plane,
    the triple's own three included, with a 1e-10 relative tolerance, far
    below float32 rounding; on friction cones each cone's edges also end on
    one plane. So the JAX package's float32 metric keeps or drops true hull
    facets by rounding and comes out high on many lanes, never low here.
    The port computes the metric in float64: equal, on every lane, to the
    JAX metric run in float64 and to the qhull oracle."""
    rows = _cone_rows(200, 31) if kind == "cones" else _wrench_sets(200, 16,
                                                                      32)
    exact = qhull_eps(rows)
    got = _n(tq.ferrari_canny_l1_force_only(_t(rows)))
    np.testing.assert_allclose(got, exact, **EPS_TOL)
    np.testing.assert_allclose(got, jax_canny64(rows), **EPS_TOL)
    j32 = np.asarray(jax.jit(jax.vmap(jq.ferrari_canny_l1_force_only))(rows))
    tol = EPS_TOL["rtol"] * exact + EPS_TOL["atol"]
    assert (j32 >= exact - tol).all()
    assert (j32 > exact + tol).sum() >= 10
    assert (exact > 0).sum() >= 40


def _g6(g, seed):
    """Wrench rows of an antipodal contact pair plus a third contact, each
    with an 8-face cone at mu 0.5 and torques scaled by 10: full-rank hulls
    with the origin inside (epsilon about 0.04-0.06)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(g):
        p = rng.randn(3)
        p = 0.05 * p / np.linalg.norm(p)
        q = rng.randn(3)
        rows = []
        for pt in (p, -p, 0.05 * q / np.linalg.norm(q)):
            n = -pt / np.linalg.norm(pt) + 0.1 * rng.randn(3)
            n /= np.linalg.norm(n)
            t1 = np.cross(n, [1.0, 0, 0])
            t1 /= np.linalg.norm(t1)
            t2 = np.cross(n, t1)
            for j in range(8):
                th = 2 * np.pi * j / 8
                f = n + 0.5 * (np.cos(th) * t1 + np.sin(th) * t2)
                rows.append(np.concatenate([f, 10.0 * np.cross(pt, f)]))
        out.append(rows)
    return np.asarray(out, np.float32)


def test_solve_and_boundary_distance_match_jax():
    rs = np.random.RandomState(18)
    p = rs.randn(500, 6, 6).astype(np.float32)
    p[:3] = 0                                        # singular
    want = np.asarray(jq._solve_ones_batched(p))
    got = _n(tq._solve_ones_batched(_t(p)))
    fin = np.isfinite(want).all(1)
    assert (np.isfinite(got).all(1) == fin).all() and not fin[:3].any()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-3, atol=1e-4)
    g6 = _g6(4, 19)
    want = np.asarray(jax.vmap(jq._boundary_distance_6d)(g6))
    got = _n(tq._boundary_distance_6d(_t(g6)))
    np.testing.assert_allclose(got, want, **EPS_TOL)


def test_ferrari_canny_6d_matches_jax():
    g6 = _g6(12, 20)
    valid = np.ones(12, bool)
    valid[3] = False
    want = np.asarray(jq.ferrari_canny_l1_device_batch(g6, valid))
    got = _n(tq.ferrari_canny_l1_device_batch(_t(g6), _t(valid), group=5))
    np.testing.assert_allclose(got, want, **EPS_TOL)
    assert want[3] == 0 and (want > 0).sum() >= 3
    i = int(np.argmax(want))
    np.testing.assert_allclose(_n(tq.ferrari_canny_l1_device(_t(g6[i]))),
                               np.asarray(jq.ferrari_canny_l1_device(g6[i])),
                               **EPS_TOL)
    np.testing.assert_allclose(
        tq.ferrari_canny_l1(g6[i], device="cpu"), jq.ferrari_canny_l1(g6[i]),
        **EPS_TOL)
    assert tq.ferrari_canny_l1(np.abs(g6[i]), device="cpu") == 0.0
    with pytest.raises(ValueError):
        tq._six_subsets(41)


def test_spectral_and_span_metrics_match_jax():
    rs = np.random.RandomState(21)
    g = rs.randn(6, 12).astype(np.float32)
    for jf, tf_ in ((jq.min_singular, tq.min_singular),
                    (jq.wrench_volume, tq.wrench_volume),
                    (jq.grasp_isotropy, tq.grasp_isotropy)):
        np.testing.assert_allclose(_n(tf_(_t(g))), np.asarray(jf(g)),
                                   rtol=1e-4, atol=1e-6)
    basis = rs.randn(8, 6).astype(np.float32)
    w = rs.randn(8).astype(np.float32)
    for target in (np.abs(w[:8]) @ basis * 0.3, rs.randn(6) * 5):
        target = target.astype(np.float32)
        for fn in ("partial_closure", "wrench_resistance"):
            np.testing.assert_allclose(
                _n(getattr(tq, fn)(_t(basis), _t(target), 2.0, 2)),
                np.asarray(getattr(jq, fn)(basis, target, 2.0, 2)),
                rtol=1e-3, atol=1e-5)
    for rows in (basis, _g6(1, 22)[0]):
        assert (int(tq.force_closure_qp(_t(rows)))
                == int(jq.force_closure_qp(rows)))


# ---------------------------------------------------------------------------
# Batched evaluation
# ---------------------------------------------------------------------------

def test_ladders_match_jax():
    np.testing.assert_array_equal(tev.FC_LIST_LESS_CLASS,
                                  jev.FC_LIST_LESS_CLASS)
    np.testing.assert_array_equal(tev.FC_LIST_FULL, jev.FC_LIST_FULL)


def _sphere_configs(sdfs, n, seed):
    """Grasps across the ellipsoid's center, some off-center: force closure
    at some frictions only."""
    cfg = random_configs(n, seed)
    cfg[:, 0:3] *= 0.6
    return cfg


def test_friction_boundary_labels_match_jax(sdfs):
    j, t = sdfs
    cfg = _sphere_configs(sdfs, 400, 23)
    fc = jev.FC_LIST_FULL.astype(np.float32)
    want = [np.asarray(a) for a in jev.friction_boundary_labels(
        j, jnp.asarray(cfg), jnp.asarray(fc), num_samples=40, n_fc=len(fc))]
    got = [_n(a) for a in tev.friction_boundary_labels(
        t, _t(cfg), _t(fc), num_samples=40, n_fc=len(fc))]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[0], want[0])
    assert len(np.unique(want[1])) >= 4


def test_force_closure_and_canny_evaluation_match_jax(sdfs):
    j, t = sdfs
    cfg = _sphere_configs(sdfs, 300, 24)
    com = np.array([0.001, -0.002, 0.0], np.float32)
    mu = np.random.RandomState(25).rand(300).astype(np.float32) * 2
    fj, cj = jev.evaluate_force_closure(j, jnp.asarray(cfg), jnp.asarray(mu),
                                        num_samples=40)
    ft, ct = tev.evaluate_force_closure(t, _t(cfg), _t(mu), num_samples=40)
    np.testing.assert_array_equal(_n(ft), np.asarray(fj))
    assert 0 < int(fj.sum()) < 300
    cwj = jev.contact_wrenches(cj, com, 0.8)
    cwt = tev.contact_wrenches(ct, com, 0.8)
    np.testing.assert_array_equal(_n(cwt.valid), np.asarray(cwj.valid))
    # rows of lanes whose contacts agree (see _assert_points)
    same = np.asarray(cwj.valid) & (np.abs(
        _n(ct.normals) - np.asarray(cj.normals)).max(axis=(1, 2)) < 1e-5)
    assert same.sum() > 0.9 * np.asarray(cwj.valid).sum()
    for a, b in zip(cwt[:3], cwj[:3]):
        np.testing.assert_allclose(_n(a)[same], np.asarray(b)[same],
                                   rtol=1e-4, atol=1e-5)

    def canny(c):
        return jev.evaluate_ferrari_canny(j, c, com, jnp.asarray(mu),
                                          num_samples=40)[0]

    def canny_t(c):
        return tev.evaluate_ferrari_canny(t, _t(c), com, _t(mu),
                                          num_samples=40)[0]

    with exact_jax_canny():
        qj = np.asarray(canny(jnp.asarray(cfg)))
        spread_j = _spread(canny, cfg)
    _assert_stable_lanes(_n(canny_t(cfg)), qj, spread_j,
                         _spread(canny_t, cfg), 0.9)
    assert (qj > 0).sum() > 20
    # the metric alone, on JAX's own wrench rows: equal inputs, equal
    # answers
    rows = np.asarray(jev.contact_wrenches(cj, com, 0.8).forces)
    got = _n(tq.ferrari_canny_l1_force_only(_t(rows)))
    np.testing.assert_allclose(got, jax_canny64(rows), **EPS_TOL)
    np.testing.assert_allclose(got, qhull_eps(rows), **EPS_TOL)


def test_ferrari_canny_6d_evaluation_matches_jax(sdfs):
    """Two contacts without soft fingers never resist torque about the
    grasp axis, so the 6-D epsilon of a parallel-jaw grasp is 0 in exact
    arithmetic and float32 leaves noise (about 1e-8, now and then more):
    stable lanes within EPS_TOL."""
    j, t = sdfs
    cfg = _sphere_configs(sdfs, 24, 26)
    com = np.zeros(3, np.float32)

    def eps6(c):
        return jev.evaluate_ferrari_canny_6d(j, c, com, 2.0, num_samples=40,
                                             torque_scaling=10.0)[0]

    def eps6_t(c):
        return tev.evaluate_ferrari_canny_6d(t, _t(c), com, 2.0,
                                             num_samples=40,
                                             torque_scaling=10.0)[0]

    qj = np.asarray(eps6(jnp.asarray(cfg)))
    qt = _n(eps6_t(cfg))
    tol = EPS_TOL["rtol"] * np.abs(qj) + EPS_TOL["atol"]
    stable = (_spread(eps6, cfg) <= tol) & (_spread(eps6_t, cfg) <= tol)
    assert stable.mean() >= 0.75
    np.testing.assert_allclose(qt[stable], qj[stable], **EPS_TOL)
    assert (qj < 1e-3).all()


def test_expected_quality_and_quality_functions_match_jax(sdfs):
    """Force closure exactly; the Ferrari-Canny values, with the JAX
    package's metric computed as the port computes it
    (``exact_jax_canny``), within EPS_TOL per grasp and their means within
    2%."""
    j, t = sdfs
    cfg = _sphere_configs(sdfs, 6, 27)
    com = np.zeros(3, np.float32)
    for metric in ("force_closure", "ferrari_canny_l1_force_only"):
        with exact_jax_canny():
            want = jrq.expected_quality(j, cfg, com, metric=metric,
                                        num_quality_samples=8,
                                        rng=np.random.RandomState(3))
        got = trq.expected_quality(t, cfg, com, metric=metric,
                                   num_quality_samples=8,
                                   rng=np.random.RandomState(3))
        if metric == "force_closure":
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_allclose(got[0], want[0], **EPS_TOL)
            assert abs(got[0].mean() - want[0].mean()) <= 0.02 * want[0].mean()
    base = dict(friction_coef=0.8, num_cone_faces=8, soft_fingers=False,
                check_approach=False, all_contacts_required=True)
    for method in ("force_closure", "ferrari_canny_L1_force_only"):
        cfg_d = dict(base, quality_method=method, quality_type="quasi_static")
        fj = jqc.GraspQualityFunctionFactory.create_quality_function(
            j, com, jqc.GraspQualityConfigFactory.create_config(cfg_d))
        ft = tqc.GraspQualityFunctionFactory.create_quality_function(
            t, com, tqc.GraspQualityConfigFactory.create_config(cfg_d))
        got = np.array([r.quality for r in ft(cfg)])
        with exact_jax_canny():
            want = np.array([r.quality for r in fj(cfg)])
        np.testing.assert_allclose(got, want, **EPS_TOL)
        assert (want > 0).any()
