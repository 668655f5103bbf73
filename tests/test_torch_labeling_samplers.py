"""The labeling path's samplers and pipelines against the JAX package:
antipodal / uniform / Gaussian sampling, the SDF GPG samplers (kernel K1 on
its plain route here), dedupe and the sampling loops, ``generate_dataset``
end to end and the ground-truth pipeline.

JAX's PRNG cannot be reproduced in torch: ``LabelJaxDraws`` derives every
draw the way the JAX package does (same keys, same calls, under the same
``vmap``) and the port takes them as injected draws. The JAX side runs
jitted in float32, as in ``tests/test_torch_labeling.py``, whose helpers
(and tolerances) this file shares.
"""

import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnetgpd_tpu.geometry import sdf as jsdf
from pointnetgpd_tpu.geometry.io import write_obj as jwrite_obj
from pointnetgpd_tpu.geometry.io import write_sdf as jwrite_sdf
from pointnetgpd_tpu.grasping import grasp as jg
from pointnetgpd_tpu.grasping import gripper as jgr
from pointnetgpd_tpu.grasping import samplers as js
from pointnetgpd_tpu.pipelines import generate_dataset as jgen
from pointnetgpd_tpu.pipelines import ground_truth as jgt
from pointnetgpd_tpu_torch.geometry import sdf as tsdf
from pointnetgpd_tpu_torch.grasping import gripper as tgr
from pointnetgpd_tpu_torch.grasping import samplers as ts
from pointnetgpd_tpu_torch.ops import gpg_counts as k1
from pointnetgpd_tpu_torch.pipelines import generate_dataset as tgen
from pointnetgpd_tpu_torch.pipelines import ground_truth as tgt

from test_torch_labeling import (EPS_TOL, POINT_TOL, _assert_points,
                                 _assert_stable_lanes, _n, _spread, _t,
                                 ellipsoid_data, exact_jax_canny)


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


class LabelJaxDraws:
    """The JAX package's draws under ``key`` for the labeling path's
    samplers (``grasping/samplers.py``), for injection into the port."""

    def __init__(self, key):
        self.key = key

    def next_round(self):
        self.key, sub = jax.random.split(self.key)
        return LabelJaxDraws(sub)

    # antipodal_sample_grasps: split(key, 5), then per-attempt keys
    def _k(self, i, n=5):
        return jax.random.split(self.key, n)[i]

    def surface_index(self, n_surface, n):
        return _t(jax.random.randint(self._k(0), (n,), 0, n_surface))

    def antipodal_perturb(self, n):
        return _t(jax.random.uniform(self._k(1), (n, 3)))

    def antipodal_cone(self, n):
        def one(k):
            k_t, k_r = jax.random.split(k)
            return jax.random.uniform(k_t, ()), jax.random.uniform(k_r, ())

        th, r = jax.vmap(one)(jax.random.split(self._k(2), n))
        return _t(th), _t(r)

    def antipodal_flip(self, n):
        return _t(jax.vmap(lambda k: jax.random.uniform(k, ()))(
            jax.random.split(self._k(3), n)))

    def approach_perm(self, n, a):
        return _t(jax.vmap(lambda k: jax.random.permutation(k, a))(
            jax.random.split(self._k(4), n)))

    # uniform: split(key, 3); gaussian: split(key)
    def uniform_pairs(self, n_surface, n):
        return (_t(jax.random.randint(self._k(0, 3), (n,), 0, n_surface)),
                _t(jax.random.randint(self._k(1, 3), (n,), 0, n_surface)))

    def approach_choice(self, n, a):
        return _t(jax.random.randint(self._k(2, 3), (n,), 0, a))

    def gaussian_normals(self, n):
        return (_t(jax.random.normal(self._k(0, 2), (n, 3))),
                _t(jax.random.normal(self._k(1, 2), (n, 3))))


class SdfGpgJaxDraws:
    """Draws of ``gpg_sample_grasps_sdf`` (``split(key)``: the surface
    subset, then the GPG key) or, with ``point=True``, of
    ``point_sample_grasps_sdf`` (``split(key, 3)``: subset, height bias,
    GPG key)."""

    def __init__(self, key, point=False):
        ks = jax.random.split(key, 3 if point else 2)
        self.k_pts, self.k_gpg = ks[0], ks[-1]
        self.k_bias = ks[1] if point else None

    def surface_subset(self, n, k):
        return _t(jax.random.choice(self.k_pts, n, (k,), replace=False))

    def height_bias(self):
        return _t(jax.random.normal(self.k_bias, ()))

    def seed_uniform(self, p, minval=0.0, maxval=1.0):
        k_seed, _ = jax.random.split(self.k_gpg)
        return _t(jax.random.uniform(k_seed, (p,), minval=minval,
                                     maxval=maxval))


def sphere_data(dim=24, res=0.005, r=0.03):
    origin = -res * (dim - 1) / 2.0 * np.ones(3)
    ii, jj, kk = np.meshgrid(*(np.arange(dim),) * 3, indexing="ij")
    pts = origin + res * np.stack([ii, jj, kk], -1)
    return (np.linalg.norm(pts, axis=-1) - r).astype(np.float32), origin, res


@pytest.fixture(scope="module")
def ellipsoid():
    data, origin, res = ellipsoid_data()
    with jax.enable_x64(False):
        j = jsdf.make_sdf(data, origin, res)
        nudged = _nudged(data, origin, res)
    return j, tsdf.make_sdf(data, origin, res, device="cpu"), nudged


def _nudged(data, origin, res):
    """The JAX SDF with its values, its origin or its resolution moved by
    one ulp either way."""
    up, down = np.float32(np.inf), np.float32(-np.inf)
    o32, r32 = np.float32(origin), np.float32(res)
    return [jsdf.make_sdf(np.nextafter(data, s), origin, res)
            for s in (up, down)] + [
        jsdf.make_sdf(data, np.nextafter(o32, s), res) for s in (up, down)
    ] + [jsdf.make_sdf(data, origin, np.nextafter(r32, s)) for s in (up, down)]


def _unstable(run, nudged, want):
    """Lanes of a sampler whose JAX result moves under a one-ulp change of
    the SDF (``_nudged``): the valid flag flips, or a config or contact of a valid lane
    moves by more than the tolerance. Contact search and the random
    antipodal axis are ill-conditioned there (a zero crossing on a nearly
    flat quadratic, an axis between two nearly equal contacts), so JAX's
    float32 answer on them is rounding."""
    valid = np.asarray(want.valid)
    out = np.zeros(len(valid), bool)
    for sdf in nudged:
        other = run(sdf)
        out |= np.asarray(other.valid) != valid
        for a, b in ((other.configs, want.configs),
                     (other.contacts, want.contacts)):
            a, b = np.asarray(a), np.asarray(b)
            err = (np.abs(a - b) / (1 + np.abs(b))).reshape(len(b), -1)
            out |= valid & (err.max(axis=1) > POINT_TOL)
    return out


def _assert_sampled(got, want, unstable, max_unstable=0.1):
    """Valid flags equal, configs and contacts within 1e-5 x (1 + |ref|),
    on every lane that is stable under a one-ulp change of the SDF
    (``_unstable``); such
    lanes at least 1 - max_unstable of all."""
    valid = np.asarray(want.valid)
    assert unstable.mean() <= max_unstable, unstable.mean()
    off = (_n(got.valid) != valid) & ~unstable
    assert not off.any(), np.where(off)
    for a, b in ((got.configs, want.configs), (got.contacts, want.contacts)):
        _assert_points(_n(a), np.asarray(b), valid & ~unstable)
    return valid


# ---------------------------------------------------------------------------
# Antipodal / uniform / Gaussian samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("random_angle", [True, False])
def test_antipodal_sample_grasps_match_jax(ellipsoid, random_angle):
    j, t, nudged = ellipsoid
    key = jax.random.PRNGKey(3)
    kw = dict(max_width=0.085, friction_coef=2.0, num_attempts=128,
              num_samples_loa=40, random_approach_angle=random_angle)

    def run(sdf):
        return js.antipodal_sample_grasps(sdf, key, **kw)

    want = run(j)
    got = ts.antipodal_sample_grasps(t, LabelJaxDraws(key), **kw)
    valid = _assert_sampled(got, want, _unstable(run, nudged, want))
    assert valid.sum() > 20
    # the approach angles are drawn candidates, used as radians
    assert set(np.unique(_n(got.configs)[valid, 7])) <= set(
        js.APPROACH_ANGLE_CANDIDATES.tolist() if random_angle else [0.0])


def test_uniform_and_gaussian_samplers_match_jax(ellipsoid):
    j, t, nudged = ellipsoid
    key = jax.random.PRNGKey(4)

    def uniform(sdf):
        return js.uniform_sample_grasps(sdf, key, max_width=0.085,
                                        num_attempts=200)

    want = uniform(j)
    got = ts.uniform_sample_grasps(t, LabelJaxDraws(key), max_width=0.085,
                                   num_attempts=200)
    assert _assert_sampled(got, want, _unstable(
        uniform, nudged, want)).sum() > 10
    com, dims = np.zeros(3, np.float32), np.array([0.06, 0.046, 0.075])

    def gaussian(sdf):
        return js.gaussian_sample_grasps(
            sdf, key, max_width=0.085, center_of_mass=com,
            principal_dims=dims, num_attempts=200)

    want = gaussian(j)
    got = ts.gaussian_sample_grasps(t, LabelJaxDraws(key), max_width=0.085,
                                    center_of_mass=com, principal_dims=dims,
                                    num_attempts=200)
    assert _assert_sampled(got, want, _unstable(
        gaussian, nudged, want)).sum() > 10


class _Replay:
    """JAX's sampler output per round, replayed into both stacks, so that a
    loop or pipeline is compared on the same samples: the sampler's own
    lanes that float32 leaves to rounding (``_unstable``) would otherwise
    shift every later packed row."""

    def __init__(self, sdf, key, **kw):
        self.sdf, self.key, self.kw = sdf, key, kw
        self.rounds = []
        self.sample = js.antipodal_sample_grasps

    def jax_fn(self, sdf, key, **kw):
        out = self.sample(self.sdf, key, **self.kw)
        self.rounds.append(out)
        return out

    def torch_fn(self, sdf, draws, **kw):
        out = self.rounds.pop(0)
        return ts.SampledGrasps(*(_t(np.asarray(f)) for f in out))


def test_sample_until_and_stable_poses_match_jax(ellipsoid, monkeypatch):
    j, t, _ = ellipsoid
    key = jax.random.PRNGKey(5)
    kw = dict(max_width=0.085, num_attempts=64)
    rp = _Replay(j, key, **kw)
    want = js.sample_until(lambda k: rp.jax_fn(j, k), key, 50, max_rounds=4)
    got = ts.sample_until(lambda d: rp.torch_fn(t, d), LabelJaxDraws(key),
                          50, max_rounds=4)
    assert len(got[0]) == len(want[0]) == 50 and not rp.rounds
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    c, s = np.cos(0.4), np.sin(0.4)
    poses = [{"r": np.eye(3)}, {"r": np.array([[1, 0, 0], [0, c, -s],
                                                [0, s, c]])}]
    monkeypatch.setattr(js, "antipodal_sample_grasps", rp.jax_fn)
    monkeypatch.setattr(ts, "antipodal_sample_grasps", rp.torch_fn)
    want = js.sample_grasps_stable_poses(j, key, poses, num_wanted=10,
                                         max_rounds=3, **kw)
    got = ts.sample_grasps_stable_poses(t, poses, LabelJaxDraws(key),
                                        num_wanted=10, max_rounds=3, **kw)
    for i in range(2):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5, atol=1e-6)


def test_dedupe_grasps_keeps_jax_set():
    rs = np.random.RandomState(6)
    cfg = np.zeros((300, 10), np.float32)
    cfg[:, 0:3] = rs.rand(300, 3).astype(np.float32) * 0.01
    ax = rs.randn(300, 3)
    cfg[:, 3:6] = ax / np.linalg.norm(ax, axis=1, keepdims=True)
    cfg[100:150] = cfg[:50] + 1e-4                    # near duplicates
    want = js.dedupe_grasps(cfg, min_dist=0.0025)
    got = ts.dedupe_grasps(cfg, min_dist=0.0025)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_n(ts.dedupe_grasps(_t(cfg))), want)
    assert 10 < len(want) < 250
    assert len(ts.dedupe_grasps(np.zeros((0, 10), np.float32))) == 0


# ---------------------------------------------------------------------------
# SDF GPG: K1 at its labeling launch site, on its plain route here
# ---------------------------------------------------------------------------

def _gpg_kwargs():
    return dict(num_seeds=48, num_dy=4, approach_steps=10, min_open_points=2)


def _box_sdf(dim=36, res=0.004, half=(0.03, 0.02, 0.045)):
    """A box's exact SDF, with its bottom on the table plane z = 0."""
    half = np.asarray(half)
    origin = np.array([-res * (dim - 1) / 2.0] * 2 + [-0.01])
    ii, jj, kk = np.meshgrid(*(np.arange(dim),) * 3, indexing="ij")
    p = origin + res * np.stack([ii, jj, kk], -1) - [0, 0, half[2]]
    q = np.abs(p) - half
    out = np.linalg.norm(np.maximum(q, 0), axis=-1)
    inside = np.minimum(q.max(axis=-1), 0)
    return (out + inside).astype(np.float32), origin, res


@pytest.fixture(scope="module")
def box():
    data, origin, res = _box_sdf()
    with jax.enable_x64(False):
        j = jsdf.make_sdf(data, origin, res)
    return j, tsdf.make_sdf(data, origin, res, device="cpu")


@pytest.mark.parametrize("sampler,curv", [("gpg", False), ("gpg", True),
                                          ("point", False)])
def test_sdf_gpg_samplers_match_jax(box, sampler, curv):
    j, t = box
    key = jax.random.PRNGKey(7)
    kw = dict(_gpg_kwargs(), max_surface_points=1024,
              camera_pos=(0.3, 0.2, 0.5))
    launches = k1.launches
    if sampler == "gpg":
        want = js.gpg_sample_grasps_sdf(j, key, jgr.Gripper(),
                                        curvature_frames=curv, **kw)
        got = ts.gpg_sample_grasps_sdf(t, tgr.Gripper(),
                                       curvature_frames=curv,
                                       draws=SdfGpgJaxDraws(key), **kw)
    else:
        want = js.point_sample_grasps_sdf(j, key, jgr.Gripper(), **kw)
        got = ts.point_sample_grasps_sdf(t, tgr.Gripper(),
                                         draws=SdfGpgJaxDraws(key, True),
                                         **kw)
    assert k1.launches == launches          # the CPU takes the plain route
    valid = np.asarray(want.valid)
    assert (_n(got.valid) == valid).all()
    assert valid.sum() > 0
    np.testing.assert_allclose(_n(got.frames)[valid],
                               np.asarray(want.frames)[valid],
                               rtol=1e-5, atol=1e-5)


def test_sdf_gpg_empty_view_and_curvature_frames(box):
    j, t = box
    pts, nrm, grid = ts._sdf_surface_points_and_normals(t, 10 ** 6)
    jp, jn, jgrid = js._sdf_surface_points_and_normals(j, 10 ** 6)
    np.testing.assert_allclose(_n(pts), np.asarray(jp), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_n(nrm), np.asarray(jn), rtol=1e-5, atol=1e-6)
    fr_j = np.asarray(jax.jit(js._curvature_frames)(j, jgrid, jn))
    fr_t = _n(ts._curvature_frames(t, grid, nrm))
    # the 2x2 shape operator's eigenvectors carry a sign: frames agree up
    # to the sign of (major, minor) together
    sign = np.sign(np.sum(fr_t[:, 2] * fr_j[:, 2], axis=1))[:, None]
    np.testing.assert_allclose(fr_t[:, 0], fr_j[:, 0], atol=1e-5)
    np.testing.assert_allclose(fr_t[:, 1:] * sign[:, None], fr_j[:, 1:],
                               atol=2e-4)
    out = ts.gpg_sample_grasps_sdf(t, camera_pos=(0.0, 0.0, -10.0),
                                   max_surface_points=64,
                                   draws=SdfGpgJaxDraws(jax.random.PRNGKey(0)))
    # only the table-side face looks down; the box's bottom is cut by the
    # grid, so nothing faces a camera below
    assert out.frames.shape[1:] == (5, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["gpg", "gpg_curv", "point"])
def test_k1_at_sdf_gpg_site_equals_plain_on_card(box, sampler):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, t = box
    card = tsdf.make_sdf(_n(t.data), _n(t.origin), float(t.resolution),
                         device="cuda")
    kw = dict(_gpg_kwargs(), max_surface_points=1024,
              camera_pos=(0.3, 0.2, 0.5), seed=3)
    fn = (ts.point_sample_grasps_sdf if sampler == "point" else
          lambda s, **k: ts.gpg_sample_grasps_sdf(
              s, curvature_frames=sampler == "gpg_curv", **k))
    before = k1.launches
    got = fn(card, **kw)
    assert k1.launches - before == 3
    launch = k1.GpgScanContext._launch

    def plain(ctx, fx, sc, is_y):
        return k1.gpg_scan_counts_torch(ctx.points, ctx.seeds, ctx.rot_rows,
                                        fx, sc, ctx.boxes, scan_is_y=is_y)

    k1.GpgScanContext._launch = plain
    try:
        want = fn(card, **kw)
    finally:
        k1.GpgScanContext._launch = launch
    # frames the kernel skips (no valid candidate can come from them) get
    # no counts on the card; the valid ones are equal
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.frames[got.valid], want.frames[want.valid])


# ---------------------------------------------------------------------------
# Dataset generation and ground truth
# ---------------------------------------------------------------------------

def _assert_rows(got, want, sdf):
    """Rows of the same replayed samples, the JAX side labeled with its
    metric computed as the port computes it (``exact_jax_canny``). Rows
    present in both (by their configuration) carry equal friction classes
    and Ferrari-Canny labels within EPS_TOL, and the labels' means over
    them agree within 2%, except grasps whose two contacts coincide (closer than 0.1
    mm): the JAX sampler accepts such grasps and their label is then
    rounding (the closure test's direction is a difference of two equal
    points). A label may differ only where JAX's own contacts move by more
    than 1e-5 under a one- or two-ulp change of the configuration (the
    contact search's zero crossing, see ``_assert_points``), at most one
    row in ten. The row count and the per-class counts differ at most by
    the coincident grasps."""
    assert got.shape[1] == want.shape[1] == 12
    keys = {tuple(r[:10]): r for r in want}
    shared = [(r, keys[tuple(r[:10])]) for r in got if tuple(r[:10]) in keys]
    a = np.array([r for r, _ in shared])
    b = np.array([w for _, w in shared])
    pts = np.asarray(jg.close_fingers(sdf, jnp.asarray(b[:, :10]),
                                      check_approach=False).points)
    coincide = np.linalg.norm(pts[:, 0] - pts[:, 1], axis=1) < 1e-4
    n_co = int(coincide.sum())
    assert len(shared) >= len(want) - n_co - 1 >= 0
    assert abs(len(got) - len(want)) <= n_co
    np.testing.assert_array_equal(a[~coincide, 10], b[~coincide, 10])
    off = ~coincide & (np.abs(a[:, 11] - b[:, 11])
                       > EPS_TOL["rtol"] * np.abs(b[:, 11]) + EPS_TOL["atol"])
    if off.any():
        spread = _spread(lambda c: jg.close_fingers(
            sdf, jnp.asarray(c), check_approach=False).points, b[:, :10])
        ill = spread / (1 + np.abs(pts).reshape(len(pts), -1).max(1)) \
            > POINT_TOL
        assert not (off & ~ill).any(), np.where(off & ~ill)[0]
        assert off.sum() <= max(1, len(b) // 10)
    assert np.isfinite(a[:, 11]).all() and (a[:, 11] >= 0).all()
    keep = ~coincide & ~off
    assert abs(a[keep, 11].mean() - b[keep, 11].mean()) <= 0.02 * abs(
        b[keep, 11].mean()) + 1e-6
    return n_co


def _replayed(monkeypatch, sdf, **kw):
    """Route both stacks' antipodal sampler through one ``_Replay``."""
    rp = _Replay(sdf, None, **kw)
    monkeypatch.setattr(jgen, "antipodal_sample_grasps",
                        lambda s, key, **k: rp.jax_fn(s, key))
    monkeypatch.setattr(tgen, "antipodal_sample_grasps",
                        lambda s, d, **k: rp.torch_fn(s, d))
    return rp


def test_label_grasps_for_object_matches_jax(monkeypatch):
    data, origin, res = sphere_data()
    with jax.enable_x64(False):
        j = jsdf.make_sdf(data, origin, res)
    t = tsdf.make_sdf(data, origin, res, device="cpu")
    key = jax.random.PRNGKey(8)
    kw = dict(grasps_per_class=6, batch_attempts=64, max_rounds=3,
              patience=2)
    # the loop alone, unpatched: the port's own sampling fills its books
    free = tgen.label_grasps_for_object(t, np.zeros(3), tgr.Gripper(),
                                        LabelJaxDraws(key), **kw)
    assert free.rows.shape[1] == 12 and free.stats["rounds"] >= 1
    assert (free.counts <= 6).all() and free.counts.sum() == len(free.rows)
    rp = _replayed(monkeypatch, j, max_width=0.085, friction_coef=2.0,
                   num_attempts=64, num_samples_loa=40)
    with exact_jax_canny():
        want = jgen.label_grasps_for_object(j, np.zeros(3), jgr.Gripper(),
                                            key, **kw)
    got = tgen.label_grasps_for_object(t, np.zeros(3), tgr.Gripper(),
                                       LabelJaxDraws(key), **kw)
    assert not rp.rounds
    n_co = _assert_rows(got.rows, want.rows, j)
    assert np.abs(got.counts - want.counts).sum() <= 2 * n_co
    if n_co == 0:
        assert got.stats == want.stats
    assert len(want.rows) > 0


def _write_box_object(root, name="box"):
    data, origin, res = _box_sdf(dim=28, res=0.005)
    obj = os.path.join(root, name, "google_512k")
    os.makedirs(obj)
    lo, hi = np.array([-0.03, -0.02, 0.0]), np.array([0.03, 0.02, 0.09])
    v = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                  for z in (lo[2], hi[2])])
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]])
    jwrite_obj(os.path.join(obj, "nontextured.obj"), v, f)
    with jax.enable_x64(False):
        jwrite_sdf(os.path.join(obj, "nontextured.sdf"),
                   jsdf.make_sdf(data, origin, res))
    return os.path.dirname(obj)


def test_generate_for_object_dir_matches_jax(tmp_path, monkeypatch):
    obj_dir = _write_box_object(str(tmp_path / "models"))
    kw = dict(grasps_per_class=4, batch_attempts=64, max_rounds=2,
              patience=2)
    from pointnetgpd_tpu.geometry.io import read_sdf as jread_sdf

    with jax.enable_x64(False):
        j = jread_sdf(os.path.join(obj_dir, "google_512k", "nontextured.sdf"))
    rp = _replayed(monkeypatch, j, max_width=0.085, friction_coef=2.0,
                   num_attempts=64, num_samples_loa=40)
    with exact_jax_canny():
        path_j, stats_j = jgen.generate_for_object_dir(
            obj_dir, str(tmp_path / "jax"), jgr.Gripper(), seed=2, **kw)
    path_t, stats_t = tgen.generate_for_object_dir(
        obj_dir, str(tmp_path / "torch"), tgr.Gripper(), seed=2,
        device="cpu", **kw)
    assert not rp.rounds
    got, want = np.load(path_t), np.load(path_j)
    assert got.dtype == want.dtype == np.float32
    if _assert_rows(got, want, j) == 0:
        assert os.path.basename(path_t) == os.path.basename(path_j)
        assert stats_t == stats_j
    with open(path_t.replace(".npy", ".pickle"), "rb") as f:
        rows = pickle.load(f)
    assert len(rows) == len(got)
    np.testing.assert_array_equal(rows[0][0], got[0, :10])
    assert (rows[0][1], rows[0][2]) == (got[0, 10], got[0, 11])
    assert tgen.generate_for_object_dir(str(tmp_path / "missing"),
                                        str(tmp_path), tgr.Gripper()) is None


def test_generate_dataset_main_on_cpu(tmp_path):
    root = tmp_path / "data"
    models = root / "PointNetGPD" / "data" / "ycb-tools" / "models" / "ycb"
    _write_box_object(str(models))
    out = tmp_path / "out"
    tgen.main(["tiny", "--data-root", str(root), "--out-dir", str(out),
               "--grasps-per-class", "2", "--max-rounds", "2",
               "--device", "cpu"])
    files = sorted(os.listdir(out))
    assert "yield_summary.json" in files
    npy = [f for f in files if f.endswith(".npy")]
    assert len(npy) == 1 and npy[0].startswith("tiny_box_")
    assert np.load(out / npy[0]).shape[1] == 12
    with pytest.raises(SystemExit):
        tgen.main(["--data-root", str(tmp_path / "nowhere")])


def test_ground_truth_matches_jax(box):
    j, t = box
    rs = np.random.RandomState(9)
    frames = np.zeros((40, 5, 3), np.float32)
    frames[:, 1:4] = np.linalg.qr(rs.randn(40, 3, 3))[0].transpose(0, 2, 1)
    frames[:, 0] = [0, 0, 0.045] - 0.07 * frames[:, 1]
    frames[:, 4] = frames[:, 0]
    points = (rs.rand(800, 3) * [0.06, 0.04, 0.09] - [0.03, 0.02, 0]).astype(
        np.float32)
    pose = np.eye(4)
    c, s = np.cos(0.5), np.sin(0.5)
    pose[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    pose[:3, 3] = [0.01, -0.02, 0.0]
    frames_w = frames.copy()
    for k in range(5):
        off = 0 if k in (1, 2, 3) else 1
        frames_w[:, k] = frames[:, k] @ pose[:3, :3].T + off * pose[:3, 3]
    pts_w = points @ pose[:3, :3].T + pose[:3, 3]
    gripper_j, gripper_t = jgr.Gripper(), tgr.Gripper()
    np.testing.assert_allclose(
        tgt.configs_from_frames(frames_w, gripper_t, pts_w),
        jgt.configs_from_frames(frames_w, gripper_j, pts_w), rtol=1e-6,
        atol=1e-7)
    def gt_j(f):
        return jgt.ground_truth_quality(f, [(j, pose)], gripper_j, pts_w,
                                        num_samples=40)

    def gt_t(f):
        return tgt.ground_truth_quality(f, [(t, pose)], gripper_t, pts_w,
                                        num_samples=40)

    with exact_jax_canny():
        want = gt_j(frames_w)
        spread_j = {k: _spread(lambda f: gt_j(f)[k], frames_w)
                    for k in ("eps_label", "eps_good")}
    got = gt_t(frames_w)
    for k in ("obj_idx", "label_valid", "fc_label", "fc_good"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["center_sdf"], want["center_sdf"],
                               rtol=1e-5, atol=1e-6)
    # epsilons, the JAX metric computed as the port computes it, on the
    # lanes stable in both stacks
    for k in ("eps_label", "eps_good"):
        _assert_stable_lanes(got[k], want[k], spread_j[k],
                             _spread(lambda f: gt_t(f)[k], frames_w), 0.9)
    assert want["label_valid"].sum() > 0
    order = np.argsort(-got["eps_good"])
    s_t = tgt.summarize_ground_truth(got, order)
    s_j = jgt.summarize_ground_truth(want, order)
    assert s_t.keys() == s_j.keys()
    assert s_t["pool_frac_fc_mu2.0"] == s_j["pool_frac_fc_mu2.0"]
    assert tgt.ground_truth_quality(frames_w[:0], [(t, pose)],
                                    gripper_t)["score"].shape == (0,)
