"""The port's contact surface windows against the JAX package.

The JAX side runs jitted in float32 (``jax.enable_x64(False)``, as the
labeling tests do). Stated tolerances:
- ``surface_window_sdf``: within 1e-6 x (1 + |ref|);
- ``_projection_windows_raw``: every cell's first crossing in the same
  sample interval and its depth within 1e-7 m (an interval is 6.5e-4 m, so
  a crossing decided in another interval shows as a larger error). A cell
  may differ only where JAX's own depth moves by more than 1e-7 m under a
  one-ulp change of the SDF's values, origin or resolution (``_nudged``),
  at most 1% of the cells; the count is asserted zero on these inputs;
- ``bilateral_denoise``, ``surface_window_projection`` and the
  ``SurfaceWindow``s (windows, gradients, Hessian rows): within
  1e-6 x (1 + |ref|).
"""

from types import SimpleNamespace

import numpy as np
import jax
import pytest
import torch

from pointnetgpd_tpu.geometry import sdf as jsdf
from pointnetgpd_tpu.grasping import surface_window as jsw
from pointnetgpd_tpu.pipelines import parity as jparity
from pointnetgpd_tpu_torch.geometry import sdf as tsdf
from pointnetgpd_tpu_torch.grasping import grasp as tg
from pointnetgpd_tpu_torch.grasping import surface_window as tsw
from pointnetgpd_tpu_torch.pipelines import parity as tparity

from test_torch_labeling import ellipsoid_data, random_configs
from test_torch_labeling_samplers import _nudged

TOL = 1e-6
DEPTH_TOL = 1e-7


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


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want) / (1 + np.abs(want))
    assert err.max() <= tol, err.max()


@pytest.fixture(scope="module")
def ellipsoid():
    data, origin, res = ellipsoid_data(dim=40, res=0.0025)
    with jax.enable_x64(False):
        j = jsdf.make_sdf(data, origin, res)
        nudged = _nudged(data, origin, res)
    return j, tsdf.make_sdf(data, origin, res, device="cpu"), nudged


@pytest.fixture(scope="module")
def box():
    with jax.enable_x64(False):
        j = jparity.PARITY_OBJECTS["parity_box"][0](40, 0.0032)
    t = tparity.PARITY_OBJECTS["parity_box"][0](40, 0.0032, "cpu")
    return j, t


def _surface_contacts(n, seed, radii=(0.03, 0.023, 0.0375)):
    """Points near the ellipsoid's surface, directions roughly inward."""
    rs = np.random.RandomState(seed)
    v = rs.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    contacts = v * np.asarray(radii) + rs.randn(n, 3) * 1e-3
    dirs = -v + rs.randn(n, 3) * 0.2
    return contacts.astype(np.float32), dirs.astype(np.float32)


def _box_contacts(n, seed):
    """Points on the faces of parity_box, directions into the box."""
    rs = np.random.RandomState(seed)
    half = np.array([0.024, 0.036, 0.020])
    axis = rs.randint(3, size=n)
    sign = rs.choice([-1.0, 1.0], n)
    pts = (rs.rand(n, 3) * 2 - 1) * half * 0.8
    pts[np.arange(n), axis] = sign * half[axis]
    dirs = np.zeros((n, 3))
    dirs[np.arange(n), axis] = -sign
    dirs += rs.randn(n, 3) * 0.1
    return pts.astype(np.float32), dirs.astype(np.float32)


@pytest.mark.parametrize("width,num_steps", [(1e-2, 21), (0.013, 9)])
def test_surface_window_sdf_matches_jax(ellipsoid, box, width, num_steps):
    for (j, t), (c, d) in (((ellipsoid[0], ellipsoid[1]),
                            _surface_contacts(48, 0)),
                           (box, _box_contacts(48, 1))):
        want = jsw.surface_window_sdf(j, c, d, width=width,
                                      num_steps=num_steps)
        got = tsw.surface_window_sdf(t, c, d, width=width,
                                     num_steps=num_steps)
        assert got.shape == (48, num_steps, num_steps)
        _close(got.numpy(), want)


def _raw(sdf_j, c, d, **kw):
    return np.asarray(jsw._projection_windows_raw(
        sdf_j, c, d, kw["width"], kw["num_steps"], kw["max_depth"],
        kw["num_samples"]))


@pytest.mark.parametrize("kw", [
    dict(width=1e-2, num_steps=21, max_depth=1e-2, num_samples=32),
    dict(width=2e-2, num_steps=11, max_depth=6e-3, num_samples=20),
])
def test_projection_windows_raw_crossings_match_jax(ellipsoid, box, kw):
    for (j, t, nudged), (c, d) in (
            (ellipsoid, _surface_contacts(64, 2)),
            ((*box, ()), _box_contacts(64, 3))):
        want = _raw(j, c, d, **kw)
        got = tsw._projection_windows_raw(t, c, d, **kw).numpy()
        assert got.shape == want.shape
        # no crossing: exactly max_depth on both sides
        np.testing.assert_array_equal(got == np.float32(kw["max_depth"]),
                                      want == np.float32(kw["max_depth"]))
        bad = np.abs(got - want) > DEPTH_TOL
        excused = np.zeros_like(bad)
        for s in nudged:
            excused |= np.abs(_raw(s, c, d, **kw) - want) > DEPTH_TOL
        assert excused.mean() <= 0.01
        assert not (bad & ~excused).any(), np.abs(got - want).max()
        assert bad.sum() == 0
        # most cells cross the surface
        assert (want < np.float32(kw["max_depth"])).mean() > 0.5


@pytest.mark.parametrize("shape,sigmas,win_size", [
    ((6, 21, 21), (0.1, 1.0), 7),
    ((2, 3, 9, 11), (0.05, 1.5), 11),
    ((4, 5, 5), (0.3, 0.6), 5),
])
def test_bilateral_denoise_matches_jax(shape, sigmas, win_size):
    rs = np.random.RandomState(sum(shape))
    w = (rs.randn(*shape) * 0.05).astype(np.float32)
    w[0] -= 0.2                                   # negative values
    want = jsw.bilateral_denoise(w, *sigmas, win_size=win_size)
    got = tsw.bilateral_denoise(torch.from_numpy(w), *sigmas,
                                win_size=win_size)
    assert got.shape == shape
    _close(got.numpy(), want)
    assert tsw._bilateral_window_size(sigmas[1]) == \
        jsw._bilateral_window_size(sigmas[1])


@pytest.mark.parametrize("sigma_range", [0.1, 0.0])
def test_surface_window_projection_matches_jax(ellipsoid, sigma_range):
    j, t, _ = ellipsoid
    c, d = _surface_contacts(32, 4)
    want = jsw.surface_window_projection(j, c, d, sigma_range=sigma_range)
    got = tsw.surface_window_projection(t, c, d, sigma_range=sigma_range)
    _close(got.numpy(), want)
    if sigma_range == 0.0:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=DEPTH_TOL)


def _assert_windows(got, want):
    _close(got.proj_win, want.proj_win)
    _close(got.proj_win_flat, want.proj_win_flat)
    for a, b in ((got.grad, want.grad), (got.hess_x, want.hess_x),
                 (got.hess_y, want.hess_y)):
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            _close(x, y)


def test_surface_information_on_closed_fingers_matches_jax(ellipsoid):
    """Both packages on the contacts of the port's ``close_fingers``."""
    j, t, _ = ellipsoid
    cfg = random_configs(24, 5)
    cfg[:, 0:3] *= 0.3
    contacts = tg.close_fingers(t, torch.from_numpy(cfg),
                                check_approach=False)
    found = contacts.found.numpy()
    assert found.sum() >= 8
    sub = tg.Contacts(*(f[torch.from_numpy(found)][:8] for f in contacts))
    got = tsw.grasp_surface_information(t, sub)
    want = jsw.grasp_surface_information(j, SimpleNamespace(
        points=sub.points.numpy(), in_directions=sub.in_directions.numpy()))
    assert len(got) == len(want) == 8
    for (g1, g2), (w1, w2) in zip(got, want):
        _assert_windows(g1, w1)
        _assert_windows(g2, w2)
    one = tsw.surface_information(t, sub.points[0, 1],
                                  sub.in_directions[0, 1], width=1.5e-2,
                                  num_steps=15)
    _assert_windows(one, jsw.surface_information(
        j, sub.points[0, 1].numpy(), sub.in_directions[0, 1].numpy(),
        width=1.5e-2, num_steps=15))
    assert one.proj_win.shape == (15, 15)


def test_empty_contacts():
    data, origin, res = ellipsoid_data(dim=16, res=0.005)
    t = tsdf.make_sdf(data, origin, res, device="cpu")
    z = np.zeros((0, 3), np.float32)
    assert tsw.surface_window_sdf(t, z, z).shape == (0, 21, 21)
    assert tsw.surface_window_projection(t, z, z).shape == (0, 21, 21)
