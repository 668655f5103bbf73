"""Keywords of the JAX package's calls that the port accepts as no-ops.

Code written for the JAX package passes ``DetectorConfig(sampler_exact=)``,
``exact=`` to the neighbor selection and normal estimators and to
``gpg_sample_candidates``, ``seed_chunk=`` to the last and to
``seed_window_normals``, and ``transform_dense(detailed=)``. The port
selects neighbors exactly everywhere (as JAX does off the TPU), so each
keyword changes nothing: every call below, built from the JAX call's own
keywords, equals the call without them exactly. ``min_k`` equals the JAX
package's exact selection, ties and infinities included.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnetgpd_tpu.ops import cloud as jcloud
from pointnetgpd_tpu.robot import node as jnode
from pointnetgpd_tpu_torch.draws import Draws
from pointnetgpd_tpu_torch.geometry import sdf as tsdf
from pointnetgpd_tpu_torch.grasping.gripper import Gripper
from pointnetgpd_tpu_torch.grasping.samplers import gpg_sample_candidates
from pointnetgpd_tpu_torch.ops import cloud as tcloud
from pointnetgpd_tpu_torch.robot import node as tnode

from test_torch_slice import _scene

CAM = torch.tensor([0.5, 0.5, 1.0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(a, b):
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _cloud(n=600, seed=0):
    return torch.from_numpy(_scene(seed, n=n // 3))


@pytest.mark.parametrize("preset", ["default", "reference_parity",
                                    "production"])
def test_detector_config_from_jax_fields(preset):
    """Each JAX preset's field dict builds the port's config, equal to the
    port's own preset, ``sampler_exact`` included."""
    make_j = jnode.DetectorConfig if preset == "default" else getattr(
        jnode.DetectorConfig, preset)
    make_t = tnode.DetectorConfig if preset == "default" else getattr(
        tnode.DetectorConfig, preset)
    fields = dataclasses.asdict(make_j(cloud_pad_to=1024))
    got = tnode.DetectorConfig(**fields)
    assert dataclasses.asdict(got) == fields
    assert got == make_t(cloud_pad_to=1024)
    assert got.sampler_exact == (preset == "reference_parity")


@pytest.mark.parametrize("exact", [True, False])
def test_min_k_exact(exact):
    d2 = torch.from_numpy(np.random.RandomState(0).rand(7, 50)
                          .astype(np.float32))
    d2[:, 3] = d2[:, 9]                               # a tie
    _equal(tcloud.min_k(d2, 8, exact), tcloud.min_k(d2, 8))
    _equal(tcloud.min_k(d2, 8, exact=exact), tcloud.min_k(d2, 8))


@pytest.mark.parametrize("case", ["plain", "ties", "inf_nan", "int"])
@pytest.mark.parametrize("k", [1, 8, 30])
def test_min_k_equals_jax(case, k):
    """The same values and indices as JAX's ``min_k(exact=True)``
    (``lax.top_k``): ties toward the lower index, inf after every finite
    entry, NaN after inf."""
    rs = np.random.RandomState(k)
    d2 = rs.rand(5, 3, 400).astype(np.float32)
    if case == "ties":
        d2 = np.floor(d2 * 6).astype(np.float32)
    elif case == "inf_nan":
        d2[..., rs.choice(400, 395, replace=False)] = np.inf
        d2[0, 0, :200:3] = np.nan
        d2[1, 2, :] = np.nan
    elif case == "int":
        d2 = rs.randint(0, 9, d2.shape).astype(np.int32)
    vals, idx = tcloud.min_k(torch.from_numpy(d2), k)
    want_v, want_i = jcloud.min_k(jnp.asarray(d2), k, exact=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("exact", [True, False])
def test_estimate_normals_knn_exact(exact):
    pts = _cloud()
    _equal(tcloud.estimate_normals_knn(pts, CAM, k=12, exact=exact),
           tcloud.estimate_normals_knn(pts, CAM, k=12))


@pytest.mark.parametrize("exact", [True, False])
def test_estimate_normals_knn_window_exact(exact):
    pts = _cloud(900)
    kw = dict(k=12, window=128, q_chunk=64,
              bbox=(pts.amin(0), pts.amax(0)))
    _equal(tcloud.estimate_normals_knn_window(pts, CAM, exact=exact, **kw),
           tcloud.estimate_normals_knn_window(pts, CAM, **kw))


@pytest.mark.parametrize("exact,seed_chunk", [(True, 32), (False, 8),
                                              (True, 1)])
@pytest.mark.parametrize("window", [128, 2048])
def test_seed_window_normals_exact_seed_chunk(exact, seed_chunk, window):
    """Both branches: the Morton windows (P > 2 * window) and the
    whole-cloud fallback."""
    pts = _cloud(900)
    seed_idx = torch.arange(0, 900, 37)
    kw = dict(k=12, knn=40, window=window)
    _equal(tcloud.seed_window_normals(pts, seed_idx, CAM, exact=exact,
                                      seed_chunk=seed_chunk, **kw),
           tcloud.seed_window_normals(pts, seed_idx, CAM, **kw))


@pytest.mark.parametrize("exact,seed_chunk", [(True, 8), (False, 3)])
@pytest.mark.parametrize("lazy", [False, True])
def test_gpg_sample_candidates_exact_seed_chunk(exact, seed_chunk, lazy):
    """The keywords of JAX's detector call (``robot/node.py``), on
    precomputed normals and on the lazy seed-window normals."""
    pts = _cloud(1200)
    normals = None if lazy else tcloud.estimate_normals_knn(pts, CAM, k=12)
    kw = dict(num_seeds=12, camera_pos=CAM, bbox=(pts.amin(0), pts.amax(0)),
              normal_k=12, normal_window=128 if lazy else 0, debug=True)
    a_c, a_f = gpg_sample_candidates(pts, normals, Gripper(), exact=exact,
                                     seed_chunk=seed_chunk, draws=Draws(3),
                                     **kw)
    b_c, b_f = gpg_sample_candidates(pts, normals, Gripper(), draws=Draws(3),
                                     **kw)
    _equal(tuple(a_c), tuple(b_c))
    assert a_f.keys() == b_f.keys()
    for name in b_f:
        _equal(a_f[name], b_f[name])


@pytest.mark.parametrize("detailed", [True, False])
def test_transform_dense_detailed(detailed):
    rs = np.random.RandomState(0)
    g = np.mgrid[0:12, 0:12, 0:12].astype(np.float32) * 0.004 - 0.022
    data = np.linalg.norm(g, axis=0) - 0.015 + rs.rand(12, 12, 12) * 1e-4
    sdf = tsdf.make_sdf(data, np.full(3, -0.022, np.float32), 0.004,
                        device="cpu")
    t = np.eye(4)
    c, s = np.cos(0.3), np.sin(0.3)
    t[:2, :2] = [[c, -s], [s, c]]
    t[:3, 3] = [0.002, -0.001, 0.003]
    a = tsdf.transform_dense(sdf, t, detailed=detailed)
    b = tsdf.transform_dense(sdf, t)
    for x, y in zip(a, b):
        _equal(x, y)
