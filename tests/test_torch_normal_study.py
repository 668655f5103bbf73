"""The port's normal-approximation study (``pipelines/normal_approx_study.py``)
against the JAX package.

Stated tolerances: ``make_scene`` equal bit for bit; ``study_configs`` equal
field for field (``sampler_exact`` too, which the port accepts and reads
nowhere: it always selects exactly); ``compare_frame`` and ``summarize``
equal on the same dicts; ``pinned_normals_metrics`` within 1e-6 (JAX's
estimators jitted, its exact KNN against the port's). ``run_study``:
``tests/test_torch_normal_study_frames.py``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from pointnetgpd_tpu.pipelines import normal_approx_study as jstudy
from pointnetgpd_tpu_torch.pipelines import normal_approx_study as tstudy

CAM = np.asarray([1.0, 1.0, 1.2], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed,n", [(0, 3000), (7, 84000)])
def test_make_scene_equal_jax(seed, n):
    a = tstudy.make_scene(np.random.RandomState(seed), n)
    b = jstudy.make_scene(np.random.RandomState(seed), n)
    assert a.dtype == b.dtype == np.float32 and a.shape == (n, 3)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pad", [8192, 1024])
def test_study_configs_equal_jax(pad):
    got, want = tstudy.study_configs(pad), jstudy.study_configs(pad)
    assert list(got) == list(want) == ["exact", "window", "lazy",
                                       "lazy_fp16"]
    for name in want:
        g, w = dataclasses.asdict(got[name]), dataclasses.asdict(want[name])
        assert g == w, name


def _frame(rs, n):
    frames = rs.randn(n, 5, 3).astype(np.float32) * 0.01
    frames[:, 1] /= np.linalg.norm(frames[:, 1], axis=1, keepdims=True)
    return {"all_frames": frames,
            "all_scores": rs.rand(n).astype(np.float32)}


def test_compare_frame_and_summarize_equal_jax():
    rs = np.random.RandomState(0)
    base = _frame(rs, 30)
    alt = {"all_frames": base["all_frames"].copy(),
           "all_scores": base["all_scores"] + 1e-3}
    alt["all_frames"][::3, 0] += 0.01
    empty = {"all_frames": np.zeros((0, 5, 3), np.float32),
             "all_scores": np.zeros((0,), np.float32)}
    pairs = [(base, alt), (base, _frame(rs, 12)), (base, empty),
             (empty, empty), (empty, base)]
    rows = {"a": [], "b": []}
    for x, y in pairs:
        got, want = tstudy.compare_frame(x, y), jstudy.compare_frame(x, y)
        assert got == want
        rows["a"].append(got)
        rows["b"].append(jstudy.compare_frame(y, x))
    yields = {"exact": [30, 30, 30, 0, 0], "a": [30, 12, 0, 0, 30],
              "b": [30, 30, 30, 0, 0]}
    assert tstudy.summarize(rows, yields) == jstudy.summarize(rows, yields)


def test_pinned_normals_metrics_match_jax():
    scene = jstudy.make_scene(np.random.RandomState(3), 6000)
    kw = dict(seed=3, window=256, num_seeds=40)
    got = tstudy.pinned_normals_metrics(scene, CAM, device="cpu", **kw)
    want = jstudy.pinned_normals_metrics(scene, CAM, **kw)
    assert got.keys() == want.keys()
    assert got["n_voxels"] == want["n_voxels"] > 2 * 256
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k


def test_main_skip_detector_prints_json(capsys):
    tstudy.main(["--skip-detector", "--device", "cpu", "--scenes", "1",
                 "--raw-points", "3000"])
    out = json.loads(capsys.readouterr().out)
    assert list(out) == ["pinned_normals"]
    assert out["pinned_normals"] == tstudy.run_pinned(1, 3000, device="cpu")
    assert out["pinned_normals"]["scenes"] == 1
