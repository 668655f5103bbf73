"""``build_parity_dataset`` of the port against the JAX package's on a
miniature (2 analytic objects, 2 grasps per class, 2 rounds, 2 views of 500
points, sdf_dim 28). Both packages label the same replayed antipodal
samples (``_ObjectReplay``, as ``test_torch_labeling_samplers._Replay``),
JAX's draws reach the port through ``LabelJaxDraws`` and JAX's
Ferrari-Canny metric is the float64 witness of ``exact_jax_canny``. Rows
are held per object as ``_assert_rows`` holds them; the split sizes, the
view clouds and ``google2cloud.pkl`` are equal exactly (one ``RandomState``
feeds the row shuffle and the views, in the same order in both). Apart
from ``tests/test_torch_parity.py`` to keep each file short: JAX compiles
its labeling round here (once: at ``MINI``'s size both grids have the same
count of surface cells).
"""

import os
import pickle

import numpy as np
import jax
import pytest
import torch

from pointnetgpd_tpu.grasping import samplers as js
from pointnetgpd_tpu.pipelines import generate_dataset as jgen
from pointnetgpd_tpu.pipelines import parity as jparity
from pointnetgpd_tpu_torch.grasping import samplers as ts
from pointnetgpd_tpu_torch.pipelines import generate_dataset as tgen
from pointnetgpd_tpu_torch.pipelines import parity as tparity

from test_torch_labeling import _t, exact_jax_canny
from test_torch_labeling_samplers import LabelJaxDraws, _assert_rows
from test_torch_parity import MINI


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


class _ObjectReplay:
    """JAX's antipodal rounds of every object, in order, replayed into the
    port (as ``_Replay`` does for one SDF)."""

    def __init__(self):
        self.rounds = []

    def jax_fn(self, sdf, key, **kw):
        out = js.antipodal_sample_grasps(sdf, key, **kw)
        self.rounds.append(out)
        return out

    def torch_fn(self, sdf, draws, **kw):
        return ts.SampledGrasps(*(_t(np.asarray(f))
                                  for f in self.rounds.pop(0)))


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            out[os.path.relpath(path, root)] = path
    return out


def test_build_parity_dataset_matches_jax(tmp_path, monkeypatch):
    rp = _ObjectReplay()
    monkeypatch.setattr(jgen, "antipodal_sample_grasps", rp.jax_fn)
    monkeypatch.setattr(tgen, "antipodal_sample_grasps", rp.torch_fn)
    with exact_jax_canny():
        want = jparity.build_parity_dataset(str(tmp_path / "jax"), **MINI)
    n_rounds = len(rp.rounds)
    got = tparity.build_parity_dataset(
        str(tmp_path / "port"), device="cpu",
        draws_for_object=lambda i: LabelJaxDraws(
            jax.random.PRNGKey(MINI["seed"] + 17 * i)), **MINI)
    assert not rp.rounds and n_rounds >= 2
    assert got == want
    jt, tt = _tree(str(tmp_path / "jax")), _tree(str(tmp_path / "port"))
    assert sorted(jt) == sorted(tt)
    for name in MINI["objects"]:
        sdf = jparity.PARITY_OBJECTS[name][0](MINI["sdf_dim"],
                                              MINI["sdf_res"])
        split = [[np.load(t[f"PointNetGPD/data/ycb_grasp/{s}/{name}.npy"])
                  for s in ("train", "test")] for t in (tt, jt)]
        for a, b in zip(*split):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        _assert_rows(np.concatenate(split[0]), np.concatenate(split[1]),
                     sdf)
    # equal row counts (at this seed neither package accepts a grasp whose
    # contacts coincide, whose class is rounding in JAX itself: ROADMAP
    # Queue C item 7, ``_assert_rows``), so the shuffles and the views draw
    # the same numbers
    for rel in jt:
        if "clouds" in rel:
            np.testing.assert_array_equal(np.load(tt[rel]), np.load(jt[rel]),
                                          err_msg=rel)
    pk = "PointNetGPD/data/google2cloud.pkl"
    with open(tt[pk], "rb") as f, open(jt[pk], "rb") as g:
        a, b = pickle.load(f), pickle.load(g)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k][0] == b[k][0]
        np.testing.assert_array_equal(a[k][1], b[k][1])
    assert (got["n_train"], got["n_test"]) == (want["n_train"],
                                               want["n_test"])
