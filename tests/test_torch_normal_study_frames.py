"""``run_study`` of the port's normal-approximation study against the JAX
package's: one scene of 1,500 points (``make_scene``), every config's
detector, JAX's initial weights and frame draws
(``test_torch_slice.JaxDraws``).
Yields equal, and the summary equal but for its score fields, within 1e-4
(the frame's score tolerance in ``tests/test_torch_slice.py``). Apart from
``tests/test_torch_normal_study.py`` to keep each file short: the four
frames run K1's plain version on the CPU, most of this file's time.
"""

import numpy as np
import jax
import pytest
import torch

from pointnetgpd_tpu.models.pointnet import init_pointnet_cls
from pointnetgpd_tpu.pipelines import normal_approx_study as jstudy
from pointnetgpd_tpu_torch.models.convert import state_dict_from_jax
from pointnetgpd_tpu_torch.models.pointnet import PointNetCls
from pointnetgpd_tpu_torch.pipelines import normal_approx_study as tstudy

from test_torch_slice import JaxDraws


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_run_study_matches_jax():
    kw = dict(n_scenes=1, raw_points=1500, seed0=0, cloud_pad_to=512)
    rows_j, yields_j = jstudy.run_study(**kw)
    params, bn = init_pointnet_cls(jax.random.PRNGKey(0), input_chann=3,
                                   k=3)
    model = PointNetCls(k=3)
    model.load_state_dict(state_dict_from_jax(params, bn))
    rows_t, yields_t = tstudy.run_study(**kw, model=model, device="cpu",
                                        draws_for=JaxDraws.for_frame)
    assert yields_t == yields_j
    assert all(y[0] > 0 for y in yields_t.values())
    got = tstudy.summarize(rows_t, yields_t)
    want = jstudy.summarize(rows_j, yields_j)
    assert got.keys() == want.keys()
    for name in want:
        if name == "mean_yield":
            assert got[name] == want[name]
            continue
        for k, w in want[name].items():
            g = got[name][k]
            if "score" in k and w is not None:
                assert abs(g - w) <= 1e-4, (name, k)
            else:
                assert g == w, (name, k)
