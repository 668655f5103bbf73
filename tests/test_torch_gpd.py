"""The port's GPD baseline against the JAX package: projection features, the
CNN, one train step, the eval step, the scorer and the trainer.

Inputs come from numpy seeds; the JAX side runs jitted on the CPU; its
draws are injected (``JaxDraws``; the per-sample crops draw from
``split(key, B)`` as ``training/train.py`` does). Tolerances: projection
features equal exactly; log-probs within 1e-5; one train step's loss within
1e-5 relative and its gradients within rtol 1e-3, atol 1e-4 * max|g| per
leaf (the model has no BatchNorm; float32 on both sides); the scorer's
counts, validity and predictions equal, probabilities within 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from pointnetgpd_tpu.inference import gpd_scorer as jscorer
from pointnetgpd_tpu.models.gpd import apply_gpd_classifier
from pointnetgpd_tpu.ops import crop as jcrop
from pointnetgpd_tpu.ops import projection as jproj
from pointnetgpd_tpu.training import train as jtrain
from pointnetgpd_tpu.training.data import SyntheticGraspData
from pointnetgpd_tpu_torch.inference import gpd_scorer as tscorer
from pointnetgpd_tpu_torch.models.convert import state_dict_from_jax
from pointnetgpd_tpu_torch.ops import projection as tproj
from pointnetgpd_tpu_torch.ops.cloud import estimate_normals_knn
from pointnetgpd_tpu_torch.training import train as ttrain
from pointnetgpd_tpu_torch.training.loop import TrainConfig, Trainer
from test_torch_slice import JaxDraws, _candidates, _gpd_models, _scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


class _PerSample:
    """Draws of B per-sample crops as the JAX package makes them: each from
    its own key of ``split(key, B)``, under ``vmap`` (the selection keys'
    RBG generator gives other bits under ``vmap`` than in a single call)."""

    def __init__(self, keys):
        self.k1, self.k2 = jax.vmap(jax.random.split, out_axes=1)(keys)

    def crop_keys(self, g, p_len):
        return _t(jax.vmap(lambda k: jax.random.uniform(
            jcrop._rbg_key(k), (1, p_len), jnp.float32))(self.k1)[:, 0])

    def crop_ranks(self, count, num_out):
        hi = jnp.maximum(jnp.asarray(count.cpu().numpy()), 1)
        return _t(jax.vmap(lambda k, h: jax.random.randint(
            k, (1, num_out), 0, h))(self.k2, hi)[:, 0])


class GpdJaxDraws(JaxDraws):
    """JAX's draws of a GPD step under ``key``: ``split(key, B)``, one key
    per sample's crop; dropout as ``models/gpd.py`` draws it."""

    def __init__(self, key):
        super().__init__(k_crop=key)
        self.key = key

    def per_sample(self, n):
        return _PerSample(jax.random.split(self.key, n))

    def dropout_keep(self, shape):
        return _t(jax.random.bernoulli(self.key, 0.5, tuple(shape)))


@pytest.mark.parametrize("chann", [3, 12])
def test_projection_features_match_jax(chann):
    rs = np.random.RandomState(0)
    b, p = 3, 300
    pts = (rs.rand(b, p, 3) * 0.06 - 0.03).astype(np.float32)
    pts[:, 100:200] = pts[:, :100]          # resampled with replacement
    pts[:, -5:] += 0.2                      # outside the image
    nrm = rs.randn(b, p, 3).astype(np.float32)
    valid = np.ones((b, p), bool)
    valid[1, ::7] = False
    w = np.array([0.08, 0.06, 0.085], np.float32)
    fn = jax.jit(jax.vmap(lambda x, n, v, g: jproj.gpd_projection_features(
        x, n, v, g, project_chann=chann)))
    want = np.asarray(fn(pts, nrm, valid, w))
    got = tproj.gpd_projection_features(_t(pts), _t(nrm), _t(valid), _t(w),
                                        project_chann=chann).numpy()
    assert got.shape == (b, 60, 60, chann)
    np.testing.assert_array_equal(got, want)


def test_normals_of_a_batch_equal_each_cloud_alone():
    rs = np.random.RandomState(1)
    pts = torch.from_numpy((rs.rand(3, 80, 3) * 0.05).astype(np.float32))
    cam = torch.tensor([-1.0, 0.0, 0.0])
    both = estimate_normals_knn(pts, cam, k=10, chunk=32)
    for i in range(3):
        assert torch.equal(both[i], estimate_normals_knn(pts[i], cam, k=10,
                                                         chunk=32))


@pytest.mark.parametrize("train", [False, True])
def test_gpd_classifier_matches_jax(train):
    params, model = _gpd_models(0)
    x = np.random.RandomState(2).rand(4, 60, 60, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda p, x: apply_gpd_classifier(
        p, x, train=train, dropout=train, rng=key))(params, x)
    model.dropout = train
    model.train(train)
    with torch.no_grad():
        got = model(_t(x), GpdJaxDraws(key))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("cloud_points", [512, 5000])   # direct, two-stage
def test_gpd_train_and_eval_steps_match_jax(cloud_points):
    batch = SyntheticGraspData(batch_size=4, cloud_points=cloud_points,
                               seed=4).next_batch()
    key = jax.random.PRNGKey(5)
    params, model = _gpd_models(1)
    tx = optax.adam(1e-3)
    kw = dict(num_points=64, project_chann=3, min_point_limit=5)
    js, jm = jtrain.make_gpd_train_step(tx, **kw)(
        jtrain.init_train_state(params, {}, tx), *batch, key)
    state = ttrain.init_train_state(model, ttrain.make_optimizer(1e-3))
    g, c, t, lab, w = (_t(a) for a in batch)
    args = (g, c, t, lab.long(), w.float())
    state, m = ttrain.make_gpd_train_step(**kw)(state, *args,
                                                GpdJaxDraws(key))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert float(m["valid_frac"]) == float(jm["valid_frac"]) > 0
    mu = state_dict_from_jax(jax.device_get(js.opt_state[0].mu), {})
    for name, p in state.model.named_parameters():
        want = mu[name].numpy() / 0.1
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=1e-3,
            atol=1e-4 * float(np.abs(want).max()), err_msg=name)
    # the eval step, on the trained weights
    jeval = jtrain.make_gpd_eval_step(**kw)(
        jax.device_get(js.params), *batch, key)
    teval = ttrain.make_gpd_eval_step(**kw)(state.model, *args,
                                            GpdJaxDraws(key))
    for k in ("correct", "count"):
        assert float(teval[k]) == float(jeval[k]), k
    np.testing.assert_allclose(float(teval["loss_sum"]),
                               float(jeval["loss_sum"]), rtol=1e-4)


def test_gpd_scorer_matches_jax():
    pc = _scene(3)
    cand = _candidates(pc, 24, 4)
    params, model = _gpd_models(2, favor_good=True)
    valid_in = np.ones(24, bool)
    valid_in[-2:] = False
    out_j = jscorer.score_candidates_gpd(
        params, jnp.asarray(pc), jnp.asarray(cand), jnp.asarray(valid_in),
        jnp.float32(0.06), jnp.float32(0.08), jax.random.PRNGKey(6),
        num_points=64, project_chann=3, min_points=5)
    out_t = tscorer.score_candidates_gpd(
        model, _t(pc), _t(cand), _t(valid_in), 0.06, 0.08,
        JaxDraws(k_crop=jax.random.PRNGKey(6)), num_points=64,
        project_chann=3, min_points=5)
    pred_j, prob_j, cnt_j, val_j, good_j, _ = map(np.asarray, out_j)
    pred_t, prob_t, cnt_t, val_t, good_t, _ = (o.numpy() for o in out_t)
    for a, b_ in ((cnt_t, cnt_j), (val_t, val_j), (pred_t, pred_j),
                  (good_t, good_j)):
        np.testing.assert_array_equal(a, b_)
    np.testing.assert_allclose(prob_t, prob_j, atol=1e-4)
    assert val_j.sum() > 10
    scorer = tscorer.GPDScorer(model, num_points=64, pad_to=16,
                               min_points=5, device="cpu")
    res = scorer.score_candidates(pc, cand[:5], 0.06, 0.08, seed=1)
    assert res["prob"].shape == (5, 2) and res["pred"].shape == (5,)
    empty = scorer.score_candidates(pc, np.zeros((0, 5, 3)), 0.06, 0.08)
    assert empty["pred"].shape == (0,)


def test_gpd_trainer_with_eval(tmp_path):
    cfg = TrainConfig(num_classes=2, grasp_points_num=64, batch_size=4,
                      epochs=1, steps_per_epoch=2, eval_steps=1,
                      min_point_limit=5, gpd=True, project_chann=12,
                      tag="gpd", model_path=str(tmp_path / "m"),
                      log_dir=str(tmp_path / "l"), device="cpu")
    tr = Trainer(cfg, SyntheticGraspData(batch_size=4, cloud_points=256),
                 SyntheticGraspData(batch_size=4, cloud_points=256, seed=7))
    before = tr.state.model.conv1.weight.detach().clone()
    tr.fit()
    acc, loss = tr.evaluate()
    assert acc is not None and np.isfinite(loss)
    assert tr.state.model.conv1.weight.shape == (20, 12, 5, 5)
    assert not torch.equal(before, tr.state.model.conv1.weight)
    tr.close()
