"""The port's trainer against the JAX package, piece by piece and whole.

Inputs come from numpy seeds; the JAX side runs jitted on the CPU; its
draws are injected into the port (``test_torch_slice.JaxDraws``). Stated
tolerances:
- train-mode BatchNorm and the models' train forward, then their eval
  forward on the moved statistics: log-probs within 1e-4 * (1 + |ref|),
  running statistics within 1e-5;
- ``matmul_bn_max``: outputs and statistics within 1e-5, gradients within
  rtol 1e-3 and atol 1e-4 * max|g| per leaf (against JAX's custom VJP and
  against the port's own unfused autograd);
- the training crops: counts, validity and the selected points' source
  indices equal exactly;
- one fused train step: loss within 1e-5 relative and every gradient leaf
  within rtol 1e-3 and atol 1e-4 * max|g| of the JAX package's step
  computed in float64; against its float32 step, accuracy within 1e-5
  relative, loss within 2e-5, Adam's moments within rtol 1e-3 (2e-3 for
  the second) and atol 1e-3 * max, BN's running statistics within 1e-5.
  The JAX side's own float32 error sets these: on these inputs its loss
  is 7e-6 relative and its gradients up to 4e-4 * max from float64, the
  port's 1e-6 and 4e-5 (XLA's CPU reductions sum in order, torch's
  pairwise). The biases that a train-mode BatchNorm absorbs have a zero
  gradient, held to |g| <= 1e-3 * max|g| of rounding noise. bf16 compute:
  loss within 2e-2; ``remat`` equal to the plain step bit for bit;
- Adam + StepLR against optax on the same gradients: within 1e-6.
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from pointnetgpd_tpu.models import fused_maxpool as jfm
from pointnetgpd_tpu.models import layers as jlayers
from pointnetgpd_tpu.models.pointnet import (apply_pointnet_cls,
                                             apply_pointnet_dense_cls,
                                             init_pointnet_cls,
                                             init_pointnet_dense_cls)
from pointnetgpd_tpu.ops import crop as jcrop
from pointnetgpd_tpu.training import train as jtrain
from pointnetgpd_tpu.training.data import SyntheticGraspData
from pointnetgpd_tpu_torch.inference.scorer import GraspScorer
from pointnetgpd_tpu_torch.models import fused_maxpool as tfm
from pointnetgpd_tpu_torch.models.convert import state_dict_from_jax
from pointnetgpd_tpu_torch.models.layers import (batchnorm_eval,
                                                 batchnorm_train, linear,
                                                 linear_bn_relu)
from pointnetgpd_tpu_torch.models.pointnet import (DualPointNetCls,
                                                   PointNetCls,
                                                   PointNetDenseCls)
from pointnetgpd_tpu_torch.ops import crop as tcrop
from pointnetgpd_tpu_torch.ops import pointnet_trunk as k2
from pointnetgpd_tpu_torch.training import checkpoint as tckpt
from pointnetgpd_tpu_torch.training import train as ttrain
from pointnetgpd_tpu_torch.training.loop import TrainConfig, Trainer
from test_native_loader import fake_dataset  # noqa: F401  (fixture)
from test_torch_slice import JaxDraws


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU; torch's thread pool in each worker
    oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol, atol_frac, what=""):
    want = np.asarray(want, np.float64)
    atol = atol_frac * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol, err_msg=what)


def _port(params, state, cls=PointNetCls, **kw):
    model = cls(**kw)
    model.load_state_dict(state_dict_from_jax(params, state))
    return model


def _by_name(tree):
    """A JAX param-shaped tree as {port parameter name: numpy}."""
    return {k: v.numpy() for k, v in state_dict_from_jax(tree, {}).items()}


def _batch(seed, b=8, p=512, learnable=True):
    return SyntheticGraspData(batch_size=b, cloud_points=p, num_classes=2,
                              learnable=learnable, seed=seed).next_batch()


def _torch_batch(batch):
    g, c, t, lab, w = batch
    return (_t(g), _t(c), _t(t), _t(lab).long(), _t(w).float())


# ------------------------------------------------------------ BN and models

@pytest.mark.parametrize("shape", [(4, 50, 16), (12, 16)])
def test_batchnorm_train_matches_jax(shape):
    rng = np.random.RandomState(0)
    c = shape[-1]
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    p = {"scale": (rng.rand(c) + 0.5).astype(np.float32),
         "bias": rng.randn(c).astype(np.float32)}
    s = {"mean": rng.randn(c).astype(np.float32) * 0.1,
         "var": (rng.rand(c) + 0.5).astype(np.float32)}
    y_j, ns_j = jax.jit(lambda x: jlayers.batchnorm(p, s, x, train=True))(x)
    bn = torch.nn.BatchNorm1d(c)
    with torch.no_grad():
        for name, v in (("weight", p["scale"]), ("bias", p["bias"]),
                        ("running_mean", s["mean"]),
                        ("running_var", s["var"])):
            getattr(bn, name).copy_(_t(v))
    y = batchnorm_train(bn, _t(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), ns_j["mean"],
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), ns_j["var"],
                               atol=1e-5)
    # bf16 inputs: the statistics stay float32
    bn16 = torch.nn.BatchNorm1d(c)
    y16 = batchnorm_train(bn16, _t(x).bfloat16())
    assert y16.dtype == torch.bfloat16
    assert bn16.running_mean.dtype == torch.float32
    np.testing.assert_allclose(bn16.running_mean.numpy(),
                               0.1 * x.reshape(-1, c).mean(0), atol=2e-3)


@pytest.mark.parametrize("model,fused", [("cls", False), ("cls", True),
                                         ("dual", True), ("dense", False)])
def test_models_train_forward_match_jax(model, fused):
    rng = np.random.RandomState(1)
    key = jax.random.PRNGKey(2)
    if model == "dense":
        params, state = jax.device_get(init_pointnet_dense_cls(key, k=4))
        fn = lambda p, s, x: apply_pointnet_dense_cls(p, s, x, train=True)
        port = _port(params, state, PointNetDenseCls, k=4)
        c = 3
    else:
        dual = model == "dual"
        c = 6 if dual else 3
        params, state = jax.device_get(init_pointnet_cls(
            key, input_chann=c, k=3, dual=dual))
        fn = lambda p, s, x: apply_pointnet_cls(
            p, s, x, train=True, dual=dual, fused_maxpool=fused)
        port = _port(params, state, DualPointNetCls if dual else PointNetCls,
                     input_chann=c, k=3)
    x = (rng.randn(6, 70, c) * 0.05).astype(np.float32)
    (logp_j, trans_j), ns_j = jax.jit(fn)(params, state, x)
    port.train()
    kw = {} if model == "dense" else {"fused_maxpool": fused}
    logp, trans = port(_t(x), **kw)
    want = np.asarray(logp_j)
    assert np.all(np.abs(logp.detach().numpy() - want)
                  <= 1e-4 * (1 + np.abs(want)))
    np.testing.assert_allclose(trans.detach().numpy(), np.asarray(trans_j),
                               atol=1e-4)
    sd = state_dict_from_jax(params, jax.device_get(ns_j))
    mine = port.state_dict()
    for k in sd:
        if "running" in k:
            np.testing.assert_allclose(mine[k].numpy(), sd[k].numpy(),
                                       atol=1e-5, err_msg=k)
    # eval mode on the moved statistics (K2's route for the trunks of its
    # shape, plain for SimpleSTN3d's)
    (logp_e, _), _ = jax.jit(lambda p, s, x: (
        apply_pointnet_dense_cls(p, s, x, train=False) if model == "dense"
        else apply_pointnet_cls(p, s, x, train=False, dual=model == "dual"))
    )(params, jax.device_get(ns_j), x)
    port.eval()
    with torch.no_grad():
        got = port(_t(x))[0].numpy()
    want = np.asarray(logp_e)
    assert np.all(np.abs(got - want) <= 1e-4 * (1 + np.abs(want)))


def test_eval_forward_refolds_after_a_step_and_a_train_forward():
    """The eval path's folded trunk (K2's weights) is refolded after
    ``optimizer.step()`` and after a train forward moved the running
    statistics, and then equals the unfused eval composition."""
    torch.manual_seed(0)
    model = PointNetCls(k=2)
    x = torch.randn(4, 40, 3) * 0.05
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    first = model.feat.folded_trunk()
    model.train()
    logp, _ = model(x)
    model.eval()
    after_fwd = model.feat.folded_trunk()
    assert after_fwd is not first                     # running stats moved
    assert model.feat.folded_trunk() is after_fwd      # and then cached
    logp[:, 0].sum().backward()
    opt.step()
    after_step = model.feat.folded_trunk()
    assert after_step is not after_fwd
    for got, want in zip(after_step, k2.fold_trunk_params(model.feat)):
        assert torch.equal(got, want.detach())
    feat = model.feat
    with torch.no_grad():              # the unfused eval composition
        got = model(x)[0]
        xt = torch.bmm(x, feat.stn(x))
        h = linear_bn_relu(feat.conv1, feat.bn1, xt)
        h = linear_bn_relu(feat.conv2, feat.bn2, h)
        want = model._head(batchnorm_eval(feat.bn3, linear(feat.conv3, h))
                           .amax(dim=1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_k2_refuses_autograd():
    """K2 has no backward: an eval forward that autograd would
    differentiate raises instead of returning a detached trunk output; under
    no_grad, or in train mode, the model runs."""
    torch.manual_seed(0)
    model = PointNetCls(k=2)
    x = torch.randn(2, 30, 3) * 0.05
    with pytest.raises(RuntimeError, match="no backward"):
        model(x)
    with pytest.raises(RuntimeError, match="no backward"):
        k2.fused_trunk(x.requires_grad_(), k2.fold_trunk_params(model.feat))
    with torch.no_grad():
        model(x)
    model.train()
    assert model(x)[0].requires_grad


# ----------------------------------------------------------- fused maxpool

def _fm_inputs(n, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(4, n, 16) * 2 + 0.7).astype(np.float32)
    w = (rng.randn(24, 16) * 0.3).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    gamma = (rng.randn(24) + 0.2).astype(np.float32)   # mixed signs
    beta = rng.randn(24).astype(np.float32)
    cot = rng.randn(4, 24).astype(np.float32)
    return x, w, b, gamma, beta, cot


@pytest.mark.parametrize("n", [64, 128, 256, 333])
def test_matmul_bn_max_matches_jax_and_unfused(n):
    x, w, b, gamma, beta, cot = _fm_inputs(n)
    m_j, mean_j, var_j = jax.jit(jfm.matmul_bn_max)(x, w, b, gamma, beta)
    g_j = jax.jit(jax.grad(lambda *a: jnp.sum(jfm.matmul_bn_max(*a)[0] * cot),
                           argnums=(0, 1, 2, 3, 4)))(x, w, b, gamma, beta)
    args = [_t(a).requires_grad_() for a in (x, w, b, gamma, beta)]
    m, mean, var = tfm.matmul_bn_max(*args)
    for got, want in ((m, m_j), (mean, mean_j), (var, var_j)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    assert not mean.requires_grad and not var.requires_grad
    g_t = torch.autograd.grad((m * _t(cot)).sum(), args)
    # the port's own unfused composition, differentiated by autograd
    ref = [_t(a).requires_grad_() for a in (x, w, b, gamma, beta)]
    h = ref[0] @ ref[1].t() + ref[2]
    var_r, mean_r = torch.var_mean(h, dim=(0, 1), correction=0)
    y = (h - mean_r) * torch.rsqrt(var_r + 1e-5) * ref[3] + ref[4]
    g_u = torch.autograd.grad((y.amax(dim=1) * _t(cot)).sum(), ref)
    for name, got, want_j, want_u in zip("x w b gamma beta".split(), g_t, g_j,
                                         g_u):
        if name == "b":       # BN absorbs the conv bias: exactly 0 fused,
            assert float(got.abs().max()) == 0.0          # rounding unfused
            assert float(np.abs(want_j).max()) == 0.0
            assert float(want_u.abs().max()) < 1e-5
            continue
        _close(got.numpy(), want_j, 1e-3, 1e-4, f"vs JAX: d{name}")
        _close(got.numpy(), want_u.numpy(), 1e-3, 1e-4, f"vs unfused: d{name}")


# --------------------------------------------------------------- the crops

def _source_index(points, clouds_t):
    """The index in each cloud of every selected point: its nearest point
    of the cloud in the grasp frame (points (B, N, 3); clouds_t (B, P, 3),
    the clouds in their grasp frames)."""
    d = ((points[:, :, None, :] - clouds_t[:, None, :, :]) ** 2).sum(-1)
    assert np.all(d.min(axis=2) < 1e-10)
    return d.argmin(axis=2)


def _frames_of(grasps, clouds, transforms):
    centers, rot_rows, _ = tcrop._training_frames(_t(grasps), _t(transforms))
    return tcrop._to_frames(_t(clouds), centers, rot_rows).numpy()


def test_collect_grasp_clouds_batched_matches_jax():
    g, c, t, _, _ = _batch(3)
    c[0] += 1.0                        # a sample with no point in its box
    key = jax.random.PRNGKey(7)
    p_j, n_j, v_j = jcrop.collect_grasp_clouds_batched(
        g, c, t, key, num_out=64, min_point_limit=5)
    p_t, n_t, v_t = tcrop.collect_grasp_clouds_batched(
        _t(g), _t(c), _t(t), JaxDraws(k_crop=key), num_out=64,
        min_point_limit=5)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert not v_j[0] and v_j[1:].all() and (np.asarray(n_j)[1:] > 64).any()
    frames = _frames_of(g, c, t)
    ok = np.asarray(v_j)
    np.testing.assert_array_equal(
        _source_index(p_t.numpy()[ok], frames[ok]),
        _source_index(np.asarray(p_j)[ok], frames[ok]))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-6)


@pytest.mark.parametrize("p", [512, 5000])      # direct, two-stage top-k
def test_collect_grasp_clouds_matches_jax(p):
    g, _, t, _, _ = _batch(4)
    pc = (np.random.RandomState(5).rand(p, 3) * 0.08 - 0.04).astype(
        np.float32)
    key = jax.random.PRNGKey(8)
    p_j, n_j, v_j = jcrop.collect_grasp_clouds(g, pc, t[0], key, num_out=64,
                                               min_point_limit=5)
    p_t, n_t, v_t = tcrop.collect_grasp_clouds(
        _t(g), _t(pc), _t(t[0]), JaxDraws(k_crop=key), num_out=64,
        min_point_limit=5)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    frames = _frames_of(g, np.broadcast_to(pc, (len(g), p, 3)), t)
    np.testing.assert_array_equal(_source_index(p_t.numpy(), frames),
                                  _source_index(np.asarray(p_j), frames))


class _ResampleDraws(JaxDraws):
    """``_masked_resample``'s draws: plain uniforms of k1 (no RBG key) and
    the ranks of k2, each for one grasp."""

    def crop_keys(self, g, p_len):
        return _t(jax.random.uniform(self.k1, (p_len,)))[None]

    def crop_ranks(self, count, num_out):
        return _t(jax.random.randint(self.k2, (num_out,), 0,
                                     max(int(count[0]), 1)))[None]


@pytest.mark.parametrize("num_out", [16, 400])   # without, with replacement
def test_crop_closing_region_matches_jax(num_out):
    rng = np.random.RandomState(9)
    pc = (rng.rand(600, 3) * 0.08 - 0.04).astype(np.float32)
    center = np.zeros(3, np.float32)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    rot = q.astype(np.float32)
    hi = np.array([0.02, 0.04, 0.02], np.float32)
    key = jax.random.PRNGKey(10)
    p_j, n_j = jax.jit(lambda pc: jcrop.crop_closing_region(
        center, rot, -hi, hi, pc, num_out, key))(pc)
    p_t, n_t = tcrop.crop_closing_region(_t(center), _t(rot), _t(-hi),
                                         _t(hi), _t(pc), num_out,
                                         _ResampleDraws(k_crop=key))
    assert int(n_t) == int(n_j) and 16 < int(n_j) < 400
    local = tcrop._to_frames(_t(pc)[None], _t(center)[None],
                             _t(rot)[None]).numpy()
    np.testing.assert_array_equal(
        _source_index(p_t.numpy()[None], local),
        _source_index(np.asarray(p_j)[None], local))


def test_grasp_frame_and_transform_match_jax():
    rng = np.random.RandomState(6)
    g = rng.randn(16, 12).astype(np.float32)
    g[0, 3:6] = [0, 0, 1]                         # binormal along +z
    q, _ = np.linalg.qr(rng.randn(3, 3))
    tr = np.eye(4, dtype=np.float32)
    tr[:3, :3], tr[:3, 3] = q, rng.randn(3)
    want = jax.jit(jax.vmap(lambda row: jcrop.apply_transform_to_frame(
        tr, *jcrop.grasp_frame_from_config(row)[:4])))(g)
    c, a, bn, mn, w = tcrop.grasp_frame_from_config(_t(g))
    got = tcrop.apply_transform_to_frame(_t(tr)[None].expand(16, 4, 4),
                                         c, a, bn, mn)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6)
    np.testing.assert_array_equal(w.numpy(), g[:, 6])


# ------------------------------------------------------- the train step

def _jax_step(batch, key, **kw):
    params, bn = jax.device_get(init_pointnet_cls(jax.random.PRNGKey(0), k=2))
    tx = optax.adam(0.005)
    step = jtrain.make_fused_train_step(tx, num_points=64, min_point_limit=5,
                                        **kw)
    state, metrics = step(jtrain.init_train_state(params, bn, tx), *batch,
                          key)
    return params, bn, jax.device_get(state), jax.device_get(metrics)


def _port_step(params, bn, batch, key, **kw):
    model = _port(params, bn, k=2)
    state = ttrain.init_train_state(model, ttrain.make_optimizer(0.005))
    step = ttrain.make_fused_train_step(num_points=64, min_point_limit=5,
                                        **kw)
    state, metrics = step(state, *_torch_batch(batch), JaxDraws(k_crop=key))
    return state, metrics


def _jax_f64_loss_and_grads(params, bn, batch, key, fused_maxpool=False):
    """The step's loss and gradients by the JAX package in float64, on the
    step's own crop (float32, as the step takes it)."""
    g, c, t, lab, w = batch
    pts, _, valid = jcrop.collect_grasp_clouds_batched(
        g, c, t, key, num_out=64, min_point_limit=5)
    w = w * np.asarray(valid, np.float32)
    with jax.enable_x64(True):
        cast = lambda tree: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), tree)

        def loss_fn(p):
            (logp, _), _ = apply_pointnet_cls(
                p, cast(bn), jnp.asarray(pts, jnp.float64), train=True,
                fused_maxpool=fused_maxpool)
            return jtrain.masked_nll_loss(logp, jnp.asarray(lab),
                                          jnp.asarray(w, jnp.float64))

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(cast(params))
        return float(loss), _by_name(jax.device_get(grads))


@pytest.mark.parametrize("variant", ["fp32", "remat", "fused_maxpool"])
def test_fused_train_step_matches_jax(variant):
    kw = {"fp32": {}, "remat": {"remat": True},
          "fused_maxpool": {"fused_maxpool": True}}[variant]
    batch, key = _batch(1), jax.random.PRNGKey(4)
    params, bn, js, jm = _jax_step(batch, key, **kw)
    state, m = _port_step(params, bn, batch, key, **kw)
    loss64, g64 = _jax_f64_loss_and_grads(
        params, bn, batch, key, fused_maxpool=variant == "fused_maxpool")
    np.testing.assert_allclose(float(m["loss"]), loss64, rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-5)
    np.testing.assert_allclose(float(m["acc"]), float(jm["acc"]), rtol=1e-5)
    assert state.step == 1
    adam = js.opt_state[0]
    mu, nu = _by_name(adam.mu), _by_name(adam.nu)
    g_max = max(float(np.abs(g).max()) for g in g64.values())
    for name, p in state.model.named_parameters():
        st = state.optimizer.state[p]
        shape = mu[name].shape
        if np.abs(g64[name]).max() < 1e-9 * g_max:
            # a bias that a train-mode BatchNorm absorbs: zero exactly,
            # rounding noise in float32 (the port's up to 3e-4 * max|g| at
            # the first layers, JAX's 4e-5)
            assert float(p.grad.abs().max()) <= 1e-3 * g_max, name
            assert float(st["exp_avg"].abs().max()) <= 1e-4 * g_max, name
            continue
        _close(p.grad.numpy().reshape(shape), g64[name].reshape(shape), 1e-3,
               1e-4, f"grad {name}")
        _close(st["exp_avg"].numpy().reshape(shape), mu[name], 1e-3, 1e-3,
               f"exp_avg {name}")
        _close(st["exp_avg_sq"].numpy().reshape(shape), nu[name], 2e-3,
               1e-3, f"exp_avg_sq {name}")
    sd = state_dict_from_jax(params, js.bn_state)
    mine = state.model.state_dict()
    for k in sd:
        if "running" in k:
            np.testing.assert_allclose(mine[k].numpy(), sd[k].numpy(),
                                       atol=1e-5, err_msg=k)
    if variant == "remat":        # bit for bit the plain step on the CPU
        plain, pm = _port_step(params, bn, batch, key)
        assert float(pm["loss"]) == float(m["loss"])
        for (name, a), b in zip(state.model.named_parameters(),
                                plain.model.parameters()):
            assert torch.equal(a, b) and torch.equal(a.grad, b.grad), name
        for a, b in zip(state.model.buffers(), plain.model.buffers()):
            assert torch.equal(a, b)


def test_fused_train_step_bf16_matches_jax_loss_and_keeps_f32_masters():
    batch, key = _batch(2), jax.random.PRNGKey(5)
    params, bn, js, jm = _jax_step(batch, key, compute_dtype=jnp.bfloat16)
    state, m = _port_step(params, bn, batch, key,
                          compute_dtype=torch.bfloat16)
    assert abs(float(m["loss"]) - float(jm["loss"])) < 2e-2
    for p in state.model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert torch.isfinite(p).all()
        for v in state.optimizer.state[p].values():
            assert v.dtype == torch.float32
    for b in state.model.buffers():
        assert b.dtype in (torch.float32, torch.int64)


def test_all_masked_batch_keeps_params_finite():
    g, c, t, lab, w = _batch(3)
    params, bn = jax.device_get(init_pointnet_cls(jax.random.PRNGKey(0), k=2))
    model = _port(params, bn, k=2)
    state = ttrain.init_train_state(model, ttrain.make_optimizer(0.005))
    step = ttrain.make_fused_train_step(num_points=32, min_point_limit=1)
    batch = _torch_batch((g, c, t, lab, np.zeros_like(w)))
    state, m = step(state, *batch, JaxDraws(k_crop=jax.random.PRNGKey(1)))
    assert float(m["loss"]) == 0.0
    assert all(torch.isfinite(p).all() for p in model.parameters())
    state, m = step(state, *_torch_batch((g, c, t, lab, w)),
                    JaxDraws(k_crop=jax.random.PRNGKey(2)))
    assert np.isfinite(float(m["loss"]))


def test_adam_steplr_matches_optax_across_epoch_boundaries():
    """Update t takes lr * gamma**((t // steps_per_epoch) // step_size), as
    the JAX package's optax schedule does; 7 updates cross 3 boundaries."""
    rng = np.random.RandomState(0)
    w0 = rng.randn(5, 3).astype(np.float32)
    grads = rng.randn(7, 5, 3).astype(np.float32)
    tx_j = jtrain.make_optimizer(0.01, step_size=1, gamma=0.5,
                                 steps_per_epoch=2)
    p_j = {"w": jnp.asarray(w0)}
    s_j = tx_j.init(p_j)
    p = torch.nn.Parameter(_t(w0))
    tx = ttrain.make_optimizer(0.01, step_size=1, gamma=0.5,
                               steps_per_epoch=2)
    opt, sched = tx.init([p])
    lrs = []
    for g in grads:
        lrs.append(opt.param_groups[0]["lr"])
        u, s_j = tx_j.update({"w": jnp.asarray(g)}, s_j, p_j)
        p_j = optax.apply_updates(p_j, u)
        p.grad = _t(g)
        opt.step()
        sched.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_j["w"]),
                                   atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(lrs, [0.01, 0.01, 0.005, 0.005, 0.0025,
                                     0.0025, 0.00125])
    assert ttrain.step_lr(0.005)(30) == 0.0025


def test_learnable_synthetic_accuracy_improves():
    data = SyntheticGraspData(batch_size=32, cloud_points=1024,
                              num_classes=2, seed=0, learnable=True)
    torch.manual_seed(0)
    state = ttrain.init_train_state(PointNetCls(k=2),
                                    ttrain.make_optimizer(0.002))
    step = ttrain.make_fused_train_step(num_points=64, min_point_limit=5)
    from pointnetgpd_tpu_torch.draws import Draws
    draws = Draws(0)
    accs = []
    for _ in range(30):
        state, m = step(state, *_torch_batch(data.next_batch()), draws)
        accs.append(float(m["acc"]))
    assert np.mean(accs[-5:]) > 0.85, accs[-5:]


def test_pre_cropped_train_and_eval_steps():
    rng = np.random.RandomState(0)
    clouds = torch.from_numpy(rng.randn(8, 32, 3).astype(np.float32)) * 0.05
    labels = torch.from_numpy(rng.randint(0, 3, 8))
    weights = torch.ones(8)
    torch.manual_seed(0)
    state = ttrain.init_train_state(PointNetCls(k=3),
                                    ttrain.make_optimizer(0.005))
    step, evaluate = ttrain.make_train_step(), ttrain.make_eval_step()
    losses = []
    for _ in range(4):
        state, m = step(state, clouds, labels, weights)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    out = evaluate(state.model, clouds, labels, weights)
    assert float(out["count"]) == 8 and 0 <= float(out["correct"]) <= 8
    assert not state.model.training


# ------------------------------------------------ checkpoints and the loop

def _tiny_cfg(tmp_path, **kw):
    base = dict(num_classes=2, grasp_points_num=64, batch_size=8, epochs=2,
                steps_per_epoch=2, eval_steps=1, min_point_limit=5,
                model_path=str(tmp_path / "m"), log_dir=str(tmp_path / "l"),
                device="cpu")
    return TrainConfig(**{**base, **kw})


def _data(seed, b=8):
    return SyntheticGraspData(batch_size=b, cloud_points=512, seed=seed,
                              learnable=True)


def test_trainer_fit_runs_k2_route_in_eval_and_checkpoints(tmp_path,
                                                           monkeypatch):
    """fit trains, evaluates through the K2 route (its plain version here:
    2 calls per eval batch, the STN and feature trunks), writes a
    checkpoint per epoch; a resumed trainer starts after them, and
    ``GraspScorer.from_checkpoint`` on the directory reproduces the eval
    pass's predictions."""
    calls = []
    plain = k2.trunk_reference
    monkeypatch.setattr(k2, "trunk_reference",
                        lambda x, f: calls.append(x.shape) or plain(x, f))
    tr = Trainer(_tiny_cfg(tmp_path), _data(0), _data(1))
    before = {k: v.clone() for k, v in tr.state.model.state_dict().items()}
    tr.fit()
    assert len(calls) == 2 * 2 and all(s[:2] == (8, 64) for s in calls)
    after = tr.state.model.state_dict()
    assert not torch.equal(before["fc3.weight"], after["fc3.weight"])
    assert not torch.equal(before["feat.bn3.running_mean"],
                           after["feat.bn3.running_mean"])
    path = tckpt.latest_checkpoint(str(tmp_path / "m"))
    assert path.endswith("step_4")
    resumed = Trainer(_tiny_cfg(tmp_path), _data(0), _data(1))
    assert resumed.maybe_resume() == path
    assert resumed._epoch0 == 2 and resumed.state.step == 4
    assert resumed.state.optimizer.state_dict()["state"]      # Adam moments
    for k, v in after.items():
        assert torch.equal(resumed.state.model.state_dict()[k], v), k
    # the scorer loads the trained model and predicts as the eval pass does
    scorer = GraspScorer.from_checkpoint(path, device="cpu")
    x = torch.randn(5, 64, 3) * 0.03
    with torch.no_grad():
        want = tr.state.model.eval()(x)[0]
        got = scorer.model(x)[0]
    assert torch.equal(got, want)
    tr.close()
    resumed.close()


def test_checkpoint_roundtrip_layouts_and_corruption(tmp_path):
    torch.manual_seed(0)
    state = ttrain.init_train_state(PointNetCls(k=3),
                                    ttrain.make_optimizer(0.005))
    step = ttrain.make_train_step()
    clouds = torch.randn(4, 16, 3) * 0.05
    state, _ = step(state, clouds, torch.tensor([0, 1, 2, 1]), torch.ones(4))
    state.step = 7
    tckpt.save_checkpoint(str(tmp_path / "a"), state)
    path = tckpt.latest_checkpoint(str(tmp_path / "a"))
    assert path.endswith("step_7")

    def template():
        return ttrain.init_train_state(PointNetCls(k=3),
                                       ttrain.make_optimizer(0.005))

    restored = tckpt.restore_checkpoint(path, template())
    assert restored.step == 7 and restored.scheduler.last_epoch == 7
    for a, b in zip(restored.model.state_dict().values(),
                    state.model.state_dict().values()):
        assert torch.equal(a, b)
    sa = restored.optimizer.state_dict()["state"]
    sb = state.optimizer.state_dict()["state"]
    assert all(torch.equal(sa[i]["exp_avg"], sb[i]["exp_avg"]) for i in sb)
    np.testing.assert_array_equal(tckpt.params_to_numpy(restored.model)[
        "fc3.weight"], state.model.fc3.weight.detach().numpy())

    # another optimizer layout: the model and step come back, the
    # optimizer state starts fresh, with a warning
    other = ttrain.TrainState(state.model, torch.optim.SGD(
        state.model.parameters(), lr=0.1, momentum=0.9), state.scheduler, 11)
    other.model.fc3.weight.grad = torch.ones_like(other.model.fc3.weight)
    other.optimizer.step()
    tckpt.save_checkpoint(str(tmp_path / "b"), other)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        r = tckpt.restore_checkpoint(str(tmp_path / "b" / "step_11"),
                                     template())
    assert any("optimizer state" in str(w.message) for w in caught)
    assert r.step == 11 and not r.optimizer.state_dict()["state"]

    # a damaged checkpoint of the same layout fails loudly
    for name in (tckpt.STATE_FILE, "model.pt"):
        bad = tmp_path / f"bad_{name}"
        tckpt.save_checkpoint(str(bad), state)
        with open(bad / "step_7" / name, "r+b") as fh:
            fh.truncate(64)
        with pytest.raises(Exception):
            tckpt.restore_checkpoint(str(bad / "step_7"), template())


def test_cli_trains_and_tests_each_pointnet_variant(tmp_path, capsys):
    from pointnetgpd_tpu_torch.cli.train import VARIANTS, build_parser, main

    assert set(VARIANTS) == {"1v", "1v_mc", "fullv", "fullv_mc", "1v_gpd",
                             "fullv_gpd", "1v_pn2"}
    assert build_parser().parse_args(["--mode", "train"]).device == "cuda"
    common = ["--synthetic", "--device", "cpu", "--batch-size", "8",
              "--cloud-points", "512", "--steps-per-epoch", "2",
              "--eval-steps", "1", "--model-path", str(tmp_path / "m"),
              "--log-dir", str(tmp_path / "l")]
    assert main(["--variant", "1v_mc", "--mode", "train", "--epoch", "1",
                 *common]) == 0
    assert main(["--variant", "1v_mc", "--mode", "test", *common]) == 0
    out = capsys.readouterr().out
    assert "Epoch 0: train_acc=" in out and "Test done, acc=" in out
    sd = torch.load(tmp_path / "m" / "step_2" / "model.pt")
    assert sd["fc3.weight"].shape == (3, 256)


def test_native_batcher_feeds_the_port(fake_dataset):  # noqa: F811
    from pointnetgpd_tpu_torch.training import native_loader
    from pointnetgpd_tpu_torch.training.data import GraspDataIndex

    index = GraspDataIndex(fake_dataset, tag="train", one_view=True)
    batcher = native_loader.NativeBatcher(index, batch_size=8,
                                          cloud_points=512)
    try:
        g, c, t, lab, w = batcher.next_batch()
    finally:
        batcher.close()
    assert g.shape == (8, 12) and c.shape == (8, 512, 3)
    assert t.shape == (8, 4, 4) and lab.shape == (8,) and w.shape == (8,)
    assert str(native_loader._BUILD).endswith("pointnetgpd_tpu_torch/_build")


@pytest.mark.cuda
def test_train_step_on_card():
    """One fused train step on the card equals the same step on the CPU
    (same weights, same draws; the biases that BatchNorm absorbs, zero in
    float64, at noise), and the eval pass launches K2 twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the eval pass runs kernel K2")
    dev = torch.device("cuda")
    batch, key = _batch(1), jax.random.PRNGKey(4)
    params, bn = jax.device_get(init_pointnet_cls(jax.random.PRNGKey(0), k=2))
    out = {}
    for d in ("cpu", "cuda"):
        model = _port(params, bn, k=2).to(d)
        state = ttrain.init_train_state(model, ttrain.make_optimizer(0.005))
        step = ttrain.make_fused_train_step(num_points=64, min_point_limit=5)
        state, m = step(state, *(a.to(d) for a in _torch_batch(batch)),
                        JaxDraws(k_crop=key))
        out[d] = (state, m)
    np.testing.assert_allclose(float(out["cuda"][1]["loss"]),
                               float(out["cpu"][1]["loss"]), rtol=1e-5)
    _, g64 = _jax_f64_loss_and_grads(params, bn, batch, key)
    g_max = max(float(np.abs(g).max()) for g in g64.values())
    for (name, a), b in zip(out["cuda"][0].model.named_parameters(),
                            out["cpu"][0].model.parameters()):
        if np.abs(g64[name]).max() < 1e-9 * g_max:    # absorbed by BN
            assert float(a.grad.abs().max()) <= 1e-3 * g_max, name
            continue
        _close(a.grad.cpu().numpy(), b.grad.numpy(), 1e-3, 1e-4, name)
    n0 = k2.launches
    ttrain.make_eval_step()(out["cuda"][0].model,
                            torch.randn(8, 64, 3, device=dev) * 0.03,
                            torch.zeros(8, dtype=torch.long, device=dev),
                            torch.ones(8, device=dev))
    assert k2.launches == n0 + 2
