"""The port's PointNet model and weight conversion against the JAX package,
plus the port's import rule.

- the committed golden checkpoint loads into the port's ``PointNetCls`` with
  plain ``load_state_dict`` and reproduces its frozen eval outputs
  (tests/fixtures/golden_io.npz) to atol 1e-4, as
  tests/test_golden_checkpoint.py does for the JAX package;
- ``state_dict_from_jax`` carries JAX-initialised params into the port, which
  then reproduces ``apply_pointnet_cls(train=False)`` to atol 1e-4;
- no module of ``pointnetgpd_tpu_torch`` nor ``chip_smoke.py`` imports jax or
  the JAX package (checked with ``ast``).
"""

import ast
import os
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from pointnetgpd_tpu.models.convert import convert_state_dict
from pointnetgpd_tpu.models.pointnet import apply_pointnet_cls, init_pointnet_cls
from pointnetgpd_tpu_torch.models.convert import (
    load_reference_checkpoint,
    pointnet_cls_from_state_dict,
    state_dict_from_jax,
)
from pointnetgpd_tpu_torch.models.layers import batchnorm_eval, linear
from pointnetgpd_tpu_torch.models.pointnet import PointNetCls, pointnet_cls_infer
from pointnetgpd_tpu_torch.ops import pointnet_trunk as k2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU; torch's thread pool in each worker
    oversubscribes it (the port's tests ran 10x slower under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CKPT = HERE / "fixtures" / "golden_pointnet_3class.npz"
IO = HERE / "fixtures" / "golden_io.npz"
ATOL = 1e-4


@pytest.fixture(scope="module")
def golden_model():
    sd = load_reference_checkpoint(CKPT)
    return pointnet_cls_from_state_dict(sd, num_points=500, device="cpu")


def test_golden_checkpoint_reproduces_frozen_outputs(golden_model):
    io = np.load(IO)
    x = torch.from_numpy(io["x"]).transpose(1, 2).contiguous()  # (B, N, C)
    logp, trans = pointnet_cls_infer(golden_model, x)
    np.testing.assert_allclose(trans.numpy(), io["trans"], atol=ATOL)
    np.testing.assert_allclose(logp.numpy(), io["logp"], atol=ATOL)


def test_golden_state_dict_loads_with_reference_names(golden_model):
    """Every reference key lands in the port's module under its own name."""
    sd = dict(np.load(CKPT))
    mine = golden_model.state_dict()
    assert set(mine) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(mine[k].cpu().numpy(), v, err_msg=k)


def _randomize_bn(params, state, rng):
    def walk(p, s):
        for name in list(p):
            if isinstance(p[name], dict) and "scale" in p[name]:
                n = p[name]["scale"].shape[0]
                p[name] = {"scale": (rng.rand(n) + 0.5).astype(np.float32),
                           "bias": (rng.randn(n) * 0.1).astype(np.float32)}
                s[name] = {"mean": (rng.randn(n) * 0.1).astype(np.float32),
                           "var": (rng.rand(n) + 0.5).astype(np.float32)}
            elif isinstance(p[name], dict):
                walk(p[name], s.setdefault(name, {}))
    walk(params, state)


@pytest.mark.parametrize("seed,k", [(0, 2), (1, 3)])
def test_state_dict_from_jax_reproduces_apply_pointnet_cls(seed, k):
    rng = np.random.RandomState(seed)
    params, state = jax.device_get(init_pointnet_cls(
        jax.random.PRNGKey(seed), input_chann=3, k=k))
    _randomize_bn(params, state, rng)
    x = (rng.randn(5, 200, 3) * 0.05).astype(np.float32)
    (logp_j, trans_j), _ = apply_pointnet_cls(params, state, x, train=False)
    model = pointnet_cls_from_state_dict(state_dict_from_jax(params, state),
                                         device="cpu")
    assert model.k == k
    logp, trans = pointnet_cls_infer(model, torch.from_numpy(x))
    np.testing.assert_allclose(trans.numpy(), np.asarray(trans_j), atol=ATOL)
    np.testing.assert_allclose(logp.numpy(), np.asarray(logp_j), atol=ATOL)


def test_state_dict_from_jax_inverts_the_jax_converter():
    sd = dict(np.load(CKPT))
    params, state = jax.device_get(convert_state_dict(sd))
    back = state_dict_from_jax(params, state)
    assert set(back) == set(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_layers_match_jax_batchnorm_eval():
    from pointnetgpd_tpu.models.layers import batchnorm as jbn
    from pointnetgpd_tpu.models.layers import linear as jlinear

    rng = np.random.RandomState(4)
    conv = torch.nn.Conv1d(3, 16, 1)
    bn = torch.nn.BatchNorm1d(16).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(rng.randn(16).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.rand(16).astype(np.float32) + 0.5))
        bn.weight.copy_(torch.from_numpy(rng.rand(16).astype(np.float32)))
    x = rng.randn(2, 10, 3).astype(np.float32)
    with torch.no_grad():
        got = batchnorm_eval(bn, linear(conv, torch.from_numpy(x))).numpy()
    p = {"w": conv.weight[:, :, 0].detach().numpy(),
         "b": conv.bias.detach().numpy()}
    bp = {"scale": bn.weight.detach().numpy(), "bias": bn.bias.detach().numpy()}
    bs = {"mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}
    want, _ = jbn(bp, bs, jlinear(p, x), train=False)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


def test_model_is_eval_only():
    """The model is built in eval mode, as the scorer runs it; train mode is
    the trainer's (tests/test_torch_training.py), and an eval forward that
    autograd would differentiate raises (K2 has no backward)."""
    model = PointNetCls(k=3)
    assert not model.training
    x = torch.zeros(2, 8, 3)
    with pytest.raises(RuntimeError, match="no backward"):
        model(x)
    assert model.train().training and model.eval() is model
    assert not model.training


def test_folded_trunk_is_reused_until_a_weight_changes(golden_model):
    feat = golden_model.feat
    first = feat.folded_trunk()
    assert feat.folded_trunk() is first
    assert feat.stn.folded_trunk() is feat.stn.folded_trunk()
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 40, 3)
                         .astype(np.float32))
    with torch.no_grad():
        before = golden_model(x)[0]
        old = feat.bn3.running_mean.clone()
        feat.bn3.running_mean.add_(1.0)           # in-place edit: refold
        try:
            again = feat.folded_trunk()
            assert again is not first
            want = k2.fold_trunk_params(feat)
            for g, w in zip(again, want):
                np.testing.assert_array_equal(g.numpy(), w.numpy())
        finally:
            feat.bn3.running_mean.copy_(old)
        np.testing.assert_array_equal(golden_model(x)[0].numpy(),
                                      before.numpy())


def _port_sources():
    files = sorted((ROOT / "pointnetgpd_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                continue
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "pointnetgpd_tpu"), \
                f"{path}:{node.lineno} imports {name}"
