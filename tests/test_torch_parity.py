"""The port's training-parity harness (``pipelines/parity.py``) against the
JAX package.

Stated tolerances:
- the analytic objects' grids: equal bit for bit; the mesh objects' SDFs
  (``ops.mesh_to_sdf``, K3's plain route here) as
  ``tests/test_torch_voxelizer.py`` holds the voxelizer: equal signs,
  origin and resolution, distances and gradients within rtol 1e-5, atol
  1e-7; the surface samplers: equal bit for bit, with the same
  ``RandomState`` left behind;
- ``build_parity_dataset``: ``tests/test_torch_parity_dataset.py``;
- ``train_ours`` on a 1-epoch, 2-step miniature with JAX's initial weights
  and crop draws: the first step's loss within 2e-5 relative (the float32
  tolerance of ``test_torch_training.py::test_fused_train_step_matches_jax``).
  With ``lr=0`` every step sees the same weights, batch and draws in both,
  so every step's loss and the epoch's mean are held to 2e-5 and the eval
  accuracy is equal. With a learning rate the later steps drift: Adam's
  first update moves every weight by about lr whatever the size of its
  gradient, and at this width a float32 gradient's small entries are
  rounding (ROADMAP Queue C item 2), so the two stacks' second losses
  differ by far more than 2e-5; only the first is held;
- the optimizer-reset quirk: at the start of every epoch the optimizer and
  its schedule are a fresh ``AdamStepLR.init``'s (no moments, update count
  0, the base learning rate), as JAX's ``tx.init`` restarts optax's count.
"""

import numpy as np
import jax
import pytest
import torch

from conftest import REFERENCE_ROOT, requires_reference
from pointnetgpd_tpu.models.pointnet import init_pointnet_cls
from pointnetgpd_tpu.pipelines import parity as jparity
from pointnetgpd_tpu.training import train as jtrain
from pointnetgpd_tpu_torch.models.convert import state_dict_from_jax
from pointnetgpd_tpu_torch.models.pointnet import PointNetCls
from pointnetgpd_tpu_torch.pipelines import parity as tparity
from pointnetgpd_tpu_torch.training import train as ttrain

from test_torch_slice import JaxDraws
from test_torch_voxelizer import assert_sdf_equal

ANALYTIC = [n for n in jparity.PARITY_OBJECTS if not n.endswith("_mesh")]
MESHES = [n for n in jparity.PARITY_OBJECTS if n.endswith("_mesh")]


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


def test_registry_and_cameras_equal_jax():
    assert list(tparity.PARITY_OBJECTS) == list(jparity.PARITY_OBJECTS)
    assert len(ANALYTIC) == 7 and len(MESHES) == 3
    np.testing.assert_array_equal(tparity.VIEW_CAMERAS,
                                  jparity.VIEW_CAMERAS)
    assert tparity.VIEW_CAMERAS.dtype == np.float32


@pytest.mark.parametrize("name", ANALYTIC)
def test_analytic_grid_equal_jax(name):
    want = jparity.PARITY_OBJECTS[name][0](56, 0.0022)
    got = tparity.PARITY_OBJECTS[name][0](56, 0.0022, "cpu")
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)


@pytest.mark.parametrize("name", MESHES)
def test_mesh_object_sdf_matches_jax(name):
    mesh_fn = {"parity_ellipsoid_mesh": lambda: jparity._uv_sphere(
                   (0.036, 0.027, 0.021)),
               "parity_cone_mesh": lambda: jparity._cone_mesh(0.032, 0.080),
               "parity_torus_mesh": lambda: jparity._torus_mesh(0.026,
                                                                0.012)}[name]
    port_fn = {"parity_ellipsoid_mesh": lambda: tparity._uv_sphere(
                   (0.036, 0.027, 0.021)),
               "parity_cone_mesh": lambda: tparity._cone_mesh(0.032, 0.080),
               "parity_torus_mesh": lambda: tparity._torus_mesh(0.026,
                                                                0.012)}[name]
    for a, b in zip(mesh_fn(), port_fn()):
        np.testing.assert_array_equal(a, b)
    got = tparity.PARITY_OBJECTS[name][0](24, None, "cpu")
    want = jparity.PARITY_OBJECTS[name][0](24, None)
    assert got.data.device.type == "cpu"
    assert_sdf_equal(got, want)
    assert (got.data < 0).any()


@pytest.mark.parametrize("name", list(jparity.PARITY_OBJECTS))
def test_sampler_equal_jax(name):
    rj, rt = np.random.RandomState(3), np.random.RandomState(3)
    want = jparity.PARITY_OBJECTS[name][1](rj, 500)
    got = tparity.PARITY_OBJECTS[name][1](rt, 500)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert rj.rand() == rt.rand()


# at this size both grids have 1,184 surface cells, so the JAX package
# compiles its labeling round once for the two objects
MINI = dict(grasps_per_class=2, max_rounds=2, views_per_object=2,
            points_per_view=500, sdf_dim=28, sdf_res=0.0049, seed=0,
            objects=["parity_box", "parity_cylinder"])


@pytest.fixture(scope="module")
def mini_tree(tmp_path_factory):
    """A small dataset in the reference layout, written by the port."""
    root = str(tmp_path_factory.mktemp("parity_mini"))
    meta = tparity.build_parity_dataset(root, device="cpu", **MINI)
    return root, meta


class TrainJaxDraws(JaxDraws):
    """``train_ours``' crop draws from the JAX package's key chain: each
    ``next_round()`` is ``key, sub = split(key)`` and the crop of ``sub``."""

    def __init__(self, key):
        super().__init__(k_crop=key)
        self.key = key

    def next_round(self):
        self.key, sub = jax.random.split(self.key)
        return TrainJaxDraws(sub)


TRAIN = dict(epochs=1, batch_size=4, num_points=96, cloud_points=500,
             seed=0, steps_per_epoch=2, eval_batch=8)


def _record_steps(monkeypatch, module, losses, wrap=None):
    make = module.make_fused_train_step

    def recording(*args, **kw):
        step = make(*args, **kw)

        def run(state, *batch):
            if wrap is not None:
                wrap(state)
            state, metrics = step(state, *batch)
            losses.append(float(metrics["loss"]))
            return state, metrics

        return run

    monkeypatch.setattr(module, "make_fused_train_step", recording)


@pytest.mark.parametrize("lr", [0.0, 0.005])
def test_train_ours_matches_jax(mini_tree, monkeypatch, lr):
    root, _ = mini_tree
    lj, lt = [], []
    _record_steps(monkeypatch, jtrain, lj)
    _record_steps(monkeypatch, ttrain, lt)
    want = jparity.train_ours(root, lr=lr, **TRAIN)
    params, bn = init_pointnet_cls(jax.random.PRNGKey(0), input_chann=3,
                                   k=3)
    model = PointNetCls(k=3)
    model.load_state_dict(state_dict_from_jax(params, bn))
    got = tparity.train_ours(root, lr=lr, device="cpu", model=model,
                             draws=TrainJaxDraws(jax.random.PRNGKey(2)),
                             **TRAIN)
    assert len(lj) == len(lt) == 2
    assert np.isfinite(got["train_loss"]).all()
    assert abs(lt[0] - lj[0]) <= 2e-5 * abs(lj[0])
    if lr == 0.0:
        # no update: each step sees the same weights, batch and crop draws
        # in both, and so does the eval pass
        assert abs(lt[1] - lj[1]) <= 2e-5 * abs(lj[1])
        assert abs(got["train_loss"][0] - want["train_loss"][0]) <= 2e-5 * \
            abs(want["train_loss"][0])
        assert got["test_acc"] == want["test_acc"]
    assert 0.0 <= got["test_acc"][0] <= 1.0


def test_train_ours_resets_the_optimizer_each_epoch(mini_tree, monkeypatch):
    """At each epoch's first step the optimizer is a fresh one (no Adam
    moments, update count 0, the base learning rate); without the quirk
    they carry over."""
    root, _ = mini_tree
    seen = []

    def look(state):
        opt, sched = state.optimizer, state.scheduler
        seen.append((len(opt.state), sched.last_epoch,
                     opt.param_groups[0]["lr"], state.step))

    _record_steps(monkeypatch, ttrain, [], wrap=look)
    for reset in (True, False):
        seen.clear()
        kw = dict(TRAIN, epochs=2, steps_per_epoch=2)
        tparity.train_ours(root, device="cpu",
                           reset_optimizer_each_epoch=reset, **kw)
        assert len(seen) == 4
        assert seen[0][:3] == (0, 0, 0.005)
        if reset:
            assert seen[2][:3] == (0, 0, 0.005)    # a fresh optimizer
            assert seen[1][0] > 0 and seen[1][1] == 1
        else:
            assert seen[2][0] > 0 and seen[2][1] == 2
        assert [s[3] for s in seen] == [0, 1, 2, 3]   # steps taken


def test_reset_optimizer_restarts_the_schedule():
    """The schedule reads the update count: after a reset the learning rate
    is the base rate again although the old count had passed a StepLR
    boundary."""
    model = PointNetCls(k=3)
    tx = ttrain.make_optimizer(0.01, step_size=1, gamma=0.5,
                               steps_per_epoch=2)
    state = ttrain.init_train_state(model, tx)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    for _ in range(3):
        state.optimizer.step()
        state.scheduler.step()
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(0.005)
    assert len(state.optimizer.state) > 0
    tparity.reset_optimizer(state, tx)
    assert state.optimizer.param_groups[0]["lr"] == 0.01
    assert len(state.optimizer.state) == 0
    assert state.scheduler.last_epoch == 0
    assert state.optimizer.param_groups[0]["params"][0] is next(
        model.parameters())


@requires_reference
def test_reference_modules_read_the_port_dataset(mini_tree):
    root, meta = mini_tree
    dataset_mod, pointnet_mod = tparity._load_reference_modules(
        root, REFERENCE_ROOT)
    ds = dataset_mod.PointGraspOneViewMultiClassDataset(
        grasp_points_num=200, grasp_amount_per_file=meta["n_train"],
        thresh_good=0.5, thresh_bad=1.2, tag="train")
    assert len(ds) == len(meta["objects"]) * meta["n_train"]
    assert hasattr(pointnet_mod, "PointNetCls")


@requires_reference
def test_train_reference_runs(mini_tree):
    root, meta = mini_tree
    hist = tparity.train_reference(
        root, epochs=1, batch_size=4, num_points=96,
        grasp_amount_train=meta["n_train"], grasp_amount_test=meta["n_test"],
        seed=0, num_workers=0, reference_root=REFERENCE_ROOT)
    assert len(hist["test_acc"]) == 1 and np.isfinite(hist["train_loss"][0])
