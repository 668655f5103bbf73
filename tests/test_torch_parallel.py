"""The port's data and tensor parallelism against the JAX package's, on the
CPU at small width.

JAX runs on the 8 virtual CPU devices of ``tests/conftest.py``; the port's
meshes are 8 (or 2) shards on the CPU (``make_mesh(8, device="cpu")``).
Draws are injected (``JaxDraws``), so each sharded port result is held to
the sharded JAX result and to the port's own single-device result:

- the mesh helpers and ``ShardDraws`` exactly;
- ``GraspScorer(mesh=)``: predictions, counts, validity and the ranked
  order exactly, probabilities to 1e-4 against JAX (the slice tests'
  tolerance) and 1e-6 against the port's single device;
- ``estimate_normals_knn_window(mesh=)``: against JAX at the same mesh
  size, to 1e-4 where the mesh moves JAX's normals and elsewhere within the
  error the unsharded normals show against JAX on the same cloud;
- ``gpg_sample_candidates(mesh=)``: validity and the funnel exactly, frames
  to 1e-5;
- the detector frame on a mesh: as ``test_torch_slice``'s frame test;
  ``warmup`` over a mesh, then a frame equal to the single device's;
- tensor parallelism: the eval forward to 2e-5 (the JAX test's atol), a
  train step's loss to 1e-6 relative, gradients to 1e-4 x max|g| and the
  BN statistics to 1e-6 against the unsharded step;
- the data-parallel step on 2 gloo ranks (``parallel.ranks``): the loss to
  1e-5 relative of the 1-process step, gradients to 1e-4 x max|g| of it
  outside the STN and to 1e-3 x max|g| in it (every gradient to 1e-4 in
  the step computed in float64) and to 1e-3 x max|g| of JAX's float64
  step on a 2-device mesh (the float32 noise of the STN's gradients,
  ROADMAP Queue C item 2: the 1-process step is 1.5e-4 x max|g| from
  float64), equal on both ranks, BN running statistics to 1e-5 x
  (1 + |ref|); the batch masks three samples of one rank, so a per-rank loss
  denominator would fail;
- ``cli.train --n-devices 2 --device cpu`` writes exactly one checkpoint.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnetgpd_tpu.grasping import samplers as jsamplers
from pointnetgpd_tpu.grasping.gripper import Gripper as JGripper
from pointnetgpd_tpu.inference import scorer as jscorer
from pointnetgpd_tpu.models.gpd import init_gpd_classifier
from pointnetgpd_tpu.models.pointnet import (apply_pointnet_cls,
                                             init_pointnet_cls)
from pointnetgpd_tpu.ops import cloud as jc
from pointnetgpd_tpu.ops import crop as jcrop
from pointnetgpd_tpu.parallel import mesh as jmesh
from pointnetgpd_tpu.parallel import tp as jtp
from pointnetgpd_tpu.robot import node as jnode
from pointnetgpd_tpu.training import train as jtrain
from pointnetgpd_tpu.training.data import SyntheticGraspData
from pointnetgpd_tpu_torch.draws import Draws
from pointnetgpd_tpu_torch.grasping import samplers as tsamplers
from pointnetgpd_tpu_torch.grasping.gripper import Gripper
from pointnetgpd_tpu_torch.inference import scorer as tscorer
from pointnetgpd_tpu_torch.models.convert import state_dict_from_jax
from pointnetgpd_tpu_torch.models.gpd import GPDClassifier
from pointnetgpd_tpu_torch.models.pointnet import PointNetCls
from pointnetgpd_tpu_torch.ops import cloud as tc
from pointnetgpd_tpu_torch.parallel import mesh as pmesh
from pointnetgpd_tpu_torch.parallel import ranks as pranks
from pointnetgpd_tpu_torch.parallel import tp as ptp
from pointnetgpd_tpu_torch.robot import node as tnode
from pointnetgpd_tpu_torch.training import train as ttrain
from test_torch_cloud_sampler import _jittered, _SeedDraws, _voxelized
from test_torch_slice import JaxDraws, _candidates, _models, _scene


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


def _cpu_mesh(n=8):
    return pmesh.make_mesh(n, device="cpu")


# ------------------------------------------------------------- mesh helpers

def test_mesh_pad_shard_gather_round_trip():
    mesh = _cpu_mesh()
    assert mesh.size == 8 and mesh.distinct() == (torch.device("cpu"),)
    assert pmesh.pad_to_multiple(13, 8) == 16 == pmesh.pad_to_multiple(16, 8)
    x = torch.arange(39, dtype=torch.float32).reshape(13, 3)
    chunks = pmesh.shard_batch(x, mesh, fill=-1)
    assert [tuple(c.shape) for c in chunks] == [(2, 3)] * 8
    back = pmesh.gather(chunks, torch.device("cpu"))
    assert torch.equal(back[:13], x) and bool((back[13:] == -1).all())
    pair = pmesh.gather([(c, c[:, 0]) for c in chunks], torch.device("cpu"))
    assert torch.equal(pair[1], back[:, 0])
    model = torch.nn.Linear(3, 2)
    assert all(m is model for m in pmesh.replicate(model, mesh))
    with pytest.raises(ValueError):
        pmesh.make_mesh(0, device="cpu")
    if not torch.cuda.is_available():    # no silent fallback to the CPU
        with pytest.raises(RuntimeError):
            pmesh.make_mesh(2)
        with pytest.raises(RuntimeError):
            pmesh.make_mesh(2, device="cuda:0")


def test_shard_draws_are_rows_of_the_whole_batch_draw():
    """Each shard's draws, made at one rendezvous, are its rows of what the
    source draws for the whole batch, count-dependent ones included; a
    failing shard raises its own error instead of leaving the others
    waiting."""
    mesh = _cpu_mesh(4)
    count = torch.tensor([0, 3, 900, 7, 12, 1, 64, 5])
    want = Draws(5)
    w_perm = want.crop_perm(50)
    w_win = want.crop_windows(count, 6)
    w_keys = want.crop_keys(8, 11)
    w_res = want.resample(16, 9, 40)

    def shard(s, d):
        rows = slice(2 * s, 2 * s + 2)
        perm = d.crop_perm(50)
        r, start = d.crop_windows(count[rows], 6)
        return perm, r, start, d.crop_keys(2, 11), d.resample(4, 9, 40)

    rv = pmesh.Rendezvous(mesh.size)
    out = pmesh.run_shards(mesh, shard,
                           pmesh.thread_draws(Draws(5), mesh, rv),
                           rendezvous=rv)
    assert all(torch.equal(o[0], w_perm) for o in out)
    assert torch.equal(torch.cat([o[1] for o in out]), w_win[0])
    assert torch.equal(torch.cat([o[2] for o in out]), w_win[1])
    assert torch.equal(torch.cat([o[3] for o in out]), w_keys)
    assert torch.equal(torch.cat([o[4] for o in out]), w_res)

    def failing(s, d):
        if s == 2:
            raise KeyError("shard 2")
        return d.crop_perm(5)

    rv = pmesh.Rendezvous(mesh.size, timeout=60)
    with pytest.raises(KeyError):
        pmesh.run_shards(mesh, failing,
                         pmesh.thread_draws(Draws(0), mesh, rv),
                         rendezvous=rv)


# ------------------------------------------------------------------- scorer

@pytest.mark.parametrize("g", [20, 0])
def test_scorer_on_a_mesh_matches_jax_and_single_device(g):
    pc = _scene(4)
    cand = _candidates(pc, max(g, 1), 5)[:g]      # 20: not a multiple of 8
    params, state, model = _models(1)
    kw = dict(k=3, num_points=96, pad_to=8, min_points=5)
    js = jscorer.GraspScorer(params=params, state=state,
                             mesh=jmesh.make_mesh(), **kw)
    ts = tscorer.GraspScorer(model=model, device="cpu", mesh=_cpu_mesh(),
                             **kw)
    single = tscorer.GraspScorer(model=model, device="cpu", **kw)
    assert ts.pad_to == js.pad_to == 8
    a = js.score_candidates(pc, cand, 0.06, 0.08, seed=4)
    b = ts.score_candidates(pc, cand, 0.06, 0.08,
                            draws=JaxDraws.for_scorer(4))
    c = single.score_candidates(pc, cand, 0.06, 0.08,
                                draws=JaxDraws.for_scorer(4))
    assert b["pred"].shape == (g,)
    for name in ("pred", "counts", "valid", "good_indices"):
        np.testing.assert_array_equal(b[name], np.asarray(a[name]), name)
        np.testing.assert_array_equal(b[name], c[name], name)
    np.testing.assert_allclose(b["prob"], np.asarray(a["prob"]), atol=1e-4)
    np.testing.assert_allclose(b["prob"], c["prob"], atol=1e-6)
    if g:
        assert len(b["good_indices"]) > 1


def test_score_clouds_on_a_mesh_pads_as_jax():
    """5 clouds with pad_to 4 over 8 shards: pad_to becomes 32 on both
    sides, and so does the resample draw."""
    rng = np.random.RandomState(8)
    clouds = rng.randn(5, 100, 3).astype(np.float32)
    params, state, model = _models(2)
    kw = dict(k=3, num_points=64, pad_to=4)
    js = jscorer.GraspScorer(params=params, state=state,
                             mesh=jmesh.make_mesh(), **kw)
    ts = tscorer.GraspScorer(model=model, device="cpu", mesh=_cpu_mesh(),
                             **kw)
    assert ts.pad_to == js.pad_to == 32
    pj, qj, vj = js.score_clouds(clouds, seed=1)
    pt, qt, vt = ts.score_clouds(clouds, draws=JaxDraws(
        k_score=jax.random.PRNGKey(1)))
    single = tscorer.GraspScorer(model=model, device="cpu", k=3,
                                 num_points=64, pad_to=32)
    ps, qs, vs = single.score_clouds(clouds, draws=JaxDraws(
        k_score=jax.random.PRNGKey(1)))
    np.testing.assert_array_equal(pt, np.asarray(pj))
    np.testing.assert_array_equal(vt, np.asarray(vj))
    np.testing.assert_allclose(qt, np.asarray(qj), atol=1e-4)
    np.testing.assert_array_equal(pt, ps)
    np.testing.assert_allclose(qt, qs, atol=1e-6)


# ---------------------------------------------------- normals and sampler

def test_window_normals_on_a_mesh_match_jax():
    """1,200 points in query chunks of 128 over 8 shards: the sorted cloud
    pads to 2,048 (to 1,280 unsharded) and the last chunk's clipped window
    moves, in the JAX package as in the port (20 points' normals change)."""
    pts = _jittered(5, n=1200)
    cam = np.array([0.5, 0.5, 1.0], np.float32)
    kw = dict(k=20, window=256, q_chunk=128)
    n_j = np.asarray(jc.estimate_normals_knn_window(
        pts, cam, exact=True, mesh=jmesh.make_mesh(), **kw))
    n_t = tc.estimate_normals_knn_window(_t(pts), _t(cam), mesh=_cpu_mesh(),
                                         **kw).numpy()
    n_j1 = np.asarray(jc.estimate_normals_knn_window(pts, cam, exact=True,
                                                     **kw))
    n_t1 = tc.estimate_normals_knn_window(_t(pts), _t(cam), **kw).numpy()
    # the mesh-dependent tail is the JAX package's own behavior
    moved = np.abs(n_j1 - n_j).max(axis=1) > 1e-2
    assert moved.sum() >= 10
    np.testing.assert_allclose(n_t[moved], n_j[moved], atol=1e-4)
    # everywhere, within what the unsharded normals meet against JAX on
    # this cloud (a plane fit on random points is ill-conditioned here and
    # there: 2.6e-4 at one point of 1,200, mesh or not)
    err1 = np.abs(n_t1 - n_j1).max()
    assert np.abs(n_t - n_j).max() <= max(1e-4, err1)


@pytest.mark.parametrize("mode", ["lazy", "normals"])
def test_gpg_sampler_on_a_mesh_matches_jax(mode):
    pts = _voxelized(8, n_grid=200)
    cam = np.array([0.5, 0.5, 1.0], np.float32)
    bbox = (pts.min(0), pts.max(0))
    key = jax.random.PRNGKey(3)
    kw = dict(num_seeds=24, camera_pos=cam, normal_k=30, normal_window=256,
              debug=True)
    normals = None
    if mode == "normals":
        normals = np.asarray(jc.estimate_normals_knn(pts, cam, k=30,
                                                     exact=True))
    cj, fj = jsamplers.gpg_sample_candidates(
        pts, normals, key, JGripper(), exact=True, mesh=jmesh.make_mesh(),
        bbox=tuple(map(jnp.asarray, bbox)), **kw)
    out = {}
    for name, mesh in (("mesh", _cpu_mesh()), ("single", None)):
        out[name] = tsamplers.gpg_sample_candidates(
            _t(pts), None if normals is None else _t(normals), Gripper(),
            bbox=tuple(map(_t, bbox)), draws=_SeedDraws(key), mesh=mesh,
            **kw)
    (ct, ft), (cs, fs) = out["mesh"], out["single"]
    vj = np.asarray(cj.valid)
    assert vj.sum() > 0
    np.testing.assert_array_equal(ct.valid.numpy(), vj)
    np.testing.assert_allclose(ct.frames.numpy()[vj],
                               np.asarray(cj.frames)[vj], atol=1e-5)
    assert torch.equal(ct.valid, cs.valid)
    assert torch.equal(ct.frames, cs.frames)
    for name in tsamplers.FUNNEL_STAGES:
        assert int(ft[name]) == int(fj[name]) == int(fs[name]), name


@pytest.mark.parametrize("lazy", [True, False])
def test_detector_frame_on_a_mesh_matches_jax(lazy):
    """The whole frame over an 8-shard mesh (sharded window normals when
    not lazy, sharded GPG frames, sharded scoring) against the JAX
    detector over its 8-device mesh."""
    pts = _scene(0)
    params, state, model = _models(0)
    cfg = dict(num_grasps=20, max_num_samples=64, input_points_num=256,
               minimal_points_send_to_point_net=10, cloud_pad_to=512,
               normal_window=512, lazy_normals=lazy, sampler_exact=True)
    det_j = jnode.GraspDetector(
        jscorer.GraspScorer(params=params, state=state, k=3, num_points=256,
                            pad_to=32, mesh=jmesh.make_mesh()), JGripper(),
        jnode.DetectorConfig(**cfg))
    det_t = tnode.GraspDetector(
        tscorer.GraspScorer(model=model, k=3, num_points=256, pad_to=32,
                            device="cpu", mesh=_cpu_mesh()),
        config=tnode.DetectorConfig(**cfg))
    assert det_t.mesh is det_t.scorer.mesh
    cam = np.array([0.5, 0.5, 1.0], np.float32)
    a = det_j.process_frame(pts, cam, seed=0)
    b = det_t.process_frame(pts, cam, seed=0, draws=JaxDraws.for_frame(0))
    assert b["n_valid"] == a["n_valid"] > 0
    np.testing.assert_allclose(b["all_frames"], np.asarray(a["all_frames"]),
                               atol=1e-5)
    np.testing.assert_array_equal(b["pred"], np.asarray(a["pred"]))
    np.testing.assert_array_equal(b["counts"], np.asarray(a["counts"]))
    np.testing.assert_allclose(b["all_scores"], np.asarray(a["all_scores"]),
                               atol=1e-4)
    assert len(b["scores"]) == len(a["scores"]) > 1
    np.testing.assert_allclose(b["scores"], np.asarray(a["scores"]),
                               atol=1e-4)


def test_detector_warmup_on_a_mesh():
    """``warmup`` runs every bucket through the sharded frame, and the
    frame after it equals the single-device detector's."""
    _, _, model = _models(3)
    cfg = dict(num_grasps=8, max_num_samples=16, input_points_num=64,
               minimal_points_send_to_point_net=5, cloud_pad_to=512)
    dets = [tnode.GraspDetector(tscorer.GraspScorer(
        model=model, k=3, num_points=64, pad_to=8, device="cpu", mesh=mesh),
        config=tnode.DetectorConfig(**cfg)) for mesh in (_cpu_mesh(2), None)]
    assert dets[0].warmup(max_points=1000) == [512, 1024]
    pts, cam = _scene(1, n=150), np.array([0.5, 0.5, 1.0], np.float32)
    a, b = (d.process_frame(pts, cam, seed=2) for d in dets)
    assert a["n_valid"] == b["n_valid"]
    np.testing.assert_array_equal(a["all_frames"], b["all_frames"])
    np.testing.assert_allclose(a["all_scores"], b["all_scores"], atol=1e-6)


# ------------------------------------------------------ tensor parallelism

def _port_cls(params, state, k):
    model = PointNetCls(k=k)
    model.load_state_dict(state_dict_from_jax(params, state))
    return model


def test_tp_shardings_target_the_wide_layers():
    params, state = init_pointnet_cls(jax.random.PRNGKey(0), input_chann=3,
                                      k=3)
    jsh = jtp.tp_param_shardings(params, jtp.make_2d_mesh(8, mp=2))
    tsh = ptp.tp_param_shardings(_port_cls(params, state, 3))
    assert "mp" in str(jsh["feat"]["conv3"]["w"].spec)
    assert tsh["feat.conv3.weight"] == ("mp", None, None)
    assert "mp" in str(jsh["feat"]["stn"]["conv3"]["w"].spec)
    assert tsh["feat.stn.conv3.weight"] == ("mp", None, None)
    assert tsh["feat.bn3.running_var"] == ("mp",)
    assert "mp" in str(jsh["fc1"]["w"].spec)
    assert tsh["fc1.weight"] == (None, "mp")
    assert str(jsh["fc3"]["w"].spec) == "PartitionSpec()"
    assert tsh["fc3.weight"] == () and tsh["feat.stn.fc1.weight"] == ()


def test_tp_forward_matches_replicated_and_jax():
    params, state = init_pointnet_cls(jax.random.PRNGKey(0), input_chann=3,
                                      k=3)
    x = np.random.RandomState(0).randn(8, 64, 3).astype(np.float32)
    mesh_j = jtp.make_2d_mesh(8, mp=2)
    p_tp, s_tp = jtp.shard_params_tp(params, state, mesh_j)
    (logp_j, trans_j), _ = jax.jit(
        lambda p, s, x: apply_pointnet_cls(p, s, x, train=False))(
        p_tp, s_tp, jax.device_put(x, jtp.batch_sharding_2d(mesh_j)))
    model = _port_cls(params, state, 3)
    mesh = ptp.make_2d_mesh(8, mp=2, device="cpu")
    assert mesh.shape == (4, 2)
    tp = ptp.shard_params_tp(model, mesh)
    with torch.no_grad():
        logp_r, trans_r = model(_t(x))
        logp, trans = tp(_t(x))
    np.testing.assert_allclose(logp.numpy(), logp_r.numpy(), atol=2e-5)
    np.testing.assert_allclose(trans.numpy(), trans_r.numpy(), atol=2e-5)
    np.testing.assert_allclose(logp.numpy(), np.asarray(logp_j), atol=2e-5)
    np.testing.assert_allclose(trans.numpy(), np.asarray(trans_j), atol=2e-5)
    full = tp.full_state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(full[k], v), k


@pytest.mark.parametrize("fused_maxpool", [False, True])
def test_tp_train_step_matches_unsharded(fused_maxpool):
    batch = [_t(a) for a in SyntheticGraspData(
        batch_size=8, cloud_points=512, num_classes=2, learnable=True,
        seed=1).next_batch()]
    batch[3] = batch[3].long()
    torch.manual_seed(0)
    model = PointNetCls(num_points=64, k=2).train()
    tp = ptp.shard_params_tp(model, ptp.make_2d_mesh(2, mp=2, device="cpu"))
    step = ttrain.make_fused_train_step(num_points=64, min_point_limit=5,
                                        fused_maxpool=fused_maxpool)
    opt = ttrain.make_optimizer(0.005)
    s1, m1 = step(ttrain.init_train_state(model, opt), *batch, Draws(3))
    s2, m2 = step(ttrain.init_train_state(tp, opt), *batch, Draws(3))
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    g1 = {n: p.grad for n, p in s1.model.named_parameters()}
    g2 = s2.model.full_state_dict(grads=True)
    assert set(g1) == set(g2)
    g_max = max(float(g.abs().max()) for g in g1.values())
    for n, g in g1.items():
        np.testing.assert_allclose(g2[n].numpy(), g.numpy(), rtol=0,
                                   atol=1e-4 * g_max, err_msg=n)
    full = s2.model.full_state_dict()
    for k, v in s1.model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(full[k].numpy(), v.numpy(),
                                       atol=1e-6, err_msg=k)


# ------------------------------------------- the data-parallel train step

_WEIGHTS = np.array([1, 1, 1, 1, 0, 0, 0, 1], np.float32)   # rank 1: 3 of 4


def _dp_batch():
    batch = list(SyntheticGraspData(batch_size=8, cloud_points=512,
                                    num_classes=2, learnable=True,
                                    seed=1).next_batch())
    batch[4] = _WEIGHTS.copy()
    return batch


def _gpd_draws(key, b):
    from test_torch_gpd import _PerSample

    class Src:
        def per_sample(self, n):
            assert n == b
            return _PerSample(jax.random.split(key, n))

    return Src()


@pytest.fixture(scope="module")
def dp_runs():
    """One 1-process step per case (the draws recorded), then the same
    cases on 2 gloo ranks in one spawn."""
    batch, key = _dp_batch(), jax.random.PRNGKey(4)
    cases, one = [], {}
    params, bn = jax.device_get(init_pointnet_cls(jax.random.PRNGKey(0), k=2))
    gparams = jax.device_get(init_gpd_classifier(jax.random.PRNGKey(0), 3))
    for name in ("fp32", "fp64", "fused_maxpool", "gpd"):
        gpd = name == "gpd"
        if gpd:
            model = GPDClassifier(3)
            model.load_state_dict(state_dict_from_jax(gparams, {}))
            base = _gpd_draws(key, 8)
        else:
            model = _port_cls(params, bn, 2)
            base = JaxDraws(k_crop=key)
        case = dict(name=name, gpd=gpd, model=model, batch=batch,
                    num_points=64, min_point_limit=5,
                    fused_maxpool=name == "fused_maxpool",
                    compute_dtype=torch.float64 if name == "fp64" else None)
        rec = pranks.RecordDraws(base)
        state = ttrain.init_train_state(copy.deepcopy(model),
                                        ttrain.make_optimizer(0.005))
        kw = dict(num_points=64, min_point_limit=5)
        step = (ttrain.make_gpd_train_step(**kw) if gpd else
                ttrain.make_fused_train_step(
                    fused_maxpool=case["fused_maxpool"],
                    compute_dtype=case["compute_dtype"], **kw))
        t = [_t(a) for a in batch]
        t[3] = t[3].long()
        state, metrics = step(state, *t, rec)
        one[name] = (state, metrics)
        cases.append(dict(case, tape=rec.tape))
    ranks = pranks.run_step_ranks({"device": "cpu", "cases": cases}, 2,
                                  "gloo", timeout=240)
    return batch, key, (params, bn, gparams), one, ranks


def _jax_mesh_f64(params, bn, batch, key, fused_maxpool):
    """JAX's loss and gradients in float64 with the batch sharded over a
    2-device mesh, on the step's own (float32) crop."""
    g, c, t, lab, w = batch
    pts, _, valid = jcrop.collect_grasp_clouds_batched(
        g, c, t, key, num_out=64, min_point_limit=5)
    w = w * np.asarray(valid, np.float32)
    mesh = jmesh.make_mesh(2)
    with jax.enable_x64(True):
        f64 = lambda tree: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), tree)
        sh = jmesh.batch_sharding(mesh)
        x, lab_d, w_d = (jax.device_put(a, sh) for a in (
            np.asarray(pts, np.float64), np.asarray(lab),
            np.asarray(w, np.float64)))

        def loss_fn(p, x, lab_d, w_d):
            (logp, _), _ = apply_pointnet_cls(p, f64(bn), x, train=True,
                                              fused_maxpool=fused_maxpool)
            return jtrain.masked_nll_loss(logp, lab_d, w_d)

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            jmesh.replicate_tree(f64(params), mesh), x, lab_d, w_d)
        grads = state_dict_from_jax(jax.device_get(grads), {})
        return float(loss), {k: v.numpy() for k, v in grads.items()}


@pytest.mark.parametrize("name", ["fp32", "fp64", "fused_maxpool", "gpd"])
def test_two_rank_step_matches_one_process_and_jax(dp_runs, name):
    batch, key, (params, bn, gparams), one, ranks = dp_runs
    state, metrics = one[name]
    r0, r1 = (next(r for r in rk if r["name"] == name) for rk in ranks)
    loss1 = float(metrics["loss"])
    for r in (r0, r1):
        np.testing.assert_allclose(r["metrics"]["loss"], loss1, rtol=1e-5)
        np.testing.assert_allclose(r["metrics"]["acc"], float(metrics["acc"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(r["metrics"]["valid_frac"],
                                   float(metrics["valid_frac"]), rtol=1e-6)
    # the ranks hold 4 and 1 valid samples: a per-rank loss denominator
    # would weigh rank 1's sample four times
    assert _WEIGHTS[:4].sum() != _WEIGHTS[4:].sum()
    g1 = {n: p.grad.numpy() for n, p in state.model.named_parameters()}
    g_max = max(float(np.abs(g).max()) for g in g1.values())
    for n, g in g1.items():
        assert torch.equal(r0["grads"][n], r1["grads"][n]), n
        # the STN's float32 gradients are ill-conditioned (ROADMAP Queue C
        # item 2): held to 1e-3 here and to float64 below
        tol = 1e-3 if n.startswith("feat.stn.") and name != "fp64" else 1e-4
        np.testing.assert_allclose(r0["grads"][n].numpy(), g, rtol=0,
                                   atol=tol * g_max, err_msg=n)
    for k, v in state.model.named_buffers():
        for r in (r0, r1):
            np.testing.assert_allclose(
                r["buffers"][k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                err_msg=k)
    if name == "gpd":
        # no BatchNorm: the ranks' sum is the one-process gradient
        for n, g in g1.items():
            np.testing.assert_allclose(r0["grads"][n].numpy(), g, rtol=0,
                                       atol=1e-6 * g_max, err_msg=n)
        return
    loss64, g64 = _jax_mesh_f64(params, bn, batch, key,
                                name == "fused_maxpool")
    np.testing.assert_allclose(r0["metrics"]["loss"], loss64, rtol=1e-5)
    g64_max = max(float(np.abs(g).max()) for g in g64.values())
    for n, g in g64.items():
        if np.abs(g).max() < 1e-9 * g64_max:      # absorbed by a BN: noise
            continue
        np.testing.assert_allclose(r0["grads"][n].numpy().reshape(g.shape),
                                   g, rtol=0, atol=1e-3 * g64_max,
                                   err_msg=n)


def test_cli_train_on_two_ranks_writes_one_checkpoint(tmp_path):
    from pointnetgpd_tpu_torch.cli import train as tcli

    models, logs = tmp_path / "m", tmp_path / "log"
    rc = tcli.main(["--variant", "1v", "--mode", "train", "--synthetic",
                    "--device", "cpu", "--batch-size", "4",
                    "--cloud-points", "512", "--steps-per-epoch", "1",
                    "--eval-steps", "1", "--epoch", "1", "--n-devices", "2",
                    "--model-path", str(models), "--log-dir", str(logs)])
    assert rc == 0
    assert len(os.listdir(models)) == 1
    assert os.path.exists(logs / "default" / "metrics.jsonl")


def test_trainer_refuses_n_devices_without_a_group(tmp_path):
    from pointnetgpd_tpu_torch.training.loop import TrainConfig, Trainer

    with pytest.raises(RuntimeError):
        Trainer(TrainConfig(n_devices=2, device="cpu",
                            model_path=str(tmp_path / "m"),
                            log_dir=str(tmp_path / "l")), iter(()))

