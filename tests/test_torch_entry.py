"""The port's online entry points against the JAX package: ``score_clouds``
(padded, empty, dual, bf16), ``remove_grasp_outside_tray``, ``warmup``,
``run_ros_node`` (with in-process stand-ins for the ROS modules), the
PointCloud2 and message helpers, ``robot_state.at_home``, ``cli.infer`` and
``GraspDetector`` over a ``GPDScorer``.

JAX's resample draws reach the port through ``JaxDraws`` (same keys, same
calls), so classes and votes agree exactly and probabilities to 1e-5.
"""

import contextlib
import io
import sys
import types
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnetgpd_tpu.inference import scorer as jscorer
from pointnetgpd_tpu.models.pointnet import init_pointnet_cls
from pointnetgpd_tpu.robot import node as jnode
from pointnetgpd_tpu.robot import pointclouds as jpc
from pointnetgpd_tpu.robot import ros_messages as jmsg
from pointnetgpd_tpu.robot import robot_state as jstate
from pointnetgpd_tpu_torch.grasping.gripper import Gripper
from pointnetgpd_tpu_torch.inference import scorer as tscorer
from pointnetgpd_tpu_torch.models import pointnet as tpointnet
from pointnetgpd_tpu_torch.models.convert import (pointnet_cls_from_state_dict,
                                                  state_dict_from_jax)
from pointnetgpd_tpu_torch.robot import node as tnode
from pointnetgpd_tpu_torch.robot import pointclouds as tpc
from pointnetgpd_tpu_torch.robot import ros_messages as tmsg
from pointnetgpd_tpu_torch.robot import robot_state as tstate
from test_robot import _FakeDetector, _fake_pc2, _fake_ros_modules
from test_torch_slice import JaxDraws, _scene

GOLDEN = "tests/fixtures/golden_pointnet_3class.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(seed, k=3, dual=False):
    params, state = jax.device_get(init_pointnet_cls(
        jax.random.PRNGKey(seed), input_chann=6 if dual else 3, k=k,
        dual=dual))
    model = pointnet_cls_from_state_dict(state_dict_from_jax(params, state),
                                         device="cpu")
    return params, state, model


def _clouds(g, p, c, seed):
    return np.random.RandomState(seed).randn(g, p, c).astype(np.float32) \
        * 0.03


# ------------------------------------------------------------ score_clouds

@pytest.mark.parametrize("g", [5, 0, 16])
def test_score_clouds_matches_jax(g):
    params, state, model = _models(0)
    clouds = _clouds(g, 200, 3, g)
    valid = np.ones(g, bool)
    valid[1::4] = False
    js = jscorer.GraspScorer(params=params, state=state, k=3, num_points=64,
                             repeat=3, pad_to=8)
    ts = tscorer.GraspScorer(model=model, k=3, num_points=64, repeat=3,
                             pad_to=8, device="cpu")
    a = js.score_clouds(clouds, valid=valid, seed=3)
    b = ts.score_clouds(clouds, valid=valid,
                        draws=JaxDraws(k_score=jax.random.PRNGKey(3)))
    assert b[0].shape == (g,) and b[1].shape == (g, 3) \
        and b[2].shape == (g, 3)
    np.testing.assert_array_equal(b[0], np.asarray(a[0]))
    np.testing.assert_array_equal(b[2], np.asarray(a[2]))
    np.testing.assert_allclose(b[1], np.asarray(a[1]), atol=1e-5)
    if g:
        assert (b[0][~valid] == 0).all() and (b[1][~valid] == 0).all()


def test_dual_scorer_matches_jax(tmp_path):
    """A DualPointNetCls from ``init_pointnet_cls(dual=True)`` parameters,
    carried across, scores (G, P, 6) clouds as JAX's ``dual=True``
    scorer does; ``from_checkpoint`` builds it from a dual state dict."""
    params, state, model = _models(1, k=2, dual=True)
    assert isinstance(model, tpointnet.DualPointNetCls)
    clouds = _clouds(7, 150, 6, 0)
    js = jscorer.GraspScorer(params=params, state=state, k=2, dual=True,
                             num_points=96, repeat=2, pad_to=8)
    a = js.score_clouds(clouds, seed=4)
    path = tmp_path / "dual.npz"
    np.savez(path, **{k: v.numpy() for k, v in
                      state_dict_from_jax(params, state).items()})
    ts = tscorer.GraspScorer.from_checkpoint(path, device="cpu", dual=True,
                                             num_points=96, repeat=2,
                                             pad_to=8)
    assert isinstance(ts.model, tpointnet.DualPointNetCls) and ts.k == 2
    b = ts.score_clouds(clouds, draws=JaxDraws(k_score=jax.random.PRNGKey(4)))
    np.testing.assert_array_equal(b[0], np.asarray(a[0]))
    np.testing.assert_array_equal(b[2], np.asarray(a[2]))
    np.testing.assert_allclose(b[1], np.asarray(a[1]), atol=1e-5)
    with pytest.raises(ValueError, match="dual"):
        tscorer.GraspScorer.from_checkpoint(path, device="cpu", dual=False)


def test_bf16_scorer_agrees_with_jax(monkeypatch, capsys):
    """JAX's own criterion (tests/test_scorer.py): the bf16 scorer's classes
    agree with fp32's on at least half the clouds, here against JAX's bf16
    and fp32 predictions. Its trunks still go through K2's route in
    float32 (2 per forward), never in bf16."""
    params, state, model = _models(0)
    clouds = _clouds(6, 200, 3, 4) / 0.03
    js32 = jscorer.GraspScorer(params=params, state=state, k=3,
                               num_points=128, pad_to=8)
    j16 = np.asarray(js32.as_dtype(jnp.bfloat16).score_clouds(clouds)[0])
    j32 = np.asarray(js32.score_clouds(clouds)[0])
    ts = tscorer.GraspScorer(model=model, k=3, num_points=128, pad_to=8,
                             device="cpu")
    t16s = ts.as_dtype(torch.bfloat16)
    assert ts.model.fc3.weight.dtype == torch.float32
    assert t16s.model.fc3.weight.dtype == torch.bfloat16
    seen = []
    real = tpointnet.fused_trunk

    def spy(x, folded):
        seen.append((x.dtype, folded[0].dtype))
        return real(x, folded)

    monkeypatch.setattr(tpointnet, "fused_trunk", spy)
    pred, prob, _ = t16s.score_clouds(
        clouds, draws=JaxDraws(k_score=jax.random.PRNGKey(0)))
    assert seen == [(torch.float32, torch.float32)] * 2
    assert prob.dtype == np.float32 and np.isfinite(prob).all()
    agree16, agree32 = (pred == j16).mean(), (pred == j32).mean()
    with capsys.disabled():
        print(f"\nbf16 class agreement: {agree16:.3f} with JAX bf16, "
              f"{agree32:.3f} with JAX fp32")
    assert agree16 >= 0.5 and agree32 >= 0.5


# ------------------------------------------------------------ robot/node

def test_remove_grasp_outside_tray_matches_jax():
    frames = np.random.RandomState(0).uniform(-0.4, 0.4, (50, 5, 3))
    for kw in ({}, {"tray_x": (-0.1, 0.3), "tray_y": (0.0, 0.2)}):
        np.testing.assert_array_equal(
            tnode.remove_grasp_outside_tray(frames, **kw),
            jnode.remove_grasp_outside_tray(frames, **kw))


def test_warmup_buckets_match_jax():
    params, state, model = _models(0)
    kw = dict(num_grasps=8, max_num_samples=8, input_points_num=64, repeat=1,
              minimal_points_send_to_point_net=5, cloud_pad_to=512)
    jdet = jnode.GraspDetector(
        jscorer.GraspScorer(params=params, state=state, k=3, num_points=64,
                            pad_to=16), config=jnode.DetectorConfig(**kw))
    tdet = tnode.GraspDetector(
        tscorer.GraspScorer(model=model, k=3, num_points=64, pad_to=16,
                            device="cpu"),
        config=tnode.DetectorConfig(adaptive_bucket=True, **kw))
    tdet._last_voxel_count = 10          # would shrink an adaptive bucket
    got = tdet.warmup(max_points=1024)
    assert got == jdet.warmup(max_points=1024) == [512, 1024]
    assert tdet._last_voxel_count is None


class _PortFakeDetector(_FakeDetector):
    """test_robot's duck-typed detector with the port's gripper."""

    def __init__(self):
        super().__init__()
        self.gripper = Gripper()


@pytest.mark.parametrize("case", ["one_cycle", "pipelined", "stale_drop",
                                  "publish_all_gating"])
def test_run_ros_node_cases(monkeypatch, case):
    """tests/test_robot.py's four node cases, on the port's loop."""
    pts = np.random.RandomState(0).rand(64, 3).astype(np.float32)
    fake = dict(robot_away_first=case == "publish_all_gating",
                away_on_calls=(2,) if case == "stale_drop" else ())
    published, params, state = _fake_ros_modules(monkeypatch, _fake_pc2(pts),
                                                 **fake)
    det = _PortFakeDetector()
    kw = {"one_cycle": dict(max_frames=1),
          "pipelined": dict(max_frames=3, pipeline=True),
          "stale_drop": dict(max_frames=2, pipeline=True),
          "publish_all_gating": dict(max_frames=1, publish_all=True)}[case]
    tnode.run_ros_node(det, cam_pos=np.zeros(3), **kw)
    glist = published["/detect_grasps/clustered_grasps"]
    if case == "one_cycle":
        assert params["/robot_at_home"] == "true"
        np.testing.assert_allclose(det.frames_seen[0], pts, atol=1e-6)
        markers = published["gripper_vis"]
        assert len(markers) == 1 and len(markers[0].markers) == 6
        assert len(glist) == 1 and len(glist[0].grasps) == 1
        g0 = glist[0].grasps[0]
        np.testing.assert_allclose([g0.bottom.x, g0.bottom.y, g0.bottom.z],
                                   det._grasps[0, 4], atol=1e-6)
        assert g0.score.data == np.float32(0.9)
    elif case == "pipelined":
        assert len(det.frames_seen) == 3 and len(glist) == 3
    elif case == "stale_drop":
        assert len(det.frames_seen) == 2 and len(glist) == 1
    else:
        assert state["sleeps"] >= 1 and len(det.frames_seen) == 1
        assert len(glist[0].grasps) == 2


@pytest.mark.parametrize("pipeline", [False, True])
def test_run_ros_node_publishes_process_frame_best(monkeypatch, pipeline):
    """The real detector behind the loop: the published best grasp and its
    score are ``process_frame``'s first ranked grasp for the same seed."""
    _, _, model = _models(0)
    pts = _scene(0)
    cfg = tnode.DetectorConfig(num_grasps=20, max_num_samples=64,
                               input_points_num=128,
                               minimal_points_send_to_point_net=10,
                               cloud_pad_to=512)
    model.fc3.bias.data += torch.tensor([0.0, 0.0, 1.0])    # some are good
    det = tnode.GraspDetector(tscorer.GraspScorer(
        model=model, k=3, num_points=128, pad_to=32, device="cpu"),
        config=cfg)
    cam = np.array([0.5, 0.5, 1.0], np.float32)
    published, _, _ = _fake_ros_modules(monkeypatch, _fake_pc2(pts))
    tnode.run_ros_node(det, cam_pos=cam, max_frames=2, pipeline=pipeline)
    glist = published["/detect_grasps/clustered_grasps"]
    assert len(glist) == 2
    for seed, msg in enumerate(glist):
        want = det.process_frame(pts, cam, seed=seed)
        assert len(want["grasps"]) > 0
        g0 = msg.grasps[0]
        np.testing.assert_array_equal(
            [g0.bottom.x, g0.bottom.y, g0.bottom.z], want["grasps"][0, 4])
        np.testing.assert_array_equal(
            [g0.approach.x, g0.approach.y, g0.approach.z],
            want["grasps"][0, 1])
        assert g0.score.data == float(want["scores"][0])


def test_detector_with_gpd_scorer_matches_jax():
    """``GraspDetector`` over the GPD baseline's scorer (the counterpart of
    tests/test_robot.py's ``test_detector_accepts_gpd_scorer``), held to
    JAX's frame under the same draws."""
    from pointnetgpd_tpu.inference import GPDScorer as JGPDScorer
    from pointnetgpd_tpu.models.gpd import init_gpd_classifier
    from pointnetgpd_tpu_torch.inference.gpd_scorer import GPDScorer
    from pointnetgpd_tpu_torch.models.gpd import GPDClassifier

    params = jax.device_get(init_gpd_classifier(jax.random.PRNGKey(0),
                                                input_chann=3))
    params["fc2"]["b"] = params["fc2"]["b"] + np.array([0.0, 0.05],
                                                       np.float32)
    model = GPDClassifier(3)
    model.load_state_dict(state_dict_from_jax(params, {}))
    kw = dict(num_points=64, pad_to=8, min_points=3)
    jdet = jnode.GraspDetector(JGPDScorer(params=params, project_chann=3,
                                          **kw))
    tdet = tnode.GraspDetector(GPDScorer(model, project_chann=3,
                                         device="cpu", **kw))
    rng = np.random.RandomState(0)
    n = 400
    top = rng.rand(n, 3) * [0.06, 0.06, 0] + [-0.03, -0.03, 0.06]
    side = rng.rand(n, 3) * [0.06, 0, 0.06] + [-0.03, -0.03, 0.0]
    pts = np.concatenate([top, side]).astype(np.float32)
    cam = np.array([0.5, 0, 0.5], np.float32)
    a = jdet.process_frame(pts, cam_pos=cam, seed=0)
    frame = JaxDraws.for_frame(0)
    b = tdet.process_frame(pts, cam_pos=cam, seed=0, draws=JaxDraws(
        frame.k_seed, k_crop=jax.random.PRNGKey(1)))
    assert b["n_valid"] == a["n_valid"] > 0
    np.testing.assert_allclose(b["all_frames"], np.asarray(a["all_frames"]),
                               atol=1e-5)
    np.testing.assert_array_equal(b["pred"], np.asarray(a["pred"]))
    np.testing.assert_array_equal(b["counts"], np.asarray(a["counts"]))
    np.testing.assert_allclose(b["all_scores"], np.asarray(a["all_scores"]),
                               atol=1e-4)
    assert np.isfinite(b["all_scores"]).all()


# ---------------------------------------------- PointCloud2 and messages

class TestPointCloud2:
    def test_roundtrip(self):
        pts = np.random.RandomState(0).randn(100, 3).astype(np.float32)
        arr = tpc.pointcloud2_to_array(_fake_pc2(pts))
        assert arr.shape == (100,) and arr.dtype == \
            jpc.pointcloud2_to_array(_fake_pc2(pts)).dtype
        np.testing.assert_array_equal(tpc.get_xyz_points(arr), pts)

    def test_point_step_padding(self):
        pts = np.random.RandomState(1).randn(50, 3).astype(np.float32)
        out = tpc.pointcloud2_to_xyz_array(_fake_pc2(pts, extra_pad=True))
        np.testing.assert_array_equal(out, pts)

    def test_nan_removal(self):
        pts = np.random.RandomState(2).randn(20, 3).astype(np.float32)
        pts[5] = np.nan
        out = tpc.pointcloud2_to_xyz_array(_fake_pc2(pts))
        assert out.shape == (19, 3)
        np.testing.assert_array_equal(
            out, jpc.pointcloud2_to_xyz_array(_fake_pc2(pts)))

    def test_xyz_array_to_pointcloud2(self, monkeypatch):
        mod = types.ModuleType("sensor_msgs.msg")
        mod.PointCloud2 = lambda: SimpleNamespace(header=SimpleNamespace())
        mod.PointField = lambda **kw: SimpleNamespace(**kw)
        monkeypatch.setitem(sys.modules, "sensor_msgs",
                            types.ModuleType("sensor_msgs"))
        monkeypatch.setitem(sys.modules, "sensor_msgs.msg", mod)
        pts = np.random.RandomState(3).randn(30, 3).astype(np.float32)
        msg = tpc.xyz_array_to_pointcloud2(pts, frame_id="/table_top")
        assert vars(msg).keys() == vars(
            jpc.xyz_array_to_pointcloud2(pts, frame_id="/table_top")).keys()
        np.testing.assert_array_equal(tpc.pointcloud2_to_xyz_array(msg), pts)


def _fields(obj, prefix=""):
    """Flatten a stand-in message into {path: value}."""
    out = {}
    for k, v in vars(obj).items():
        if hasattr(v, "__dict__") and not isinstance(v, type):
            out.update(_fields(v, f"{prefix}{k}."))
        elif isinstance(v, list):
            for i, item in enumerate(v):
                out.update(_fields(item, f"{prefix}{k}[{i}]."))
        else:
            out[prefix + k] = v
    return out


def test_ros_messages_match_jax(monkeypatch):
    from pointnetgpd_tpu.grasping.gripper import Gripper as JGripper

    _fake_ros_modules(monkeypatch, _fake_pc2(np.zeros((1, 3), np.float32)))
    grasps = _FakeDetector()._grasps
    rot = np.random.RandomState(0).randn(3, 3)
    grasps = np.concatenate([grasps, grasps[:1]])
    grasps[2, 1:4] = np.linalg.qr(rot)[0].T           # a general rotation
    scores = np.array([0.9, 0.7, 0.4], np.float32)
    a = _fields(tmsg.gripper_marker_array(grasps, Gripper()))
    b = _fields(jmsg.gripper_marker_array(grasps, JGripper()))
    assert a.keys() == b.keys() and len(a) > 0
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)
    a = _fields(tmsg.grasp_config_list_msg(grasps, scores))
    b = _fields(jmsg.grasp_config_list_msg(grasps, scores))
    assert a == b


@pytest.mark.parametrize("joints", [
    [0.0, -1.5708, 0.0, -1.5708, 0.0, 0.0],
    [0.005, -1.565, -0.009, -1.5708, 0.0, 0.0],
    [0.0, -1.5708, 0.0, -1.5708, 0.0, 0.02],
    [0.5, 0.0, 0.0, 0.0, 0.0, 0.0]])
def test_robot_state_at_home_matches_jax(joints):
    assert tstate.at_home(joints) == jstate.at_home(joints)
    assert tstate.at_home(joints, tol=0.05) == jstate.at_home(joints,
                                                               tol=0.05)


# ------------------------------------------------------------- cli.infer

def _run(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv, **kw) == 0
    lines = buf.getvalue().splitlines()
    out = {ln.split(":", 1)[0]: ln.split(":", 1)[1].strip() for ln in lines
           if ":" in ln}
    out["lines"] = lines
    return out


def test_cli_infer_matches_jax(tmp_path):
    """cli.infer on the golden checkpoint (its .npz), ``--device cpu``:
    the printed votes and prediction equal JAX's under the same draws, the
    probabilities to the printed digits."""
    from pointnetgpd_tpu.cli import infer as jinfer
    from pointnetgpd_tpu.models.convert import convert_state_dict
    from pointnetgpd_tpu_torch.cli import infer as tinfer

    cloud = np.random.RandomState(0).randn(700, 3).astype(np.float32) * 0.02
    np.save(tmp_path / "cloud.npy", cloud)
    # the JAX CLI reads reference torch files; the same weights as a .pt
    sd = dict(np.load(GOLDEN))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "golden.pt")
    common = ["--input", str(tmp_path / "cloud.npy"), "--repeat", "10",
              "--seed", "2"]
    a = _run(jinfer.main, ["--load-model", str(tmp_path / "golden.pt")]
             + common)
    b = _run(tinfer.main, ["--load-model", GOLDEN, "--device", "cpu"]
             + common, draws=JaxDraws(k_score=jax.random.PRNGKey(2)))
    assert b["voting"] == a["voting"] and b["Test result"] == a["Test result"]
    pa, pb = (np.array(eval(d["class probabilities"])) for d in (a, b))
    np.testing.assert_allclose(pb, pa, atol=1.5e-4)
    assert convert_state_dict(sd)[0]["fc3"]["w"].shape[0] == 3


def test_cli_infer_resolves_training_checkpoint_dir(tmp_path):
    """``--load-model`` on the train CLI's directory resolves its newest
    step and predicts as the model saved there."""
    from pointnetgpd_tpu_torch.cli import infer as tinfer
    from pointnetgpd_tpu_torch.draws import Draws
    from pointnetgpd_tpu_torch.training import train as ttrain
    from pointnetgpd_tpu_torch.training.checkpoint import save_checkpoint

    _, _, model = _models(2, k=2)
    st = ttrain.init_train_state(model, ttrain.make_optimizer(0.005))
    save_checkpoint(str(tmp_path / "m"), st, step=3)
    st.model.fc3.bias.data += 5.0                     # an older step differs
    save_checkpoint(str(tmp_path / "m"), st, step=1)
    st.model.fc3.bias.data -= 5.0
    cloud = np.random.RandomState(1).randn(400, 3).astype(np.float32) * 0.02
    np.save(tmp_path / "cloud.npy", cloud)
    out = _run(tinfer.main, ["--load-model", str(tmp_path / "m"), "--k", "2",
                             "--device", "cpu", "--input",
                             str(tmp_path / "cloud.npy"), "--repeat", "4",
                             "--exact"])
    assert out["lines"][0] == (f"resolved {tmp_path / 'm'} -> "
                               f"{tmp_path / 'm' / 'step_3'}")
    want = tscorer.GraspScorer(model=model, k=2, num_points=500, repeat=4,
                               device="cpu").score_clouds(
        cloud[None], draws=Draws(0))
    assert out["voting"] == str(want[2][0].tolist())
    assert out["Test result"] == str(int(want[0][0]))
    with pytest.raises(ValueError, match="2-class"):
        tinfer.main(["--load-model", str(tmp_path / "m"), "--k", "3",
                     "--device", "cpu", "--input",
                     str(tmp_path / "cloud.npy")])
