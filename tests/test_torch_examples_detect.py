"""The port's ``integrated_workflow.detect_stage`` against the JAX driver's
``examples/integrated_workflow.py detect_stage``, on one prepared tree
(two synthetic meshes, an ellipsoid and a box, SDFs at sdf_dim 32) with the same weights (JAX's
initial 2-class PointNetCls, its best class favored, written as the
reference's state dict by ``state_dict_from_jax``), 8 GPG seeds, the JAX
driver's 8192 bucket and the three presets, one per test (JAX's stage
answers its other two presets with an empty frame there), the port under
JAX's draws
(``test_torch_slice.JaxDraws``, whose seed uniforms also serve the height
bias). JAX's force-only Ferrari-Canny metric runs in float64
(``exact_jax_canny``), as the port's does.

Stated tolerances, per preset: the scene's points and objects, the
candidate count, ``n_valid``, the per-candidate predictions and crop counts,
the class histogram and the approved count exactly; frames within 1e-4
(their axes are eigenvectors of the normals' covariance, which amplifies
the normals' 7e-7 agreement); scores within 1e-5; every ground-truth array within 1e-5 (object indices
and the validity mask exactly) and the ground-truth summary within 1e-5.
The funnel's counts exactly. The port runs torch on 4 threads. Where it
differs, the difference must be decided by rounding: the port's run under
a change that moves only its rounding (torch's CPU reductions and matmuls
on 1 thread instead of 4, or every normal it estimates moved one ulp up or
down) must give JAX's
result under all of the above, and every run's funnel counts lie within 2%
of the frames of JAX's. (On a flat face the normals' covariance is rank
one and its in-plane eigenvectors, the grasp frame's axes, are set by
rounding; the two stacks' float32 normals agree to 7e-7, not bit for
bit.)
"""

import numpy as np
import jax
import pytest
import torch

from examples import integrated_workflow as jwf
from pointnetgpd_tpu.models.pointnet import init_pointnet_cls
from pointnetgpd_tpu.pipelines import ground_truth as jgt
from pointnetgpd_tpu.robot import node as jnode
from pointnetgpd_tpu_torch.examples import integrated_workflow as twf
from pointnetgpd_tpu_torch.grasping import samplers as tsamplers
from pointnetgpd_tpu_torch.models.convert import state_dict_from_jax
from pointnetgpd_tpu_torch.pipelines import prepare_objects as tprep
from pointnetgpd_tpu_torch.robot import node as tnode

from test_torch_labeling import exact_jax_canny
from test_torch_slice import JaxDraws

TOL = 1e-5
# grasp frames: their axes are eigenvectors of the normals' covariance,
# whose conditioning amplifies the two stacks' 7e-7 normals (1.7e-5 seen)
FRAME_TOL = 1e-4
NUM_SEEDS = 8
KW = dict(seed=0, num_classes=2, num_seeds=NUM_SEEDS, num_point=750)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The prepared tree and the weights file."""
    root = tmp_path_factory.mktemp("detect")
    names = twf.synth_meshes(str(root), 2, seed=0)
    tprep.main(["--data-root", str(root), "--sdf-dim", "32", "--device",
                "cpu"])
    params, state = jax.device_get(init_pointnet_cls(
        jax.random.PRNGKey(0), input_chann=3, k=2))
    params["fc3"]["b"] = params["fc3"]["b"] + np.float32([0.0, 1.0])
    weights = str(root / "weights.pt")
    torch.save(state_dict_from_jax(params, state), weights)
    return str(root), names, weights


def _preset_of(cfg):
    """The detect stage's preset that built the JAX config ``cfg``."""
    if cfg.seed_bias == "height":
        return "production_height_bias"
    return "reference_parity" if cfg.sampler_exact else "production"


def _jax(tree, preset):
    """JAX's detect stage with ``preset`` run and its frame and ground
    truth recorded. The stage always runs all three presets: the other two
    are answered with a frame of no candidates and no ground truth, so that
    each test pays for one preset's compiles."""
    root, names, weights = tree
    rec = {}

    def frame(self, pts, *a, **k):
        rec["this"] = _preset_of(self.cfg) == preset
        if not rec["this"]:
            return {"pred": np.zeros(0, np.int32), "points": pts,
                    "all_frames": np.zeros((0, 4, 4), np.float32),
                    "all_scores": np.zeros(0, np.float32), "n_valid": 0,
                    "grasps": [], "scores": [], "funnel": {}}
        rec["frame"] = process_frame(self, pts, *a, **k)
        return rec["frame"]

    def gt(*a, **k):
        if not rec["this"]:
            return {"eps_good": np.zeros(0), "fc_good": np.zeros(0, bool),
                    "center_sdf": np.zeros(0), "label_valid": np.zeros(0)}
        rec["gt"] = ground_truth_quality(*a, **k)
        return rec["gt"]

    process_frame = jnode.GraspDetector.process_frame
    ground_truth_quality = jgt.ground_truth_quality
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False), \
            exact_jax_canny():
        mp.setattr(jnode.GraspDetector, "process_frame", frame)
        mp.setattr(jgt, "ground_truth_quality", gt)
        want = jwf.detect_stage(root, weights, names, **KW)
    return want, (rec["frame"], rec["gt"])


def _port(tree, preset):
    """The port's detect stage under JAX's draws, drawn as JAX's run drew
    them (float32, x64 off)."""
    root, names, weights = tree
    raw = {}
    with jax.enable_x64(False):
        got = twf.detect_stage(root, weights, names, device="cpu",
                               draws_for=lambda p, s: JaxDraws.for_frame(s),
                               presets=(preset,), raw=raw, **KW)
    return got, raw[preset]


def _close(got, want, name):
    if want is None or got is None:
        assert got is want is None, name
    else:
        assert abs(got - want) <= TOL, (name, got, want)


def _compare(got, out, gt, want, out_j, gt_j, preset):
    """Assert the port's detect result for ``preset`` equals JAX's."""
    assert got["scene_points"] == want["scene_points"] > 0
    assert got["scene_objects"] == want["scene_objects"]
    assert len(got["scene_objects"]) == 2
    g, w = got[preset], want[preset]

    # the frame
    assert out["n_valid"] == int(out_j["n_valid"]) == g["n_valid"] \
        == w["n_valid"]
    assert g["candidates"] == w["candidates"] > 0
    np.testing.assert_array_equal(out["pred"], np.asarray(out_j["pred"]))
    np.testing.assert_array_equal(out["counts"], np.asarray(out_j["counts"]))
    np.testing.assert_allclose(out["all_frames"],
                               np.asarray(out_j["all_frames"]),
                               atol=FRAME_TOL)
    np.testing.assert_allclose(out["all_scores"],
                               np.asarray(out_j["all_scores"]), atol=TOL)
    np.testing.assert_array_equal(out["points"].numpy(),
                                  np.asarray(out_j["points"]))
    for k in ("pred_hist", "good_grasps"):
        assert g[k] == w[k], k
    _close(g["top_score"], w["top_score"], "top_score")
    assert g["funnel"] == w["funnel"]
    assert g["funnel"]["frames"] == NUM_SEEDS * 19

    # the ground truth
    for k in ("obj_idx", "label_valid", "fc_good"):
        np.testing.assert_array_equal(gt[k], gt_j[k], k)
    for k in ("fc_label", "eps_label", "score", "eps_good", "center_sdf"):
        np.testing.assert_allclose(gt[k], gt_j[k], atol=TOL, err_msg=k)
    assert g["ground_truth"].keys() == w["ground_truth"].keys()
    for k, v in w["ground_truth"].items():
        _close(g["ground_truth"][k], v, k)


def _nudge_normals(monkeypatch, direction):
    """Move every normal the detector estimates by one ulp."""
    def ulp(x):
        return torch.from_numpy(np.nextafter(
            x.numpy(), np.float32(direction * np.inf)))

    swn, knn = tsamplers.seed_window_normals, tnode.estimate_normals_knn
    win = tnode.estimate_normals_knn_window
    monkeypatch.setattr(tsamplers, "seed_window_normals", lambda *a, **k: (
        lambda r: (r[0], ulp(r[1]), ulp(r[2])))(swn(*a, **k)))
    monkeypatch.setattr(tnode, "estimate_normals_knn",
                        lambda *a, **k: ulp(knn(*a, **k)))
    monkeypatch.setattr(tnode, "estimate_normals_knn_window",
                        lambda *a, **k: ulp(win(*a, **k)))


# the port's run, then its rounding-only changes: torch's CPU reductions
# and matmuls round by the thread count, and every estimated normal one
# ulp. 4 threads first: the quickest (reference_parity's all-point normals)
VARIANTS = [(4, 0), (1, 0), (1, 1), (1, -1)]


@pytest.mark.parametrize("preset", ["production", "production_height_bias",
                                    "reference_parity"])
def test_detect_stage_matches_jax(tree, preset):
    want, raw_j = _jax(tree, preset)
    errors, funnels = [], []
    for threads, direction in VARIANTS:
        with pytest.MonkeyPatch.context() as mp:
            if direction:
                _nudge_normals(mp, direction)
            torch.set_num_threads(threads)
            try:
                got, (out, gt) = _port(tree, preset)
            finally:
                torch.set_num_threads(1)
        funnels.append(got[preset]["funnel"])
        try:
            _compare(got, out, gt, want, *raw_j, preset)
            break
        except AssertionError as e:
            errors.append(e)
    else:
        raise errors[0]
    # a variant other than the first: the difference was decided by
    # rounding, and the runs' funnels stay within 2% of the frames
    frames = want[preset]["funnel"]["frames"]
    for f in funnels:
        assert sum(abs(f[k] - v) for k, v in want[preset]["funnel"].items()
                   ) <= 0.02 * frames
