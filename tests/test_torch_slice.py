"""The port's online frame against the JAX package, piece by piece and whole:
the candidate crop, the fused scorer and ``GraspDetector.process_frame``.

JAX's PRNG cannot be reproduced in torch, so ``JaxDraws`` derives every draw
the way the JAX package does (same keys, same calls) and the port takes
them as injected draws. With them, crops agree in counts and validity
exactly and in points to 1e-5; a whole frame agrees in ``n_valid``, the
predictions and the ranked order exactly, frames to 1e-5 and scores to 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnetgpd_tpu.grasping.gripper import Gripper as JGripper
from pointnetgpd_tpu.inference import gpd_scorer as jgpd
from pointnetgpd_tpu.inference import scorer as jscorer
from pointnetgpd_tpu.models.gpd import init_gpd_classifier
from pointnetgpd_tpu.models.pointnet import init_pointnet_cls
from pointnetgpd_tpu.ops import crop as jcrop
from pointnetgpd_tpu.robot import node as jnode
from pointnetgpd_tpu_torch.inference import gpd_scorer as tgpd
from pointnetgpd_tpu_torch.inference import scorer as tscorer
from pointnetgpd_tpu_torch.models.convert import (pointnet_cls_from_state_dict,
                                                  state_dict_from_jax)
from pointnetgpd_tpu_torch.models.gpd import GPDClassifier
from pointnetgpd_tpu_torch.ops import crop as tcrop
from pointnetgpd_tpu_torch.robot import node as tnode


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU; torch's thread pool in each worker
    oversubscribes it (the port's tests ran 10x slower under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


class JaxDraws:
    """The JAX package's draws, for injection into the port.

    ``k_seed``: the GPG seed-selection key; ``k_crop``: the crop key (split
    into the shuffle / key stream ``k1`` and the rank stream ``k2``, as
    ``ops/crop.py`` does); ``k_score``: the scorer's resample key."""

    def __init__(self, k_seed=None, k_crop=None, k_score=None):
        self.k_seed, self.k_score = k_seed, k_score
        if k_crop is not None:
            self.k1, self.k2 = jax.random.split(k_crop)

    @classmethod
    def for_frame(cls, seed):
        """The draws of ``GraspDetector.process_frame(seed=seed)``."""
        k_gpg, _ = jax.random.split(jax.random.PRNGKey(seed))
        k_seed, _ = jax.random.split(k_gpg)
        return cls.for_scorer(seed + 1, k_seed)

    @classmethod
    def for_scorer(cls, seed, k_seed=None):
        """The draws of ``score_candidates_fused`` under PRNGKey(seed)."""
        k_crop, k_score = jax.random.split(jax.random.PRNGKey(seed))
        return cls(k_seed, k_crop, k_score)

    def seed_uniform(self, p, minval=0.0, maxval=1.0):
        if (minval, maxval) == (0.0, 1.0):
            return _t(jax.random.uniform(self.k_seed, (p,)))
        return _t(jax.random.uniform(self.k_seed, (p,), minval=minval,
                                     maxval=maxval))

    def crop_perm(self, p):
        return _t(jax.random.permutation(self.k1, p))

    @staticmethod
    def _hi(count):
        return jnp.maximum(jnp.asarray(count.cpu().numpy()), 1)[:, None]

    def crop_windows(self, count, num_out):
        k2a, k2b = jax.random.split(self.k2)
        g, hi = count.shape[0], self._hi(count)
        return (_t(jax.random.randint(k2a, (g, num_out), 0, hi)),
                _t(jax.random.randint(k2b, (g, 1), 0, hi)))

    def crop_keys(self, g, p_len):
        return _t(jax.random.uniform(jcrop._rbg_key(self.k1), (g, p_len),
                                     jnp.float32))

    def crop_ranks(self, count, num_out):
        return _t(jax.random.randint(self.k2, (count.shape[0], num_out), 0,
                                     self._hi(count)))

    def resample(self, n, num_points, p_in):
        keys = jax.random.split(self.k_score, n)
        return _t(jax.vmap(lambda k: jax.random.randint(
            k, (num_points,), 0, p_in))(keys))


def _scene(seed, n=700, offsets=((0.0, 0.0),)):
    rs = np.random.RandomState(seed)
    objs = []
    for cx, cy in offsets:
        top = rs.rand(n, 3) * [0.06, 0.06, 0] + [cx, cy, 0.08]
        front = rs.rand(n, 3) * [0.06, 0, 0.06] + [cx, cy, 0.02]
        side = rs.rand(n, 3) * [0, 0.06, 0.06] + [cx + 0.06, cy, 0.02]
        objs.append(np.concatenate([top, front, side]))
    pts = np.concatenate(objs).astype(np.float32)
    pts[:, :2] -= 0.03
    return pts


def _candidates(pc, g, seed):
    """(G, 5, 3) frames near the cloud with random unit axes."""
    rs = np.random.RandomState(seed)
    c = np.zeros((g, 5, 3), np.float32)
    c[:, 0] = pc[rs.choice(len(pc), g)] - [0.03, 0, 0]
    q = rs.randn(g, 3, 3)
    u, _, vt = np.linalg.svd(q)
    rot = (u @ vt).astype(np.float32)
    c[:, 1:4] = rot
    c[:, 4] = c[:, 0]
    return c


# ------------------------------------------------------------------- crop

@pytest.mark.parametrize("recenter", [False, True])
@pytest.mark.parametrize("branch,g,reps", [("prefix", 40, 2),
                                           ("two_stage", 8, 2),
                                           ("direct", 12, 1)])
def test_collect_candidate_clouds_matches_jax(branch, g, reps, recenter):
    pc = _scene(0, offsets=((0.0, 0.0), (0.1, 0.05))[:reps])
    assert (len(pc) > 4096) == (branch != "direct")
    cand = _candidates(pc, g, 1)
    key = jax.random.PRNGKey(5)
    hd, w = np.float32(0.06), np.float32(0.08)
    p_j, c_j, v_j = jcrop.collect_candidate_clouds(
        cand[:, 0], cand[:, 1], cand[:, 2], cand[:, 3], pc, hd, w, key,
        num_out=128, min_point_limit=10, recenter=recenter)
    p_t, c_t, v_t = tcrop.collect_candidate_clouds(
        *[_t(cand[:, i]) for i in range(4)], _t(pc), float(hd), float(w),
        JaxDraws(k_crop=key), num_out=128, min_point_limit=10,
        recenter=recenter)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-5)
    counts = np.asarray(c_j)
    assert counts.max() > 128 and (counts[counts > 0] < 128).any()
    if recenter:
        # the recenter pre-pass streamed in chunks of 7 candidates (the
        # last one padded): the same bits as one pass over all of them
        chunk = 7 * tcrop._RECENTER_BYTES_PER_PAIR * len(pc)
        old = tcrop.RECENTER_BYTES
        tcrop.RECENTER_BYTES = chunk
        try:
            p_c, c_c, v_c = tcrop.collect_candidate_clouds(
                *[_t(cand[:, i]) for i in range(4)], _t(pc), float(hd),
                float(w), JaxDraws(k_crop=key), num_out=128,
                min_point_limit=10, recenter=True)
        finally:
            tcrop.RECENTER_BYTES = old
        assert g > 7 and g % 7
        for a, b in ((p_c, p_t), (c_c, c_t), (v_c, v_t)):
            assert torch.equal(a, b)


def test_crop_empty_cloud():
    z = torch.zeros((3, 3))
    p, c, v = tcrop.collect_candidate_clouds(
        z, z, z, z, torch.zeros((0, 3)), 0.06, 0.08, None, num_out=16)
    assert p.shape == (3, 16, 3) and not v.any() and (c == 0).all()


# ----------------------------------------------------------------- scorer

def _models(seed, k=3, favor_best=True):
    params, state = jax.device_get(init_pointnet_cls(
        jax.random.PRNGKey(seed), input_chann=3, k=k))
    if favor_best:
        # lean toward the best class, so "good" candidates exist and the
        # ranking has something to order
        params["fc3"]["b"] = params["fc3"]["b"] + np.eye(k, dtype=np.float32)[-1]
    model = pointnet_cls_from_state_dict(state_dict_from_jax(params, state),
                                         device="cpu")
    return params, state, model


@pytest.mark.parametrize("recenter", [False, True])
def test_score_candidates_fused_matches_jax(recenter):
    pc = _scene(2)
    cand = _candidates(pc, 32, 3)
    params, state, model = _models(0)
    valid_in = np.ones(32, bool)
    valid_in[-3:] = False                           # padding rows
    out_j = jscorer.score_candidates_fused(
        params, state, jnp.asarray(pc), jnp.asarray(cand),
        jnp.asarray(valid_in), jnp.float32(0.06), jnp.float32(0.08),
        jax.random.PRNGKey(9), num_points=128, repeat=2, min_points=10,
        crop_recenter=recenter)
    out_t = tscorer.score_candidates_fused(
        model, _t(pc), _t(cand), _t(valid_in), 0.06, 0.08,
        JaxDraws.for_scorer(9), num_points=128, repeat=2, min_points=10,
        crop_recenter=recenter)
    pred_j, prob_j, cnt_j, val_j, good_j, order_j = map(np.asarray, out_j)
    pred_t, prob_t, cnt_t, val_t, good_t, order_t = (
        o.numpy() for o in out_t)
    np.testing.assert_array_equal(cnt_t, cnt_j)
    np.testing.assert_array_equal(val_t, val_j)
    np.testing.assert_array_equal(pred_t, pred_j)
    np.testing.assert_array_equal(good_t, good_j)
    np.testing.assert_allclose(prob_t, prob_j, atol=1e-4)
    n_good = int(good_j.sum())
    assert n_good > 1
    np.testing.assert_array_equal(order_t[:n_good], order_j[:n_good])


def _gpd_models(seed, chann=3, favor_good=False):
    """The JAX package's GPD classifier and the port's with its weights."""
    params = jax.device_get(init_gpd_classifier(jax.random.PRNGKey(seed),
                                                chann))
    if favor_good:
        params["fc2"]["b"] = params["fc2"]["b"] + np.array([0.0, 0.05],
                                                           np.float32)
    model = GPDClassifier(chann)
    model.load_state_dict(state_dict_from_jax(params, {}))
    return params, model


@pytest.mark.parametrize("g", [0, 5, 16, 17])
@pytest.mark.parametrize("kind", ["pointnet", "gpd"])
def test_scorer_padding_and_empty(kind, g):
    """Both scorers through ``dispatch_candidates``/``collect`` at
    pad_to=16 (g below, at and one past the multiple) against the JAX
    package's scorer of that kind under the same draws, the last candidate
    masked by ``valid``; the caller's extras come back with the result, also
    for 0 candidates. The scene's 4,200 points are past the top-k crop's
    4,096, so 17 candidates, padded to 32, take the prefix crop."""
    pc = _scene(4, n=1400)
    cand = _candidates(pc, 17, 5)[:g]
    valid = np.arange(g) < g - 1
    if kind == "pointnet":
        params, state, model = _models(1)
        k, draws = 3, JaxDraws.for_scorer(4)
        js = jscorer.GraspScorer(params=params, state=state, k=k,
                                 num_points=96, pad_to=16, min_points=5)
        ts = tscorer.GraspScorer(model=model, k=k, num_points=96, pad_to=16,
                                 min_points=5, device="cpu")
    else:
        params, model = _gpd_models(2, favor_good=True)
        k, draws = 2, JaxDraws(k_crop=jax.random.PRNGKey(4))
        js = jgpd.GPDScorer(params, num_points=64, pad_to=16, min_points=5)
        ts = tgpd.GPDScorer(model, num_points=64, pad_to=16, min_points=5,
                            device="cpu")
    a = js.score_candidates(pc, cand, 0.06, 0.08, seed=4, valid=valid)
    b, extras = ts.score_candidates(pc, cand, 0.06, 0.08, valid=valid,
                                    extra_fetch=(torch.ones(2),), draws=draws)
    np.testing.assert_array_equal(extras[0], np.ones(2, np.float32))
    assert b["pred"].shape == b["score"].shape == (g,)
    assert b["prob"].shape == (g, k)
    for name in ("pred", "counts", "valid", "good_indices"):
        np.testing.assert_array_equal(b[name], np.asarray(a[name]), name)
    np.testing.assert_allclose(b["score"], np.asarray(a["score"]), atol=1e-4)
    if g:
        assert not b["valid"][-1]


# --------------------------------------------------------- the whole frame

@pytest.mark.parametrize("preset", ["reference_parity", "production"])
def test_process_frame_matches_jax_detector(preset):
    pts = _scene(0)
    params, state, model = _models(0)
    kw = dict(num_grasps=20, max_num_samples=64, input_points_num=256,
              repeat=1, minimal_points_send_to_point_net=10,
              cloud_pad_to=512)
    if preset == "production":
        kw["normal_window"] = 256        # the seed-window normals path runs
    cfg_j = getattr(jnode.DetectorConfig, preset)(**kw)
    cfg_t = getattr(tnode.DetectorConfig, preset)(**kw)
    det_j = jnode.GraspDetector(
        jscorer.GraspScorer(params=params, state=state, k=3, num_points=256,
                            pad_to=32), JGripper(), cfg_j)
    det_t = tnode.GraspDetector(
        tscorer.GraspScorer(model=model, k=3, num_points=256, pad_to=32,
                            device="cpu"), config=cfg_t)
    cam = np.array([0.5, 0.5, 1.0], np.float32)
    a = det_j.process_frame(pts, cam, seed=0, funnel=True)
    b = det_t.process_frame(pts, cam, seed=0, funnel=True,
                            draws=JaxDraws.for_frame(0))
    assert b["n_valid"] == a["n_valid"] > 0
    np.testing.assert_allclose(b["all_frames"], np.asarray(a["all_frames"]),
                               atol=1e-5)
    np.testing.assert_array_equal(b["pred"], np.asarray(a["pred"]))
    np.testing.assert_array_equal(b["counts"], np.asarray(a["counts"]))
    np.testing.assert_allclose(b["all_scores"], np.asarray(a["all_scores"]),
                               atol=1e-4)
    assert len(b["scores"]) == len(a["scores"]) > 1
    np.testing.assert_allclose(b["grasps"], np.asarray(a["grasps"]),
                               atol=1e-5)
    np.testing.assert_allclose(b["scores"], np.asarray(a["scores"]),
                               atol=1e-4)
    assert (np.diff(b["scores"]) <= 0).all()
    np.testing.assert_array_equal(b["points"].numpy(),
                                  np.asarray(a["points"]))
    for name, v in a["funnel"].items():
        np.testing.assert_array_equal(b["funnel"][name], np.asarray(v), name)


def test_adaptive_bucket_overflow_redo_and_stream():
    """An adaptive bucket sized from a small previous frame overflows on a
    larger one; the frame is redone at the raw-count bucket and equals a
    detector without adaptive buckets. ``process_frames`` (one frame in
    flight) gives the same frames as serial ``process_frame`` calls."""
    _, _, model = _models(2)
    kw = dict(num_grasps=12, max_num_samples=24, input_points_num=128,
              minimal_points_send_to_point_net=5, cloud_pad_to=256,
              normal_window=128)

    def detector(**over):
        cfg = tnode.DetectorConfig.production(**{**kw, **over})
        return tnode.GraspDetector(tscorer.GraspScorer(
            model=model, k=3, num_points=128, pad_to=16, device="cpu"),
            config=cfg)

    small, big = _scene(1, n=150), _scene(2, n=400)
    cam = np.array([0.5, 0.5, 1.0], np.float32)
    adaptive = detector()
    adaptive.process_frame(small, cam, seed=0)
    assert adaptive._last_voxel_count * 1.25 < 3 * 400  # bucket will overflow
    got = adaptive.process_frame(big, cam, seed=1)
    want = detector(adaptive_bucket=False).process_frame(big, cam, seed=1)
    assert got["n_valid"] == want["n_valid"]
    np.testing.assert_array_equal(got["all_frames"], want["all_frames"])
    np.testing.assert_array_equal(got["all_scores"], want["all_scores"])

    serial = detector(adaptive_bucket=False)
    streamed = list(serial.process_frames([small, big], cam, start_seed=5))
    for i, pts in enumerate([small, big]):
        one = serial.process_frame(pts, cam, seed=5 + i)
        np.testing.assert_array_equal(streamed[i]["all_frames"],
                                      one["all_frames"])
        np.testing.assert_array_equal(streamed[i]["pred"], one["pred"])


def _bucket_detector(adaptive, n_voxel=500, raw_pad_to=None):
    """The detector of the JAX package's adaptive-bucket tests
    (tests/test_robot.py ``_make_det``)."""
    _, _, model = _models(0, favor_best=False)
    return tnode.GraspDetector(
        tscorer.GraspScorer(model=model, k=3, num_points=128, pad_to=16,
                            min_points=5, device="cpu"),
        config=tnode.DetectorConfig(
            num_grasps=12, max_num_samples=32, input_points_num=128,
            repeat=1, minimal_points_send_to_point_net=5, cloud_pad_to=512,
            adaptive_bucket=adaptive, adaptive_margin=1.25, n_voxel=n_voxel,
            raw_pad_to=raw_pad_to))


def test_adaptive_bucket_shrinks_and_matches_when_bucket_equal():
    """A dense scene (4,200 raw points on a coarse voxel grid) runs a
    smaller bucket after its first frame, with finite scores; a fresh
    detector over the same stream reproduces it bit for bit."""
    pts = _scene(5, n=1400)
    cam = np.array([0.5, 0.5, 1.0], np.float32)
    det = _bucket_detector(True, n_voxel=40)
    d1 = det.dispatch_frame(pts, cam, seed=0)
    det.collect_frame(d1)
    assert det._last_voxel_count is not None
    d2 = det.dispatch_frame(pts, cam, seed=1)
    out2 = det.collect_frame(d2)
    assert d2[2] < d1[2]                       # the bucket adapted down
    assert np.isfinite(out2["all_scores"]).all()
    det_b = _bucket_detector(True, n_voxel=40)
    det_b.collect_frame(det_b.dispatch_frame(pts, cam, seed=0))
    out2b = det_b.process_frame(pts, cam, seed=1)
    np.testing.assert_array_equal(out2["all_frames"], out2b["all_frames"])
    np.testing.assert_array_equal(out2["all_scores"], out2b["all_scores"])


def test_adaptive_overflow_redo_with_coarse_raw_pad():
    """With raw buckets of 8,192 points and cloud buckets of 512, the redo
    of an overflowed adaptive bucket takes its bound from the raw count,
    not the raw-padded length, and equals adaptive_bucket=False."""
    small = _scene(7, n=200)
    big = (np.random.RandomState(7).rand(2500, 3) * 0.5 - 0.25).astype(
        np.float32)
    big[:, 2] = np.abs(big[:, 2]) + 0.02       # sparse: ~1 voxel a point
    cam = np.array([0.5, 0.5, 1.0], np.float32)
    det_a = _bucket_detector(True, raw_pad_to=8192)
    det_f = _bucket_detector(False, raw_pad_to=8192)
    det_a.process_frame(small, cam, seed=0)    # sets a small estimate
    redo = det_a.dispatch_frame(big, cam, seed=1)
    assert redo[2] < 2560                      # the adapted bucket overflows
    out_a = det_a.collect_frame(redo)
    bound = det_f.dispatch_frame(big, cam, seed=1)
    assert bound[2] == 2560                    # 2,500 raw points, not 8,192
    out_f = det_f.collect_frame(bound)
    assert out_a["n_valid"] == out_f["n_valid"]
    np.testing.assert_array_equal(out_a["all_frames"], out_f["all_frames"])
    np.testing.assert_array_equal(out_a["all_scores"], out_f["all_scores"])
