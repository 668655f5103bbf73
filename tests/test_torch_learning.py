"""The port's ``learning`` package against the JAX package's.

Nine of its modules are numpy and scipy only, and ``tensor_dataset`` is
numpy file IO: the port keeps copies (it imports nothing of the JAX
package). Each case of ``tests/test_learning.py`` runs here on both
packages, with the same ``RandomState`` seeds, and checks what the JAX test
checks; on the port it also runs the JAX package and requires the same
result exactly (the same numpy calls on the same draws). The robust
Ferrari-Canny mean of ``TestRobustQuality`` belongs to the labeling path
and is held in ``tests/test_torch_labeling.py``.
"""

import numpy as np
import pytest

import pointnetgpd_tpu.learning as jl
import pointnetgpd_tpu_torch.learning as tl

PKGS = {"jax": jl, "port": tl}
MAX_ITERS = 4000


def _assert_equal(a, b, path="."):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


@pytest.fixture(params=list(PKGS))
def run(request):
    """``run(case)``: the case on this parameter's package; on the port,
    its result must also equal the JAX package's exactly."""
    def go(case):
        got = case(PKGS[request.param])
        if request.param == "port":
            _assert_equal(got, case(jl))
        return got
    return go


def test_exports_match_jax():
    assert tl.__all__ == jl.__all__
    for name in tl.__all__:
        assert getattr(tl, name).__module__.startswith(
            "pointnetgpd_tpu_torch.learning"), name


def _best_candidate(lrn, sampler_cls, objective, candidates, best_value):
    sampler = sampler_cls(objective, candidates)
    result = sampler.discrete_maximize(
        lrn.MaxIterTerminationCondition(MAX_ITERS), snapshot_rate=1000,
        rng=np.random.RandomState(0))
    assert best_value in result.best_candidates
    assert len(result.models) >= 2  # snapshots recorded
    return [result.best_candidates, result.best_pred_means,
            result.best_pred_vars, result.iters, result.indices, result.vals]


# ---------------------------------------------------------------------------
# Bandits (learning_test.py)
# ---------------------------------------------------------------------------

def test_uniform_allocation_converges(run):
    def case(lrn):
        rng = np.random.RandomState(0)
        candidates = list(rng.rand(20) * 0.7) + [0.99]
        return _best_candidate(
            lrn, lrn.UniformAllocationMean,
            lrn.RandomBinaryObjective(np.random.RandomState(1)), candidates,
            0.99)
    run(case)


def test_thompson_sampling_converges(run):
    def case(lrn):
        rng = np.random.RandomState(2)
        candidates = list(rng.rand(20) * 0.7) + [0.99]
        return _best_candidate(
            lrn, lrn.ThompsonSampling,
            lrn.RandomBinaryObjective(np.random.RandomState(3)), candidates,
            0.99)
    run(case)


def test_gaussian_uniform_allocation_converges(run):
    def case(lrn):
        rng = np.random.RandomState(4)
        candidates = list(rng.rand(20) * 0.5) + [2.0]
        return _best_candidate(
            lrn, lrn.GaussianUniformAllocationMean,
            lrn.RandomContinuousObjective(0.1, np.random.RandomState(5)),
            candidates, 2.0)
    run(case)


def test_gaussian_model_statistics(run):
    def case(lrn):
        m = lrn.GaussianModel(2)
        vals = [1.0, 2.0, 3.0]
        for v in vals:
            m.update(0, v)
        np.testing.assert_allclose(m.means[0], 2.0)
        np.testing.assert_allclose(m.sample_vars[0], np.var(vals))
        np.testing.assert_allclose(m.variances[0], np.var(vals) / 3)
        return [m.means, m.sample_vars, m.variances]
    run(case)


# ---------------------------------------------------------------------------
# Analysis
# ---------------------------------------------------------------------------

def test_confusion_matrix(run):
    def case(lrn):
        cm = lrn.ConfusionMatrix(3)
        cm.update([0, 1, 2, 1], [0, 1, 2, 2])
        assert cm.accuracy == 0.75
        assert cm.recall(2) == 0.5
        assert cm.precision(1) == 0.5
        return [cm.accuracy, cm.recall(2), cm.precision(1)]
    run(case)


def test_classification_result(run):
    def case(lrn):
        probs = np.array([[0.9, 0.1], [0.2, 0.8], [0.6, 0.4]])
        res = lrn.ClassificationResult(probs, [0, 1, 1])
        assert res.accuracy == pytest.approx(2 / 3)
        assert res.top_k_accuracy(2) == 1.0
        return [res.accuracy, res.top_k_accuracy(1)]
    run(case)


# ---------------------------------------------------------------------------
# TensorDataset
# ---------------------------------------------------------------------------

def test_tensor_dataset_roundtrip_across_chunks(tmp_path, run):
    def case(lrn):
        config = {"image": {"shape": [4, 4], "dtype": "float32"},
                  "label": {"shape": [], "dtype": "int64"}}
        d = str(tmp_path / lrn.__name__)
        ds = lrn.TensorDataset(d, config, datapoints_per_file=3)
        rng = np.random.RandomState(0)
        data = []
        for i in range(8):
            dp = ds.datapoint_template()
            dp["image"] = rng.rand(4, 4).astype(np.float32)
            dp["label"] = np.int64(i)
            data.append(dp)
            ds.add(dp)
        ds.flush()
        assert len(ds) == 8
        ds2 = lrn.TensorDataset.open(d)
        assert len(ds2) == 8
        out = []
        for i in (0, 3, 7):
            got = ds2.datapoint(i)
            np.testing.assert_array_equal(got["image"], data[i]["image"])
            assert got["label"] == i
            out.append([got["image"], got["label"]])
        # the JAX package's reader opens the file too
        other = jl.TensorDataset.open(d).datapoint(7)
        np.testing.assert_array_equal(other["image"], data[7]["image"])
        return out
    run(case)


# ---------------------------------------------------------------------------
# Correlated bandits (discrete_adaptive_samplers.py:376-503)
# ---------------------------------------------------------------------------

def test_update_spreads_to_neighbors(run):
    def case(lrn):
        feats = np.array([[0.0], [0.1], [5.0]])
        m = lrn.CorrelatedBetaBernoulliModel(
            feats, kernel=lrn.SquaredExponentialKernel(0.5), tolerance=1e-2)
        m.update(0, 1.0)
        assert m.alphas_[0] == pytest.approx(2.0)
        assert 1.9 < m.alphas_[1] < 2.0
        assert m.alphas_[2] == pytest.approx(1.0)
        np.testing.assert_allclose(m.betas_, 1.0)
        return [m.alphas_, m.betas_]
    run(case)


def test_correlated_converges_faster_than_independent(run):
    def case(lrn):
        xs = np.linspace(0.0, 1.0, 40)
        probs = np.exp(-((xs - 0.7) ** 2) / 0.02)
        best_arm = int(np.argmax(probs))

        def one(cls, seed, **kw):
            rng = np.random.RandomState(seed)
            obj = lambda x: float(rng.rand() < probs[
                int(np.searchsorted(xs, x, "left"))])
            return cls(obj, list(xs), **kw).discrete_maximize(
                lrn.MaxIterTerminationCondition(150), rng=rng)

        hits_corr = hits_ind = 0
        found = []
        for seed in range(5):
            rc = one(lrn.CorrelatedThompsonSampling, seed,
                     kernel=lrn.SquaredExponentialKernel(0.08),
                     tolerance=1e-3)
            ri = one(lrn.ThompsonSampling, seed)
            hits_corr += abs(rc.best_candidates[0] - xs[best_arm]) < 0.1
            hits_ind += abs(ri.best_candidates[0] - xs[best_arm]) < 0.1
            found.append([rc.best_candidates, ri.best_candidates, rc.vals])
        assert hits_corr >= hits_ind
        assert hits_corr >= 4
        return found
    run(case)


def test_bayes_ucb_and_gittins_run(run):
    def case(lrn):
        rng = np.random.RandomState(0)
        xs = np.linspace(0, 1, 10)
        obj = lambda x: float(rng.rand() < x)
        out = []
        for cls in (lrn.CorrelatedBayesUCB, lrn.CorrelatedGittins):
            res = cls(obj, list(xs), tolerance=1e-3).discrete_maximize(
                lrn.MaxIterTerminationCondition(60), rng=rng)
            assert res.best_candidates[0] >= 0.5
            assert len(res.vals) == 60
            out.append([res.best_candidates, res.vals])
        return out
    run(case)


# ---------------------------------------------------------------------------
# Objectives (objectives.py:33-420)
# ---------------------------------------------------------------------------

def test_zero_one_and_identity(run):
    def case(lrn):
        assert lrn.ZeroOneObjective(0.5)(0.7) == 1
        assert lrn.ZeroOneObjective(0.5)(0.3) == 0
        assert lrn.IdentityObjective()(0.42) == pytest.approx(0.42)
        return [lrn.ZeroOneObjective(0.5)(0.7), lrn.IdentityObjective()(0.42)]
    run(case)


def _fd_gradient(obj, x, eps=1e-6):
    out = []
    for i in range(len(x)):
        dx = np.zeros(len(x))
        dx[i] = eps
        out.append((obj(x + dx) - obj(x - dx)) / (2 * eps))
    return np.array(out)


def test_least_squares_gradient_matches_fd(run):
    def case(lrn):
        rng = np.random.RandomState(0)
        a, b = rng.randn(6, 4), rng.randn(6)
        obj = lrn.LeastSquaresObjective(a, b)
        x = rng.randn(4)
        g = obj.gradient(x)
        np.testing.assert_allclose(g, _fd_gradient(obj, x), rtol=1e-4)
        np.testing.assert_allclose(obj.hessian(x), a.T @ a)
        x_star = np.linalg.lstsq(a, b, rcond=None)[0]
        np.testing.assert_allclose(obj.gradient(x_star), 0, atol=1e-9)
        return [obj(x), g, obj.hessian(x)]
    run(case)


def test_logistic_gradient_matches_fd(run):
    def case(lrn):
        rng = np.random.RandomState(1)
        x_mat = rng.randn(20, 3)
        y = (rng.rand(20) < 0.5).astype(float)
        obj = lrn.LogisticCrossEntropyObjective(x_mat, y)
        beta = rng.randn(3) * 0.3
        g = obj.gradient(beta)
        np.testing.assert_allclose(g, _fd_gradient(obj, beta), rtol=1e-4,
                                   atol=1e-6)
        h = obj.hessian(beta)
        np.testing.assert_allclose(h, h.T, atol=1e-12)
        assert np.all(np.linalg.eigvalsh(h) > -1e-10)
        return [obj(beta), g, h]
    run(case)


def test_losses_and_ccbp_likelihood(run):
    def case(lrn):
        p = np.array([0.2, 0.8, 0.5])
        ce = lrn.CrossEntropyLoss(p)
        assert ce(p) < ce(p[::-1].copy())
        assert lrn.SquaredErrorLoss(p)(p) == 0.0
        w = lrn.WeightedSquaredErrorLoss(p)
        assert w(p + 0.1, np.ones(3)) == pytest.approx(0.01)
        ll = lrn.CCBPLogLikelihood(p)
        tight = ll(p * 50, (1 - p) * 50)
        loose = ll(np.ones(3), np.ones(3))
        assert tight > loose
        assert lrn.MaximizationObjective(lrn.SquaredErrorLoss(p))(p) == 0.0
        with pytest.raises(ValueError):
            lrn.SquaredErrorLoss(p)(np.zeros(2))
        return [ce(p), w(p + 0.1, np.ones(3)), tight, loose]
    run(case)


# ---------------------------------------------------------------------------
# Termination, solvers, UCB
# ---------------------------------------------------------------------------

def test_confidence_termination(run):
    def case(lrn):
        m = lrn.BetaBernoulliModel(3)
        cond = lrn.ConfidenceTerminationCondition(1e-3)
        first = cond(0, model=m)
        assert not first
        for _ in range(3000):
            m.update(1, 1.0)
        assert cond(0, model=m)
        return [first, m.alphas_, m.betas_]
    run(case)


def test_optimization_solver_feasibility(run):
    def case(lrn):
        obj = lrn.LeastSquaresObjective(np.eye(2), np.zeros(2))
        g = lambda x: np.asarray([x[0] - 1.0])
        h = lambda x: np.asarray([x[0] + x[1]])
        s = lrn.OptimizationSolver(obj, [g], [h])
        got = [s.is_feasible(np.array([0.5, -0.5])),
               s.is_feasible(np.array([2.0, -2.0])),
               s.is_feasible(np.array([0.5, 0.5])),
               s.is_feasible(np.zeros(3))]
        assert got == [True, False, False, False]
        return got
    run(case)


def test_gaussian_ucb_policy(run):
    def case(lrn):
        rng = np.random.RandomState(0)
        xs = np.linspace(0, 1, 8)
        obj = lambda x: float(x) + 0.05 * rng.randn()
        bandit = lrn.GaussianBandit(obj, list(xs), lrn.GaussianUCBPolicy())
        for i, x in enumerate(xs):
            bandit.model_.update(i, obj(x))
            bandit.model_.update(i, obj(x))
        res = bandit.discrete_maximize(lrn.MaxIterTerminationCondition(80),
                                       rng=rng)
        assert res.best_candidates[0] >= 0.7
        return [res.best_candidates, res.vals]
    run(case)


# ---------------------------------------------------------------------------
# Gittins indices (learning/gittins.py)
# ---------------------------------------------------------------------------

def test_gittins_published_value_gamma09(run):
    def case(lrn):
        v = float(lrn.gittins_index([1], [1], gamma=0.9)[0])
        assert v == pytest.approx(0.7029, abs=2e-3)
        return v
    run(case)


def test_gittins_properties(run):
    def case(lrn):
        a = np.arange(1, 40)
        inc = lrn.gittins_index(a, np.full_like(a, 5))
        dec = lrn.gittins_index(np.full_like(a, 5), a)
        assert np.all(np.diff(inc) > -1e-9)
        assert np.all(np.diff(dec) < 1e-9)
        assert np.all(inc >= a / (a + 5.0) - 1e-9)
        v0 = float(lrn.gittins_index([3], [7], gamma=1e-4)[0])
        assert v0 == pytest.approx(0.3, abs=2e-3)
        big = float(lrn.gittins_index([300], [700])[0])
        assert big == pytest.approx(0.3)
        return [inc, dec, v0, big, lrn.gittins_index_table(0.9, max_pulls=6, horizon=50,
                                                 grid=64)]
    run(case)


def test_gittins_bandit_converges(run):
    def case(lrn):
        rng = np.random.RandomState(0)
        probs = [0.2, 0.85, 0.4, 0.5]
        obj = lambda x: float(rng.rand() < x)
        res = lrn.GittinsIndex98(obj, probs).discrete_maximize(
            lrn.MaxIterTerminationCondition(150), rng=rng)
        assert res.best_candidates[0] == 0.85
        return [res.best_candidates, res.vals]
    run(case)


def test_gittins_fractional_posteriors_interpolate(run):
    def case(lrn):
        lo = float(lrn.gittins_index([2], [3])[0])
        hi = float(lrn.gittins_index([3], [3])[0])
        mid = float(lrn.gittins_index([2.5], [3])[0])
        assert lo <= mid <= hi
        return [lo, mid, hi]
    run(case)
