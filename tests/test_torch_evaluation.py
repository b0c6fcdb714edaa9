"""PyTorch port, the anytime-evaluation modules against the JAX package's:
metrics (and the scikit-learn scores the port reimplements in numpy),
exit policies, temperature and Platt calibration, threshold sweeps (the
port's torch backend on the CPU, its native and numpy backends, JAX's numpy
backend), the FLOPs analysis of the tiny config, and the offline
evaluation's JSON files. Every input is made with numpy from a seed and
handed to both packages.
"""

import json

import numpy as np
import pytest
import scipy.special
import sklearn.linear_model
import sklearn.metrics as skm
import torch

from multi_modal_early_exit_tpu.evaluation import analysis as janalysis
from multi_modal_early_exit_tpu.evaluation import calibration as jcal
from multi_modal_early_exit_tpu.evaluation import metrics as jmetrics
from multi_modal_early_exit_tpu.evaluation import pipeline as jpipe
from multi_modal_early_exit_tpu.evaluation import policy as jpolicy
from multi_modal_early_exit_tpu.evaluation import thresholds as jthr
from multi_modal_early_exit_tpu_torch.evaluation import analysis as tanalysis
from multi_modal_early_exit_tpu_torch.evaluation import calibration as tcal
from multi_modal_early_exit_tpu_torch.evaluation import metrics as tmetrics
from multi_modal_early_exit_tpu_torch.evaluation import pipeline as tpipe
from multi_modal_early_exit_tpu_torch.evaluation import policy as tpolicy
from multi_modal_early_exit_tpu_torch.evaluation import thresholds as tthr
from multi_modal_early_exit_tpu_torch.native import sweep as tnative
from multi_modal_early_exit_tpu_torch.utils import artifacts as tart

from _torch_parity import jax_params, port_model, tiny_configs

E, N, K = 4, 256, 8  # exits (3 + the final classifier), documents, labels


def _store(seed, e=E, n=N, k=K, scale=3.0):
    """A (E, N, K) float64 logit store whose later exits are more accurate,
    and the references."""
    rng = np.random.default_rng(seed)
    refs = rng.integers(0, k, n)
    logits = rng.standard_normal((e, n, k)) * scale
    for i in range(e):
        logits[i, np.arange(n), refs] += 1.0 + i
    return logits, refs


# ---------------------------------------------------------------------------
# the scikit-learn scores, reimplemented
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_classification_scores_equal_sklearn(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 6, 300)
    p = np.where(rng.random(300) < 0.6, y, rng.integers(0, 7, 300))  # a label y lacks
    assert tmetrics.accuracy_score(y, p) == skm.accuracy_score(y, p)
    for avg in ("micro", "macro"):
        assert tmetrics.f1_score(y, p, average=avg) == skm.f1_score(y, p, average=avg)
    probs = scipy.special.softmax(rng.standard_normal((300, 6)) * 4, -1)
    probs[0] = np.eye(6)[y[0]]  # a probability of exactly 1 (clipped)
    probs[1] = np.eye(6)[(y[1] + 1) % 6]  # and of 0
    want = skm.log_loss(y, probs, labels=np.arange(6))
    assert abs(tmetrics.log_loss(y, probs, labels=np.arange(6)) - want) <= 1e-12 * abs(want)
    b = (y % 2)
    two = np.stack([1 - probs[:, 0], probs[:, 0]], 1)
    assert abs(tmetrics.log_loss(b, two, labels=[0, 1]) - skm.log_loss(b, two, labels=[0, 1])) \
        <= 1e-12


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ties", [False, True])
def test_roc_and_precision_scores_equal_sklearn(seed, ties):
    """roc_curve's arrays equal (ties share a point, collinear points
    dropped); AUROC and AUPR within 1e-12."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, 500)
    s = rng.random(500) + 0.3 * y
    if ties:
        s = np.round(s * 8) / 8  # many tied scores
    for drop in (True, False):
        for got, want in zip(tmetrics.roc_curve(y, s, drop_intermediate=drop),
                             skm.roc_curve(y, s, drop_intermediate=drop)):
            np.testing.assert_array_equal(got, want)
    fpr, tpr, _ = skm.roc_curve(y, s)
    assert abs(tmetrics.auc(fpr, tpr) - skm.auc(fpr, tpr)) <= 1e-12
    assert abs(tmetrics.auc(fpr[::-1], tpr[::-1]) - skm.auc(fpr[::-1], tpr[::-1])) <= 1e-12
    assert abs(tmetrics.roc_auc_score(y, s) - skm.roc_auc_score(y, s)) <= 1e-12
    assert abs(tmetrics.average_precision_score(y, s)
               - skm.average_precision_score(y, s)) <= 1e-12
    neg, pos = list(rng.random(40)), list(rng.random(60) + 0.2)
    for pos_label in (0, 1):
        for got, want in zip(tmetrics.compute_auc_aupr(neg, pos, pos_label),
                             jmetrics.compute_auc_aupr(neg, pos, pos_label)):
            assert abs(got - want) <= 1e-12


@pytest.mark.parametrize("seed", [0, 3])
def test_calc_metrics_equals_the_jax_package(seed):
    """Every key within 1e-12; accuracy and F1 exactly."""
    logits, refs = _store(seed)
    for e in range(E):
        got = tmetrics.calc_metrics(logits[e], refs)
        want = jmetrics.calc_metrics(logits[e], refs)
        assert got.keys() == want.keys() and len(got) == 7
        for key in ("accuracy", "f1_micro", "f1_macro"):
            assert got[key] == want[key], key
        for key in got:
            assert abs(got[key] - want[key]) <= 1e-12 * max(1.0, abs(want[key])), key
    cache_t = tmetrics.aurc_logits(refs, logits[0], get_cache=True)["cache"]
    cache_j = jmetrics.aurc_logits(refs, logits[0], get_cache=True)["cache"]
    for got, want in zip(cache_t.roc_curve_stats, cache_j.roc_curve_stats):
        np.testing.assert_array_equal(got, want)
    assert abs(tmetrics.failauc(cache_t) - jmetrics.failauc(cache_j)) <= 1e-12
    assert tmetrics.AUROC_logits(refs == logits[0].argmax(-1), logits[0].max(-1))["AUROC"] \
        == pytest.approx(jmetrics.AUROC_logits(refs == logits[0].argmax(-1),
                                               logits[0].max(-1))["AUROC"], abs=1e-12)


# ---------------------------------------------------------------------------
# policies and calibration
# ---------------------------------------------------------------------------


def _calibration_metrics(logits, refs):
    return jcal.calibrate_exit_logits(logits, refs, logits)[1]


@pytest.mark.parametrize("policy", ["max_confidence_global_thresholding_policy",
                                    "patience_policy", "accuracy_calibration_heuristic"])
@pytest.mark.parametrize("threshold", [0.3, 0.6, 0.9])
def test_policies_equal_the_jax_package(policy, threshold):
    logits, refs = _store(4)
    config = {"exit_threshold": threshold if policy != "patience_policy" else int(threshold * 4),
              "epsilon": threshold, "calibration_metrics": _calibration_metrics(logits, refs)}
    got = getattr(tpolicy.Policy(logits, config), policy)()
    want = getattr(jpolicy.Policy(logits, config), policy)()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert tpolicy.exit_distribution_of(got[0], E) == want[2]


def test_temperatures_and_the_calibrated_store_match_the_jax_package():
    """Temperatures within 1e-6 relative, the calibrated store within 1e-6
    of its scale, and the recorded calibration metrics."""
    logits, refs = _store(5, scale=6.0)  # over-confident exits: temperatures > 1
    test, _ = _store(6, scale=6.0)
    got, got_m = tcal.calibrate_exit_logits(logits, refs, test)
    want, want_m = jcal.calibrate_exit_logits(logits, refs, test)
    np.testing.assert_allclose(got_m["temperature"], want_m["temperature"], rtol=1e-6)
    assert all(t > 1.0 for t in got_m["temperature"])
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    for key in ("ece", "accuracy", "average_confidence"):
        np.testing.assert_allclose(got_m[key], want_m[key], rtol=1e-5, atol=1e-6, err_msg=key)
    t = tcal.TemperatureScaler().fit(refs, logits[1])
    assert t == pytest.approx(jcal.TemperatureScaler().fit(refs, logits[1]), rel=1e-6)
    onehot = np.eye(K)[refs]
    assert tcal.nll_of_logits(onehot, logits[1] / t) == pytest.approx(
        tmetrics.nll(refs, logits[1] / t), rel=1e-9)


def test_platt_scaler_matches_logistic_regression():
    """The unregularised logistic fit against the JAX package's
    LogisticRegression(C=1e10): scikit-learn stops at its solver tolerance
    (1e-4), so the calibrated confidences agree to 1e-4."""
    rng = np.random.default_rng(7)
    conf = np.clip(rng.beta(5, 2, 400), 1e-6, 1 - 1e-6)
    labels = (rng.random(400) < conf ** 1.5).astype(int)
    probe = np.linspace(0.01, 0.99, 50)
    got = tcal.get_platt_scaler(conf, labels)(probe)
    want = jcal.get_platt_scaler(conf, labels)(probe)
    np.testing.assert_allclose(got, want, atol=1e-4)
    # the port's optimum is at least as good as scikit-learn's
    x = np.log(conf / (1 - conf))
    clf = sklearn.linear_model.LogisticRegression(C=1e10).fit(x[:, None], labels)
    coef, intercept = tcal._logistic_fit(x, labels)

    def nll(w, b):
        z = w * x + b
        return np.sum(np.logaddexp(0, -z) * labels + np.logaddexp(0, z) * (1 - labels))

    assert nll(coef, intercept) <= nll(clf.coef_[0, 0], clf.intercept_[0]) + 1e-9


# ---------------------------------------------------------------------------
# threshold sweeps
# ---------------------------------------------------------------------------


def test_global_sweeps_agree_with_each_other_and_the_jax_package():
    logits, _ = _store(8, e=5, n=120)
    thresholds = np.round(np.arange(0.05, 1.0, 0.05), 2)
    for csf in ("msp", "entropy", "margin"):
        ref_p, ref_e = tthr.naive_global_sweep(logits, thresholds, csf)
        for fn in (tthr.vectorized_global_sweep, tthr.incremental_global_sweep):
            p, e = fn(logits, thresholds, csf)
            np.testing.assert_array_equal(e, ref_e)
            np.testing.assert_array_equal(p, ref_p)
        jp, je = jthr.vectorized_global_sweep(logits, thresholds, csf)
        np.testing.assert_array_equal(ref_e, je)
        np.testing.assert_array_equal(ref_p, jp)
    assert set(tthr.time_global_sweeps(logits, thresholds)) == {"naive", "opt0", "opt1"}


@pytest.mark.parametrize("seed", [0, 9])
def test_mixture_sweep_backends_agree(seed):
    """The port's torch (on the CPU), native and numpy backends and the JAX
    package's numpy backend give the same accuracy and average exit: sums
    of 0/1 and of exit ids over N = 256 documents, exact in f32."""
    logits, refs = _store(seed)
    kw = dict(num_mixtures=3000, num_per_exit=10, seed=seed)
    got = {b: tthr.mixture_pareto_sweep(logits, refs, backend=b, chunk=512,
                                        device="cpu" if b == "torch" else None, **kw)
           for b in ("torch", "native", "numpy")}
    want = jthr.mixture_pareto_sweep(logits, refs, backend="numpy", **kw)
    for b, res in got.items():
        np.testing.assert_array_equal(res["thresholds"], want["thresholds"])
        for key in ("accuracy", "average_exit"):
            np.testing.assert_array_equal(np.asarray(res[key], np.float64),
                                          np.asarray(want[key], np.float64), err_msg=(b, key))
    # bit-equal in f32 between the two f32 backends
    for key in ("accuracy", "average_exit"):
        assert got["torch"][key].dtype == got["native"][key].dtype == np.float32
        np.testing.assert_array_equal(got["torch"][key], got["native"][key])
    auto = tthr.mixture_pareto_sweep(logits, refs, **kw)  # no device: native
    np.testing.assert_array_equal(auto["accuracy"], got["native"]["accuracy"])


def test_mixture_sweep_backends_raise_and_never_hand_over(monkeypatch):
    logits, refs = _store(1, n=64)
    with pytest.raises(ValueError, match="unknown backend"):
        tthr.mixture_pareto_sweep(logits, refs, num_mixtures=10, backend="jax")

    def broken(*args, **kwargs):
        raise RuntimeError("the native library failed")

    monkeypatch.setattr(tnative, "mixture_sweep", broken)
    with pytest.raises(RuntimeError, match="native library failed"):
        tthr.mixture_pareto_sweep(logits, refs, num_mixtures=10)  # auto: native
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tthr.mixture_pareto_sweep(logits, refs, num_mixtures=10, backend="torch")


def test_native_sweeps_equal_the_jax_package():
    """The port's C++ sweeps against the JAX package's assignment rule
    (``assign_exits_2d``) on the same f32 scores and thresholds the kernel
    compares: accuracy and average exit equal (sums of 0/1 and exit ids
    over N = 256, exact). The global sweep sends a document no exit passes
    to the last exit."""
    logits, refs = _store(2)
    scores = tthr.csf_matrix(logits).astype(np.float32)
    correct = (logits.argmax(-1) == refs[None]).astype(np.float32)
    mixtures = tthr.random_mixtures(tthr.percentile_thresholds(logits), 500, seed=3)
    mixtures = mixtures.astype(np.float32)
    acc, avg = tnative.mixture_sweep(scores, correct, mixtures)
    exits = jthr.assign_exits_2d(scores, mixtures)
    np.testing.assert_array_equal(acc, correct[exits, np.arange(N)].mean(-1))
    np.testing.assert_array_equal(avg, exits.mean(-1).astype(np.float32))
    ts = np.linspace(0, 1, 21).astype(np.float32)
    acc, avg = tnative.global_sweep(scores, correct, ts)
    glob = np.repeat(ts[:, None], E, 1)
    glob[:, -1] = -np.inf  # the last exit always takes the rest
    exits = jthr.assign_exits_2d(scores, glob)
    np.testing.assert_array_equal(acc, correct[exits, np.arange(N)].mean(-1))
    np.testing.assert_array_equal(avg, exits.mean(-1).astype(np.float32))
    assert tnative.library_path().exists()
    assert tnative.library_path().parent.name == "_build"
    with pytest.raises(ValueError, match="mixtures"):
        tnative.mixture_sweep(scores, correct, mixtures[:, :2])


def test_native_build_failure_raises(monkeypatch, tmp_path):
    bad = tmp_path / "sweep.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SRC", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.mixture_sweep(np.zeros((2, 3)), np.zeros((2, 3)), np.zeros((1, 2)))


# ---------------------------------------------------------------------------
# FLOPs analysis and the offline evaluation's files
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = tiny_configs(exits=("text_avg", "vision_avg", 1))
    params, tree = jax_params(jcfg)
    return jcfg, tcfg, params, port_model(tcfg, tree)


def test_analysis_equals_the_jax_package(tiny):
    """Parameter counts exactly; every FLOPs and params figure within
    1e-12 relative, over exit distributions and at two sequence lengths."""
    jcfg, tcfg, params, model = tiny
    for seq in (None, 96):
        got = tanalysis.Analysis(model, tcfg, seq=seq)
        want = janalysis.Analysis(params, jcfg, seq=seq)
        assert got.total_params == want.total_params
        np.testing.assert_array_equal(got.subgraph_params, want.subgraph_params)
        np.testing.assert_allclose(got.subgraph_flops, want.subgraph_flops, rtol=1e-12)
        for dist in ({0: 0.5, 3: 0.5}, {0: 0.1, 1: 0.2, 2: 0.3, 3: 0.4}, {2: 1.0}):
            for a, w in zip(got.exit_to_params_and_flops(dist, 7),
                            want.exit_to_params_and_flops(dist, 7)):
                assert a == pytest.approx(w, rel=1e-12)
            config = {"exit_threshold": 0.5, "epsilon": 0.1}
            a = tanalysis.calc_flops(dist, got, config)
            w = janalysis.calc_flops(dist, want, config)
            assert a.keys() == w.keys()
            for key in a:
                if isinstance(w[key], float):
                    assert a[key] == pytest.approx(w[key], rel=1e-12, abs=1e-15), key
                else:
                    assert a[key] == w[key], key


def _json_close(got, want):
    assert type(got) is type(want) or isinstance(got, (int, float)), (got, want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _json_close(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _json_close(a, b)
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-12 * max(1.0, abs(want)), (got, want)
    else:
        assert got == want


def test_offline_evaluation_writes_the_jax_packages_json(tiny, tmp_path):
    """The same store through evaluate_checkpoint and full_test_iteration of
    both packages (with the FLOPs analysis of the tiny config): equal JSONs,
    floats to 1e-12."""
    jcfg, tcfg, params, model = tiny
    logits, refs = _store(10, e=4, n=96, k=4)
    config = {"checkpoint": "tiny", "test_dataset": "synthetic", "exit_policy":
              "max_confidence_global_thresholding_policy", "calibrate": False}
    out = {}
    for name, art, pipe, analysis in (
            ("port", tart, tpipe, tanalysis.Analysis(model, tcfg)),
            ("jax", None, jpipe, janalysis.Analysis(params, jcfg))):
        root = str(tmp_path / name)
        d = tart.dump_logits(logits, refs, config, name="test", root=root)
        pipe.evaluate_checkpoint(d)
        res = pipe.full_test_iteration(logits, refs, dict(config), 0.05, 0.05, analysis,
                                       root=root)
        assert len(res) == 19
        out[name] = [json.load(open(f"{d}/results.json")),
                     json.load(open(f"{d}/{config['exit_policy']}/non-calibrated-metrics.json"))]
    _json_close(out["port"], out["jax"])
