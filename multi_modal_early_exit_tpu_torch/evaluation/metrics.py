"""Predictive + calibration + failure-detection metrics.

Self-contained numpy implementations with the same ``metric(y_true, p_hat)``
API as the reference suite (EE/metrics.py:29-498). The reference's ECE
delegates to the ``jordyvl/ece`` HF-hub metric with equal-mass binning
(EE/metrics.py:479-498); that hub metric is reimplemented here locally
(equal-mass bins, upper-edge proxy, p=1) so no network is needed.

AURC / risk-coverage follows fd-shifts exactly (EE/metrics.py:324-452), and
the unit tests reproduce the reference's literature cases
(EE/metrics.py:501-554).

The port's copy of the JAX package's ``evaluation/metrics.py``, free of
scikit-learn (the card's machine has none): the scores the JAX module takes
from ``sklearn.metrics`` are reimplemented below in numpy with
scikit-learn's conventions (``accuracy_score``, ``f1_score``, ``log_loss``,
``roc_curve``, ``auc``, ``roc_auc_score``, ``average_precision_score``), and
tests/test_torch_evaluation.py holds them to scikit-learn's numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Tuple

import numpy as np
import scipy.special


# --------------------------------------------------------------------------
# scikit-learn's scores, in numpy
# --------------------------------------------------------------------------

def accuracy_score(y_true, y_pred) -> float:
    """The share of equal labels (``sklearn.metrics.accuracy_score``)."""
    return float(np.average(np.asarray(y_true) == np.asarray(y_pred)))


def f1_score(y_true, y_pred, average: str = "macro") -> float:
    """F1 over the labels present in either array, sorted
    (``sklearn.metrics.f1_score`` with ``average`` "micro" or "macro"):
    2 tp / (true + predicted) per label, or over the label sums for micro;
    a label with neither scores 0."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.union1d(y_true, y_pred)
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in labels])
    true_sum = np.array([np.sum(y_true == c) for c in labels])
    pred_sum = np.array([np.sum(y_pred == c) for c in labels])
    if average == "micro":
        tp, true_sum, pred_sum = (np.reshape(np.sum(x), (1,)) for x in (tp, true_sum, pred_sum))
    elif average != "macro":
        raise ValueError(f"average must be 'micro' or 'macro', not {average!r}")
    denom = (1.0 * true_sum + pred_sum).astype(np.float64)
    zero = denom == 0
    denom[zero] = 1
    f = (2.0 * tp.astype(np.float64)) / denom
    f[zero] = 0.0
    return float(np.nanmean(f))


def log_loss(y_true, y_prob, labels) -> float:
    """Mean negative log-likelihood of ``y_true`` under the (N, K)
    probabilities ``y_prob``, whose columns are the sorted ``labels``
    (``sklearn.metrics.log_loss``): probabilities clipped to [eps, 1 - eps]
    of their dtype, then -sum(onehot log p) per row, averaged."""
    y_prob = np.asarray(y_prob)
    if not np.issubdtype(y_prob.dtype, np.floating):
        y_prob = y_prob.astype(np.float64)
    labels = np.asarray(labels)
    y_true = np.asarray(y_true)
    if y_prob.ndim == 1:
        y_prob = y_prob[:, None]
    if y_prob.shape[1] == 1:
        y_prob = np.concatenate([1 - y_prob, y_prob], axis=1)
    classes = np.unique(labels)
    if len(classes) < 2 or len(classes) != y_prob.shape[1]:
        raise ValueError(f"labels {labels} do not match the {y_prob.shape[1]} columns of y_prob")
    if not np.all(np.isin(y_true, classes)):
        raise ValueError(f"y_true contains values not in labels {labels}")
    onehot = (y_true[:, None] == classes[None, :]).astype(y_prob.dtype)
    eps = np.finfo(y_prob.dtype).eps
    y_prob = np.clip(y_prob, eps, 1 - eps)
    # x log y as scikit-learn takes it (numpy's log, not scipy's xlogy: the
    # two differ in the last bit, and the temperature fit follows them)
    xlogy = np.where(onehot == 0.0, 0.0, onehot * np.log(y_prob))
    return float(np.average(-np.sum(xlogy, axis=1)))


def _binary_clf_curve(y_true, y_score):
    """(fps, tps, thresholds) at each distinct score, descending, for the
    positive label 1 (scikit-learn's ``confusion_matrix_at_thresholds``)."""
    y_true = np.asarray(y_true).ravel()
    y_score = np.asarray(y_score).ravel()
    if not (np.all(np.isfinite(y_score)) and np.all(np.isin(y_true, (0, 1)))):
        raise ValueError("binary 0/1 labels and finite scores are required")
    order = np.argsort(-y_score, kind="stable")
    y_score = y_score[order]
    y_true = (y_true[order] == 1).astype(np.float64)
    distinct = np.nonzero(np.diff(y_score))[0]
    idx = np.concatenate([distinct, [y_true.size - 1]])
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, y_score[idx]


def roc_curve(y_true, y_score, drop_intermediate: bool = True):
    """(fpr, tpr, thresholds) (``sklearn.metrics.roc_curve``): ties share
    one point; with ``drop_intermediate`` the points where neither fps nor
    tps bends are dropped; (0, 0) at threshold inf first."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)
    if drop_intermediate and fps.shape[0] > 2:
        keep = np.where(np.concatenate(
            [[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]]))[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[np.inf], thresholds.astype(np.float64)])
    fpr = np.full(fps.shape, np.nan) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.full(tps.shape, np.nan) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thresholds


def auc(x, y) -> float:
    """Trapezoidal area under y(x), x monotone (``sklearn.metrics.auc``)."""
    x, y = np.asarray(x).ravel(), np.asarray(y).ravel()
    if x.shape[0] < 2:
        raise ValueError("at least 2 points are needed to compute an area under a curve")
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1
        else:
            raise ValueError(f"x is neither increasing nor decreasing: {x}")
    return float(direction * np.trapezoid(y, x))


def roc_auc_score(y_true, y_score) -> float:
    """Binary AUROC (``sklearn.metrics.roc_auc_score``); nan with one class."""
    if len(np.unique(y_true)) != 2:
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return auc(fpr, tpr)


def average_precision_score(y_true, y_score) -> float:
    """Binary average precision, the step-wise sum over recall of the
    precision-recall curve (``sklearn.metrics.average_precision_score``)."""
    fps, tps, _ = _binary_clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.where(ps != 0, np.divide(tps, np.where(ps != 0, ps, 1)), 0.0)
    recall = np.full(tps.shape, 1.0) if tps[-1] == 0 else tps / tps[-1]
    precision = np.concatenate([precision[::-1], [1.0]])
    recall = np.concatenate([recall[::-1], [0.0]])
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def _softmax_if_logits(p_hat: np.ndarray) -> np.ndarray:
    p_hat = np.asarray(p_hat)
    if not np.isclose(np.sum(p_hat), len(p_hat)):
        p_hat = scipy.special.softmax(p_hat, axis=-1)
    return p_hat


# --------------------------------------------------------------------------
# basic predictive metrics
# --------------------------------------------------------------------------

def accuracy(y_true, p_hat):
    y_pred = np.argmax(p_hat, axis=-1)
    return accuracy_score(y_true=y_true, y_pred=y_pred)


def error(y_true, p_hat):
    return 1.0 - accuracy(y_true, p_hat)


def f1_micro(y_true, p_hat, y_hat=None):
    if y_hat is None:
        y_hat = np.argmax(p_hat, axis=-1)
    return f1_score(y_true, y_hat, average="micro")


def f1_macro(y_true, p_hat, y_hat=None):
    if y_hat is None:
        y_hat = np.argmax(p_hat, axis=-1)
    return f1_score(y_true, y_hat, average="macro")


def nll(y_true, p_hat):
    """Multi-class negative log likelihood (``log_loss``)."""
    p_hat = _softmax_if_logits(np.asarray(p_hat, dtype=np.float64))
    labels = np.arange(p_hat.shape[-1])
    return log_loss(y_true, p_hat, labels=labels)


def brier_loss(y_true, p_hat):
    """Multi-class Brier score: mean squared distance to the one-hot target."""
    y_true = np.asarray(y_true)
    p_hat = np.asarray(p_hat, dtype=np.float64)
    n, k = len(y_true), p_hat.shape[-1]
    onehot = np.zeros((n, k))
    onehot[np.arange(n), y_true] = 1.0
    p_hat = _softmax_if_logits(p_hat)
    return float(np.mean(np.sum((p_hat - onehot) ** 2, axis=1)))


# --------------------------------------------------------------------------
# confidence statistics
# --------------------------------------------------------------------------

def average_confidence(y, p_hat):
    return float(np.mean(np.max(p_hat, axis=1)))


def overconfidence(y, p_hat):
    y_pred = np.argmax(p_hat, axis=1)
    p_max = np.max(p_hat, axis=1)
    return float(np.average(p_max[y_pred != np.asarray(y)]))


def underconfidence(y, p_hat):
    y_pred = np.argmax(p_hat, axis=1)
    p_max = np.max(p_hat, axis=1)
    return float(np.average(1 - p_max[y_pred == np.asarray(y)]))


def ratio_over_underconfidence(y, p_hat):
    return overconfidence(y, p_hat) / underconfidence(y, p_hat)


def sharpness(y, p_hat, ddof=1):
    n_classes = np.shape(p_hat)[-1]
    p_max = np.max(p_hat, axis=1)
    return float(np.var(p_max, ddof=ddof) * 4 * n_classes**2 / (n_classes - 1) ** 2)


# --------------------------------------------------------------------------
# expected calibration error, equal-mass binning
# --------------------------------------------------------------------------

def ece_logits(
    references,
    predictions,
    n_bins: int | None = None,
    scheme: str = "equal-mass",
    proxy: str = "upper-edge",
    p: int = 1,
) -> float:
    """ECE with equal-mass (quantile) binning.

    Local reimplementation of the ``jordyvl/ece`` hub metric invocation in the
    reference (EE/metrics.py:483-498): n_bins = min(N-1, 100), equal-mass
    bins, per-bin confidence proxied by the bin's upper edge, L1 (p=1)
    aggregation weighted by bin mass.

    Binning convention (load-bearing for equal-mass, where edges ARE data
    values so edge ties are the norm): scipy ``binned_statistic`` semantics —
    bins are left-closed ``[e_b, e_{b+1})`` with the LAST bin right-closed;
    equal-mass edges are confidence quantiles via
    ``np.interp(linspace(0, N, B+1), arange(N), sort(conf))``. The hub metric
    computes its binned statistics through scipy; ``tests/test_metrics.py``
    pins this function to a direct ``scipy.stats.binned_statistic`` oracle at
    1e-12 plus hand-computed golden cases (offline — the hub module itself
    is not fetchable in this environment; PARITY.md records the caveat).
    """
    references = np.asarray(references)
    probs = _softmax_if_logits(np.asarray(predictions, dtype=np.float64))
    conf = np.max(probs, axis=-1)
    pred = np.argmax(probs, axis=-1)
    correct = (pred == references).astype(np.float64)
    n = len(conf)
    if n_bins is None:
        n_bins = min(n - 1, 100)
    n_bins = max(n_bins, 1)

    if scheme == "equal-mass":
        # quantile edges over sorted confidences
        edges = np.interp(
            np.linspace(0, n, n_bins + 1), np.arange(0, n), np.sort(conf)
        )
    else:  # equal-range
        edges = np.linspace(0.0, 1.0, n_bins + 1)

    # digitize convention: a value equal to an interior edge lands in the
    # RIGHT (higher) bin; values at/above the last edge land in the last bin
    idx = np.searchsorted(edges[1:-1], conf, side="right")
    ece = 0.0
    for b in range(n_bins):
        mask = idx == b
        nb = int(mask.sum())
        if nb == 0:
            continue
        acc_b = float(correct[mask].mean())
        if proxy == "upper-edge":
            conf_b = float(edges[b + 1])
        else:  # mean confidence proxy
            conf_b = float(conf[mask].mean())
        ece += (nb / n) * abs(acc_b - conf_b) ** p
    return float(ece ** (1.0 / p))


# --------------------------------------------------------------------------
# risk-coverage / AURC (fd-shifts), AUROC_f
# --------------------------------------------------------------------------

AURC_DISPLAY_SCALE = 1


@dataclass
class StatsCache:
    """Confidence/correctness cache shared across failure-detection metrics
    (parity: EE/metrics.py:324-378)."""

    confids: np.ndarray
    correct: np.ndarray

    @cached_property
    def roc_curve_stats(self) -> Tuple[np.ndarray, np.ndarray]:
        fpr, tpr, _ = roc_curve(self.correct, self.confids)
        return fpr, tpr

    @property
    def residuals(self) -> np.ndarray:
        return 1 - self.correct

    @cached_property
    def rc_curve_stats(self) -> Tuple[list, list, list]:
        """Risk-coverage curve: vectorized form of the algorithm the
        reference takes from the fd-shifts library (Jaeger et al., "A Call
        to Reflect on Evaluation Practices for Failure Detection";
        EE/metrics.py:378-399 credits github.com/IML-DKFZ/fd-shifts).

        Semantics: walk samples in ascending-confidence order, dropping one
        at a time; emit a (coverage, selective_risk) point whenever the
        confidence strictly increases (ties collapse into the next point's
        trapezoid weight); a trailing tie block contributes a final
        zero-coverage point at the last emitted risk.  Output lists are
        element-identical to the sequential loop for 0/1 residuals
        (integer-valued float arithmetic is exact either way); the loop
        survives as ``rc_curve_stats_reference`` for the cross-check test.
        """
        n = len(self.residuals)
        idx_sorted = np.argsort(self.confids)
        sorted_conf = self.confids[idx_sorted]
        sorted_res = np.asarray(self.residuals, dtype=np.float64)[idx_sorted]

        total = float(np.sum(sorted_res))
        if n == 1:
            return [1.0], [total / n], []

        cum = np.cumsum(sorted_res)  # cum[i] = residual mass of dropped 0..i
        steps = np.arange(n - 1)
        remaining = n - 1 - steps
        risks_all = (total - cum[: n - 1]) / remaining
        coverages_all = remaining / n

        emit = np.empty(n - 1, dtype=bool)
        emit[0] = True
        emit[1:] = sorted_conf[1 : n - 1] != sorted_conf[: n - 2]
        e_idx = np.flatnonzero(emit)
        point_weights = np.diff(np.concatenate(([-1], e_idx)))

        coverages = [1.0] + list(coverages_all[e_idx])
        risks = [total / n] + list(risks_all[e_idx])
        weights = list(point_weights / n)
        trailing = (n - 2) - e_idx[-1]
        if trailing > 0:
            coverages.append(0)
            risks.append(risks[-1])
            weights.append(trailing / n)
        return coverages, risks, weights


def rc_curve_stats_reference(
    confids: np.ndarray, residuals: np.ndarray
) -> Tuple[list, list, list]:
    """Sequential-loop oracle for ``StatsCache.rc_curve_stats`` (the
    fd-shifts algorithm as the reference transcribes it,
    EE/metrics.py:378-399). Test-only: pins the vectorized rewrite."""
    coverages, risks, weights = [], [], []
    n = len(residuals)
    idx_sorted = np.argsort(confids)
    coverage = n
    error_sum = float(np.sum(residuals[idx_sorted]))
    coverages.append(coverage / n)
    risks.append(error_sum / n)
    tmp_weight = 0
    for i in range(0, len(idx_sorted) - 1):
        coverage -= 1
        error_sum -= residuals[idx_sorted[i]]
        tmp_weight += 1
        if i == 0 or confids[idx_sorted[i]] != confids[idx_sorted[i - 1]]:
            coverages.append(coverage / n)
            risks.append(error_sum / (n - 1 - i))
            weights.append(tmp_weight / n)
            tmp_weight = 0
    if tmp_weight > 0:
        coverages.append(0)
        risks.append(risks[-1])
        weights.append(tmp_weight / n)
    return coverages, risks, weights


def aurc(stats_cache: StatsCache) -> float:
    """Area under the risk-coverage curve; LOWER is better."""
    _, risks, weights = stats_cache.rc_curve_stats
    return (
        sum((risks[i] + risks[i + 1]) * 0.5 * weights[i] for i in range(len(weights)))
        * AURC_DISPLAY_SCALE
    )


def failauc(stats_cache: StatsCache) -> float:
    fpr, tpr = stats_cache.roc_curve_stats
    return auc(fpr, tpr)


def aurc_logits(references, predictions, get_cache=False, use_as_is=False):
    references = np.asarray(references)
    predictions = np.asarray(predictions)
    if not use_as_is:
        if not np.isclose(np.sum(references), len(references)):
            references = (np.argmax(predictions, -1) == references).astype(int)
        if not np.isclose(np.sum(predictions), len(predictions)):
            predictions = scipy.special.softmax(predictions, axis=-1)
        if predictions.ndim == 2:
            predictions = np.max(predictions, -1)
    cache = StatsCache(confids=predictions, correct=references)
    if get_cache:
        return {"aurc": aurc(cache), "cache": cache}
    return aurc(cache)


def AUROC_logits(references, predictions):
    predictions = np.asarray(predictions)
    if not np.isclose(np.sum(predictions), len(predictions)):
        predictions = scipy.special.softmax(predictions, axis=-1)
    cache = StatsCache(confids=predictions, correct=np.asarray(references))
    return {"AUROC": failauc(cache)}


def AUROC_PR(pred_known, pred_unknown):
    neg = list(np.max(pred_known, axis=-1))
    pos = list(np.max(pred_unknown, axis=-1))
    return compute_auc_aupr(neg, pos, pos_label=0)


def compute_auc_aupr(neg, pos, pos_label=1):
    ys = np.concatenate((np.zeros(len(neg)), np.ones(len(pos))), axis=0)
    neg = np.array(neg)[~np.isnan(neg)]
    pos = np.array(pos)[~np.isnan(pos)]
    scores = np.concatenate((neg, pos), axis=0)
    auc_ = roc_auc_score(ys, scores)
    aupr = average_precision_score(ys, scores)
    if pos_label == 1:
        return auc_, aupr
    return 1 - auc_, 1 - aupr


def multi_aurc_plot(
    caches: "dict[str, StatsCache]",
    out_path: Optional[str] = None,
) -> "dict[str, float]":
    """Overlayed risk-coverage curves for several confidence sources
    (parity: EE/metrics.py:455-468 multi_aurc_plot). Returns {name: aurc};
    saves a figure when ``out_path`` is given."""
    aurcs = {name: aurc(cache) for name, cache in caches.items()}
    if out_path is not None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 5))
        for name, cache in caches.items():
            coverages, risks, _ = cache.rc_curve_stats
            ax.plot(coverages, risks, label=f"{name} (AURC={aurcs[name]:.4f})")
        ax.set_xlabel("coverage")
        ax.set_ylabel("selective risk")
        ax.legend()
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return aurcs


# --------------------------------------------------------------------------
# metric bundle (reference: EE/utils.py:226-237)
# --------------------------------------------------------------------------

METRICS = [accuracy, brier_loss, nll, f1_micro, f1_macro, ece_logits, aurc_logits]


def calc_metrics(predictions, references) -> "dict[str, float]":
    """The 7-metric predictive suite over a prediction matrix."""
    predictions = np.asarray(predictions)
    out = {}
    for metric in METRICS:
        out[metric.__name__.replace("_logits", "")] = float(
            metric(references, predictions)
        )
    return out
