"""Vectorized threshold research: global sweeps and per-exit mixture search.

Capability parity with EE/thresh.py + EE/large_scale.py:

- CSF zoo (msp / negative entropy / top-1−2 margin), thresh.py:55-61
- global-threshold sweep:   naive O(T·N·E) python scan (kept for
  cross-checking, thresh.py:69-95) vs the vectorized
  ``(CSF >= t).argmax(0)`` form (opt0, thresh.py:106-131)
- per-exit 2D threshold mixtures: percentile threshold grids + random
  mixtures (thresh.py:245-262) evaluated at scale.

Where the reference shards the mixture loop over joblib / multiprocessing
×8 (thresh.py:218-225, large_scale.py:206-215), the port's copy of the JAX
package's module sweeps the mixtures in chunks of (C, E, N) on a torch
device (the card: the (E, N) CSF matrix is tiny, so a million mixtures are
a few batched comparisons and reductions per chunk), or with the C++/OpenMP
kernel of ``native/`` on the host, or in numpy. Each backend either runs
or raises: none hands over to another.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Tuple

import numpy as np
import scipy.special
import torch


def entropy_np(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    exp_x = np.exp(x)
    a = np.sum(exp_x, axis=-1)
    b = np.sum(x * exp_x, axis=-1)
    return np.log(a) - b / a


def top12_margin_np(x: np.ndarray) -> np.ndarray:
    values = np.sort(x, axis=-1)
    if x.ndim == 1:
        return values[0] - values[1]
    return values[..., 0] - values[..., 1]


CSF_DICT = OrderedDict(
    {
        "msp": lambda x: np.max(scipy.special.softmax(x, axis=-1), -1),
        "entropy": lambda x: -entropy_np(x),
        "margin": lambda x: top12_margin_np(x),
    }
)


def csf_matrix(logits: np.ndarray, csf: str = "msp") -> np.ndarray:
    """(E, N) confidence scores from a (E, N, K) logit store."""
    return CSF_DICT[csf](logits)


# --------------------------------------------------------------------------
# global-threshold sweeps
# --------------------------------------------------------------------------

def naive_global_sweep(logits: np.ndarray, thresholds, csf: str = "msp"):
    """Reference 'naieve' scan (thresh.py:69-95); for equivalence tests."""
    fn = CSF_DICT[csf]
    num_exits, num_samples, _ = logits.shape
    thresholds = sorted(thresholds, reverse=True)
    exits = np.full((len(thresholds), num_samples), num_exits, dtype=np.int32)
    preds = np.tile(logits[-1], (len(thresholds), 1, 1))
    for t, threshold in enumerate(thresholds):
        for s in range(num_samples):
            for e in range(num_exits):
                if fn(logits[e][s]) >= threshold:
                    exits[t][s] = e
                    preds[t][s] = logits[e][s]
                    break
    return preds, exits


def vectorized_global_sweep(logits: np.ndarray, thresholds, csf: str = "msp"):
    """opt0 (thresh.py:106-131): precompute CSF, argmax the pass matrix.

    NOTE: like the reference's opt0/naieve, samples where *no* exit passes
    keep exit id ``num_exits`` (out of range) and fall back to last-exit
    logits.
    """
    num_exits, num_samples, _ = logits.shape
    thresholds = np.asarray(sorted(thresholds, reverse=True))
    scores = csf_matrix(logits, csf)  # (E, N)
    passed = scores[None] >= thresholds[:, None, None]  # (T, E, N)
    any_passed = passed.any(axis=1)
    exits = np.where(passed.any(axis=1), passed.argmax(axis=1), num_exits).astype(np.int32)
    clamped = np.minimum(exits, num_exits - 1)
    preds = logits[clamped, np.arange(num_samples)[None]]
    preds = np.where(any_passed[..., None], preds, logits[-1][None])
    return preds, exits


def incremental_global_sweep(logits: np.ndarray, thresholds, csf: str = "msp"):
    """opt1 (thresh.py:134-177): incremental sweep over descending thresholds.

    The reference's incremental insight: as the threshold decreases, the set
    of (exit, sample) pairs that pass only GROWS, so each pair's work can be
    done once — at the first (highest) threshold it passes — instead of per
    threshold. Here each pair's first-passing threshold index comes from one
    ``searchsorted`` over the descending threshold vector, and a single pass
    over thresholds maintains the running first-passing exit per sample.

    NOTE on parity: the reference's opt1 as written has two defects that
    make it INEQUIVALENT to its naieve/opt0 — (a) ``tmp_not`` is computed
    once per threshold but exits update ``tmp_above`` inside the exit loop,
    so a sample passing several exits records the LAST one (thresh.py:
    160-171), and (b) samples above a previous higher threshold are skipped
    entirely, freezing their assignment even though a lower threshold can
    move them to a SHALLOWER exit. The reference's own equality check never
    runs (dead code behind ``sys.exit(1)``, thresh.py:309-318). This
    implementation realizes the *intended* incremental algorithm, which is
    exactly equivalent (asserted against naive/opt0/native in
    tests/test_native_sweep.py).
    """
    num_exits, num_samples, _ = logits.shape
    thresholds = np.asarray(sorted(thresholds, reverse=True), dtype=np.float64)
    num_thresholds = len(thresholds)
    scores = csf_matrix(logits, csf)  # (E, N)

    # first_t[e, n]: index of the highest threshold that (e, n) passes
    # (thresholds descend, so passing is monotone in t); num_thresholds if
    # it never passes. searchsorted on the ascending-negated vector.
    first_t = np.searchsorted(-thresholds, -scores.ravel(), side="left")
    first_t = first_t.reshape(num_exits, num_samples)

    exits = np.full((num_thresholds, num_samples), num_exits, dtype=np.int32)
    cur = np.full(num_samples, num_exits, dtype=np.int32)
    # bucket the pairs by first-passing threshold so each is touched once
    order = np.argsort(first_t, axis=None, kind="stable")
    flat_e, flat_n = np.unravel_index(order, first_t.shape)
    flat_t = first_t[flat_e, flat_n]
    starts = np.searchsorted(flat_t, np.arange(num_thresholds + 1))
    for t in range(num_thresholds):
        lo, hi = starts[t], starts[t + 1]
        if hi > lo:
            np.minimum.at(cur, flat_n[lo:hi], flat_e[lo:hi])
        exits[t] = cur
    clamped = np.minimum(exits, num_exits - 1)
    preds = logits[clamped, np.arange(num_samples)[None]]
    preds = np.where((exits < num_exits)[..., None], preds, logits[-1][None])
    return preds, exits


def time_global_sweeps(
    logits: np.ndarray, thresholds, csf: str = "msp", include_naive: bool = True
) -> dict:
    """Wall-clock the sweep implementations on one store (the reference's
    __main__ timing harness, thresh.py:313-315: runtime_wrapper around
    naieve/opt0/opt1). Returns {impl: seconds}; cli/research.py records the
    artifact."""
    import time

    out = {}
    impls = [
        ("opt0", vectorized_global_sweep),
        ("opt1", incremental_global_sweep),
    ]
    if include_naive:
        impls.insert(0, ("naive", naive_global_sweep))
    for name, fn in impls:
        t0 = time.perf_counter()
        fn(logits, thresholds, csf)
        out[name] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------
# 2D (per-exit) threshold mixtures
# --------------------------------------------------------------------------

def percentile_thresholds(
    logits: np.ndarray, num_per_exit: int = 10, csf: str = "msp"
) -> np.ndarray:
    """Data-driven per-exit threshold grid at CSF percentiles
    (thresh.py:245-256). Last exit row stays 0 (always exits)."""
    num_exits = logits.shape[0]
    grid = np.zeros((num_exits, num_per_exit))
    percentiles = np.linspace(0, 100, num_per_exit)
    fn = CSF_DICT[csf]
    for e in range(num_exits - 1):
        scores = fn(logits[e])
        for p, perc in enumerate(percentiles):
            grid[e, p] = np.percentile(scores, perc)
    return grid


def random_mixtures(
    grid: np.ndarray, num_mixtures: int, seed: int = 42
) -> np.ndarray:
    """(M, E) random per-exit threshold vectors drawn from the grid
    (thresh.py:258-262)."""
    num_exits, num_per_exit = grid.shape
    rng = np.random.RandomState(seed)
    selection = rng.randint(0, num_per_exit, size=(num_mixtures, num_exits))
    return grid[np.arange(num_exits)[None], selection]


def assign_exits_2d(scores: np.ndarray, thresholds_2d: np.ndarray) -> np.ndarray:
    """(M, N) exit assignment for per-exit thresholds (opt0_2D,
    thresh.py:184-215), vectorized over mixtures."""
    # scores (E, N); thresholds (M, E)
    passed = scores[None] >= thresholds_2d[:, :, None]  # (M, E, N)
    return passed.argmax(axis=1).astype(np.int32)


def evaluate_exit_logits(
    logits: np.ndarray, references: np.ndarray, exit_assignment: np.ndarray
) -> Tuple[float, float]:
    """(accuracy, average_exit) for one assignment (thresh.py:228-234)."""
    preds = np.argmax(
        logits[exit_assignment, np.arange(len(references))], axis=-1
    )
    return float(np.mean(preds == references)), float(np.mean(exit_assignment))


def mixture_pareto_sweep(
    logits: np.ndarray,
    references: np.ndarray,
    num_mixtures: int = 1_000_000,
    num_per_exit: int = 10,
    csf: str = "msp",
    seed: int = 42,
    backend: str = "auto",
    chunk: int = 8192,
    device=None,
) -> dict:
    """Full mixture search → (accuracy, average_exit) per mixture.

    backend: "torch" (chunks of ``chunk`` mixtures on ``device``, the card
    unless the caller names another), "native" (C++/OpenMP), "numpy", or
    "auto": torch when a ``device`` is given, else native. A backend that
    fails raises; none hands over to another. The torch and native backends
    compare f32 scores with f32 thresholds, as the JAX package's jax and
    native ones do; numpy compares them in f64.
    """
    if backend == "auto":
        backend = "torch" if device is not None else "native"
    if backend not in ("torch", "native", "numpy"):
        raise ValueError(f"unknown backend {backend!r}: 'torch', 'native', 'numpy' or 'auto'")
    scores = csf_matrix(logits, csf)  # (E, N)
    grid = percentile_thresholds(logits, num_per_exit, csf)
    mixtures = random_mixtures(grid, num_mixtures, seed)
    correct = (np.argmax(logits, axis=-1) == references[None]).astype(np.float32)

    if backend == "native":
        from multi_modal_early_exit_tpu_torch.native import sweep as native_sweep

        acc, avg = native_sweep.mixture_sweep(scores, correct, mixtures)
    elif backend == "torch":
        acc, avg = _torch_mixture_sweep(scores, correct, mixtures, chunk, device)
    else:
        assignment = assign_exits_2d(scores, mixtures)
        acc = correct[assignment, np.arange(scores.shape[1])[None]].mean(-1)
        avg = assignment.mean(-1)
    return {
        "thresholds": mixtures,
        "accuracy": np.asarray(acc),
        "average_exit": np.asarray(avg),
    }


def _torch_mixture_sweep(scores, correct, mixtures, chunk, device=None):
    """(accuracy, average_exit) per mixture, f32, in chunks of (C, E, N) on
    ``device`` (resolved as the port's entry points resolve theirs: the
    card unless the caller passes another). Each mixture's exits are the
    argmax over exits of its pass matrix; the means are sums of 0/1 and of
    exit ids, exact in f32 below 2^24, divided by N."""
    from multi_modal_early_exit_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    scores_d = torch.as_tensor(np.asarray(scores, np.float32), device=dev)
    correct_d = torch.as_tensor(np.asarray(correct, np.float32), device=dev)
    mix_d = torch.as_tensor(np.asarray(mixtures, np.float32), device=dev)
    n = scores_d.shape[1]
    accs, avgs = [], []
    for i in range(0, mix_d.shape[0], chunk):
        passed = scores_d[None] >= mix_d[i:i + chunk, :, None]  # (C, E, N)
        # the first exit that passes, 0 where none does (torch.argmax
        # returns the first of equal maxima)
        assignment = passed.to(torch.uint8).argmax(dim=1)  # (C, N)
        corr = torch.gather(correct_d[None].expand(assignment.shape[0], -1, -1), 1,
                            assignment[:, None, :])[:, 0]
        accs.append(corr.sum(-1) / n)
        avgs.append(assignment.to(torch.float32).sum(-1) / n)
    return torch.cat(accs).cpu().numpy(), torch.cat(avgs).cpu().numpy()
