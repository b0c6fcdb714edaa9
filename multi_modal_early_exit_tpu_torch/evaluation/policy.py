"""Offline exit policies over dumped per-exit logits.

API parity with the reference ``Policy`` class (EE/policy.py:7-111): logits of
shape (num_exits + 1, num_samples, num_labels); returns
(exits_store, predictions, exit_distribution).

The reference scans python-loop per sample/exit; here both policies are fully
vectorized (the opt0 trick the reference validates in EE/thresh.py:106-131 —
its ``__main__`` cross-checks naive vs vectorized equality, mirrored in our
tests), with a naive implementation kept for cross-checking.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import scipy.special


def _msp(logits: np.ndarray) -> np.ndarray:
    """Max softmax probability per (exit, sample): (E, N)."""
    return np.max(scipy.special.softmax(logits, axis=-1), axis=-1)


def _scan(logits: np.ndarray, thresholds: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """First exit whose MSP strictly exceeds its threshold; else last exit.

    thresholds: scalar broadcast or per-exit vector (E,).
    """
    num_exits, num_samples, _ = logits.shape
    csf = _msp(logits)  # (E, N)
    passed = csf > np.reshape(thresholds, (-1, 1))
    passed[-1] = True  # the final classifier row always exits
    exits_store = np.argmax(passed, axis=0).astype(np.int32)
    predictions = logits[exits_store, np.arange(num_samples)]
    return exits_store, predictions


def _naive_scan(logits: np.ndarray, thresholds: np.ndarray):
    """Reference-shaped python scan, for equivalence testing only."""
    num_exits, num_samples, num_labels = logits.shape
    thresholds = np.broadcast_to(np.asarray(thresholds, dtype=float).reshape(-1),
                                 (num_exits,))
    exits_store = np.zeros(num_samples, dtype=np.int32)
    predictions = np.zeros((num_samples, num_labels), dtype=np.float64)
    for s in range(num_samples):
        for e in range(num_exits):
            score = np.max(scipy.special.softmax(logits[e][s]))
            if score > thresholds[e] or e == num_exits - 1:
                exits_store[s] = e
                predictions[s] = logits[e][s]
                break
    return exits_store, predictions


def exit_distribution_of(exits_store: np.ndarray, num_exits: int) -> Dict[int, float]:
    n = len(exits_store)
    return {e: float(np.count_nonzero(exits_store == e)) / n for e in range(num_exits)}


class Policy:
    """Exit policies over a logit store (E+1, N, K)."""

    def __init__(self, logits, config) -> None:
        self.logits = np.asarray(logits)
        self.config = config

    def max_confidence_global_thresholding_policy(self):
        """Single global MSP threshold (EE/policy.py:12-53)."""
        threshold = self.config["exit_threshold"]
        exits_store, predictions = _scan(self.logits, np.full(1, threshold))
        dist = exit_distribution_of(exits_store, self.logits.shape[0])
        return exits_store, predictions, dist

    def patience_policy(self):
        """PABEE prediction-stability policy over the dumped store: first
        exit where the top-1 prediction has been unchanged for
        ``exit_threshold`` consecutive exits, else the final row.

        The reference names this criterion with a PABEE citation but raises
        NotImplementedError (EE/models/EE_modules.py:116-146); semantics here
        follow the paper (Zhou et al. 2020, arXiv:2006.04152).
        """
        t = self.config["exit_threshold"]
        preds = np.argmax(self.logits, axis=-1)  # (E+1, N)
        counts = np.zeros(preds.shape, np.int64)
        for j in range(1, preds.shape[0]):
            counts[j] = np.where(preds[j] == preds[j - 1], counts[j - 1] + 1, 0)
        passed = counts >= t
        passed[-1] = True
        exits_store = np.argmax(passed, axis=0).astype(np.int32)
        predictions = self.logits[exits_store, np.arange(self.logits.shape[1])]
        dist = exit_distribution_of(exits_store, self.logits.shape[0])
        return exits_store, predictions, dist

    def accuracy_calibration_heuristic(self):
        """Per-exit thresholds derived from calibration metrics
        (EE/policy.py:55-111): 1 - accuracy/ece per exit, min-max normalized
        to ]0,1[ with ±epsilon margins."""
        if "calibration_metrics" not in self.config:
            raise Exception(
                "calibration_metrics not in config -> Set calibrate flag to True"
            )
        num_exits = self.logits.shape[0]
        cm = self.config["calibration_metrics"]
        accuracies, ece = cm["accuracy"], cm["ece"]
        metrics = [1 - (accuracies[i] / ece[i]) for i in range(num_exits)]
        epsilon = self.config["epsilon"]
        thresholds = (np.array(metrics) - (np.min(metrics) - epsilon)) / (
            (np.max(metrics) + epsilon) - (np.min(metrics) - epsilon)
        )
        exits_store, predictions = _scan(self.logits, thresholds)
        dist = exit_distribution_of(exits_store, num_exits)
        return exits_store, predictions, dist
