"""Evaluation pipeline: logit harvesting, calibration, policy sweeps.

Capability parity with the reference eval stack:

- ``get_logits``          EE/utils.py:125-223 — but batched (the reference
                          assumes eval batch size 1, EE/utils.py:188-193);
                          npz caching keyed by checkpoint+dataset dir
- ``calibrate``           EE/eval.py:277-346 — per-exit temperature scaling
                          fit on validation logits, calibrated npz cache,
                          calibration_metrics recorded into the config
- ``eval_model``          EE/eval.py:87-110 — policy → metrics + efficiency
- ``evaluate_checkpoint`` EE/eval.py:163-224 — fixed-exit metrics + a
                          threshold sweep over cached logits (vectorized)
- ``full_test_iteration`` EE/eval.py:227-274 — threshold sweep with
                          per-threshold failure isolation, results JSON per
                          policy directory

The port's copy of the JAX package's ``evaluation/pipeline.py``: ``get_logits``
runs the port's ``ee_forward`` on the card (its attention and bias build in
the hand-written kernels) unless the caller passes ``device="cpu"``; the rest
is numpy and writes the same files, so a store dumped by either package
loads in the other.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from multi_modal_early_exit_tpu_torch.data.datasets import DocClassificationDataset
from multi_modal_early_exit_tpu_torch.data.loader import iterate_batches, prefetch_to_device
from multi_modal_early_exit_tpu_torch.evaluation.analysis import Analysis, calc_flops
from multi_modal_early_exit_tpu_torch.evaluation.calibration import calibrate_exit_logits
from multi_modal_early_exit_tpu_torch.evaluation.metrics import calc_metrics
from multi_modal_early_exit_tpu_torch.evaluation.policy import Policy
from multi_modal_early_exit_tpu_torch.evaluation.thresholds import (
    vectorized_global_sweep,
)
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import EEModelConfig
from multi_modal_early_exit_tpu_torch.utils.artifacts import (
    config_to_checkpoint,
    dump_logits,
    load_json,
    load_npz,
    save_json,
)
from multi_modal_early_exit_tpu_torch.utils.logging import logger_message
from multi_modal_early_exit_tpu_torch.utils.meters import AverageMeter


def reprocess_batch_for_benchmark(batch: Dict, tokenizer, seq_len: int):
    """Re-run the FULL preprocessing pipeline on one batch — OCR,
    tokenization/bbox-normalization, and image preprocessing — so a caller
    timing this call includes every host-side stage the reference's
    ``--benchmark_OCR`` times (EE/utils.py:176-177 re-runs the AutoProcessor
    inside the loop: pytesseract OCR + tokenizer + image transforms).

    OCR stage: pytesseract per page when available; otherwise the synthetic
    word generator stands in for the OCR cost (zero-egress environments have
    no tesseract), followed by REAL tokenization either way.

    Returns the re-preprocessed ``pixel_values``. The re-tokenized features
    are computed for their cost but not returned: re-processing is only
    idempotent on real document datasets (the reference's case); synthetic
    pages carry no OCR-able text, so swapping inputs would change logits.
    """
    from multi_modal_early_exit_tpu_torch.data.features import (
        convert_words_to_features,
    )
    from multi_modal_early_exit_tpu_torch.data.images import preprocess_images
    from multi_modal_early_exit_tpu_torch.data.ocr import (
        apply_tesseract,
        have_tesseract,
    )

    raw = (
        (np.asarray(batch["pixel_values"]).transpose(0, 2, 3, 1) * 0.5 + 0.5)
        * 255
    ).astype(np.uint8)
    n = raw.shape[0]
    if have_tesseract():
        from PIL import Image

        for i in range(n):
            words, boxes = apply_tesseract(Image.fromarray(raw[i]))
            convert_words_to_features(words, boxes, tokenizer, seq_len)
    else:
        from multi_modal_early_exit_tpu_torch.data.datasets import synthetic_tokens

        synthetic_tokens(n, seq_len=seq_len, seed=0, tokenizer=tokenizer)
    return preprocess_images(torch.from_numpy(raw), size=raw.shape[1]).numpy()


SEQ_PAD_MULTIPLE = 128  # the kernels' sequence pad, as the JAX pipeline pads for its flash kernel


def get_logits(
    model,
    cfg: EEModelConfig,
    dataset: DocClassificationDataset,
    config: Dict,
    batch_size: int = 8,
    root: str = "results",
    use_cache: bool = True,
    benchmark_ocr: bool = False,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, float]]:
    """Harvest the (E+1, N, K) per-exit logit store for a whole split.

    One batched ``ee_forward`` per batch (for a dense ``LayoutLMv2Config``,
    ``forward_sequence_classification``, a (1, N, K) store) under
    ``torch.inference_mode()``,
    in the model's dtype, on ``device``: the card unless the caller passes
    ``device="cpu"`` (no card raises); the model is moved there, as
    ``Pipeline`` moves its own. On the card the sequence is padded to a
    multiple of 128 (709 -> 768), as the JAX pipeline pads for its flash
    kernel; padded keys are masked, the logits unchanged. Batches reach the
    device one ahead (``prefetch_to_device``). The store layout and float64
    dtype match the reference dump contract (EE/utils.py:160-164) so npz
    artifacts are interchangeable. ``benchmark_ocr`` re-runs the FULL host
    preprocessing — OCR (tesseract when available, else the synthetic word
    generator as OCR-cost stand-in), tokenization, and image preprocessing —
    inside the timed loop so throughput numbers include every stage the
    reference's --benchmark_OCR times (EE/utils.py:176-177 re-runs the whole
    AutoProcessor per batch).
    """
    from multi_modal_early_exit_tpu_torch.device import resolve_device
    from multi_modal_early_exit_tpu_torch.models.ee.model import ee_forward
    from multi_modal_early_exit_tpu_torch.models.layoutlmv2.modeling import (
        forward_sequence_classification,
    )

    device = resolve_device(device)
    name = config.get("labelset", dataset.split)
    output_path = config_to_checkpoint(config, root=root)
    logits_file = os.path.join(output_path, f"exit_logits-{name}.npz")
    refs_file = os.path.join(output_path, f"references-{name}.npz")
    if use_cache and os.path.exists(logits_file) and os.path.exists(refs_file):
        logger_message(f"Loading cached logits from {output_path}", type="warning")
        return load_npz(logits_file), load_npz(refs_file), {}

    model = model.to(device)
    pad_multiple = SEQ_PAD_MULTIPLE if device.type == "cuda" else None

    tokenizer = None
    if benchmark_ocr:
        # tokenizer load stays OUTSIDE the timed loop (the reference builds
        # its processor once in load_assets, EE/utils.py:47-77)
        from multi_modal_early_exit_tpu_torch.data.features import load_tokenizer

        tokenizer = load_tokenizer()

    def batches():
        for batch in iterate_batches(dataset, batch_size):
            if benchmark_ocr:
                batch["pixel_values"] = reprocess_batch_for_benchmark(
                    batch, tokenizer, batch["input_ids"].shape[1]
                )
            yield batch

    batch_time = AverageMeter()
    stores, refs = [], []
    end = time.perf_counter()
    with torch.inference_mode():
        for batch in prefetch_to_device(batches(), device):
            args = (model, cfg, batch["input_ids"], batch["bbox"], batch["pixel_values"],
                    batch["attention_mask"])
            if hasattr(cfg, "exit"):
                logits = ee_forward(*args, seq_pad_multiple=pad_multiple).policy_logits()
            else:
                # the dense baseline (LayoutLMv2Config): a single-row store,
                # so the policy and metric stack downstream runs unchanged
                logits = forward_sequence_classification(
                    *args, seq_pad_multiple=pad_multiple).logits[None]
            store = logits.to(torch.float64).cpu().numpy()  # waits for the card
            keep = batch["sample_mask"].cpu().numpy() > 0
            stores.append(store[:, keep])
            refs.append(batch["labels"].cpu().numpy()[keep])
            batch_time.update(time.perf_counter() - end)
            end = time.perf_counter()

    logits_store = np.concatenate(stores, axis=1).astype(np.float64)
    references = np.concatenate(refs)
    stats = {
        "batch_time_avg": batch_time.avg,
        "docs_per_sec": len(references) / max(batch_time.sum, 1e-9),
    }
    if use_cache:
        # write-through on miss so re-running a sweep never re-harvests
        # (parity: the reference caches inside get_logits, EE/utils.py:147-158)
        dump_logits(logits_store, references, config, name=name, root=root)
    return logits_store, references, stats


def calibrate(
    test_logits: np.ndarray,
    validation_logits: np.ndarray,
    validation_references: np.ndarray,
    config: Dict,
    root: str = "results",
    use_cache: bool = True,
) -> np.ndarray:
    """Per-exit temperature scaling (EE/eval.py:277-346).

    Fits one temperature per exit on validation logits (scipy L-BFGS-B, same
    optimizer as the reference for threshold parity), applies to the test
    store, records calibration_metrics {ece, accuracy, temperature,
    average_confidence} into ``config`` for accuracy_calibration_heuristic.
    """
    output_path = config_to_checkpoint(config, root=root)
    cal_file = os.path.join(output_path, "exit_logits-calibrated.npz")
    if use_cache and os.path.exists(cal_file):
        logger_message(f"Loading calibrated logits from {output_path}",
                       type="warning")
        calibrated = load_npz(cal_file)
        cfg_file = os.path.join(output_path, "config.json")
        if os.path.exists(cfg_file):
            cached = load_json(cfg_file)
            if "calibration_metrics" in cached:
                config["calibration_metrics"] = cached["calibration_metrics"]
        return np.asarray(calibrated)

    calibrated, metrics = calibrate_exit_logits(
        validation_logits, validation_references, test_logits
    )
    config["calibration_metrics"] = metrics
    dump_logits(calibrated, None, config, name="calibrated", root=root)
    return calibrated


def eval_model(
    logits: np.ndarray,
    references: np.ndarray,
    config: Dict,
    analysis: Optional[Analysis] = None,
) -> Dict[str, object]:
    """Apply the configured exit policy; return predictive metrics +
    efficiency log (EE/eval.py:87-110)."""
    policy = Policy(logits=logits, config=config)
    exits_store, predictions, exit_distribution = getattr(
        policy, config["exit_policy"]
    )()
    to_log: Dict[str, object] = {}
    to_log.update(calc_metrics(predictions, references))
    if analysis is not None:
        to_log.update(calc_flops(exit_distribution, analysis, config))
    else:
        to_log["exit_distribution"] = exit_distribution
        to_log["exit_threshold"] = config.get("exit_threshold")
    to_log["average_exit"] = float(np.mean(exits_store))
    return to_log


def full_test_iteration(
    logits: np.ndarray,
    references: np.ndarray,
    config: Dict,
    start_threshold: float,
    step: float,
    analysis: Optional[Analysis] = None,
    root: str = "results",
    log_fn: Optional[Callable[[Dict], None]] = None,
    run_factory: Optional[Callable[[Dict], object]] = None,
) -> list:
    """Threshold sweep with per-threshold failure isolation
    (EE/eval.py:227-274). Results saved to
    ``<results>/<ckpt>-<ds>/<policy>/{non-,}calibrated-metrics.json``.

    ``run_factory``: called with the per-threshold config to open a fresh
    observability run per threshold (parity: the reference starts a new
    wandb run for each, EE/eval.py:253-255); the run is finished after the
    threshold's metrics are logged. Takes precedence over ``log_fn``.
    """
    thresholds = np.arange(start_threshold, 1, step)
    results = []
    for threshold in thresholds:
        threshold = float(threshold)
        if config["exit_policy"] == "accuracy_calibration_heuristic":
            config["epsilon"] = threshold
        else:
            config["exit_threshold"] = threshold
        run = None
        if run_factory is not None:
            run = run_factory(dict(config, run_suffix=f"thr{threshold:g}"))
        try:
            logs = eval_model(logits, references, config, analysis)
            if run is not None:
                run.log(logs)
            elif log_fn is not None:
                log_fn(logs)
            results.append(logs)
        except Exception as e:  # isolate one failing threshold
            logger_message(
                f"FAILED EXPERIMENT at threshold {threshold} due to {e}",
                type="error",
            )
        finally:
            if run is not None:
                run.finish()
    out_dir = os.path.join(
        config_to_checkpoint(config, root=root), config["exit_policy"]
    )
    os.makedirs(out_dir, exist_ok=True)
    name = "calibrated" if config.get("calibrate") else "non-calibrated"
    save_json(os.path.join(out_dir, f"{name}-metrics.json"), results)
    return results


def evaluate_checkpoint(checkpoint_dir: str, args: Optional[Dict] = None) -> Dict:
    """Offline evaluation over a dumped logit store (EE/eval.py:163-224):
    fixed-exit metrics per exit + a vectorized threshold sweep."""
    config = load_json(os.path.join(checkpoint_dir, "config.json"))
    if args:
        config.update(args)
    references = load_npz(os.path.join(checkpoint_dir, "references-test.npz"))
    exit_logits = load_npz(os.path.join(checkpoint_dir, "exit_logits-test.npz"))

    fixed = OrderedDict()
    for exit_id in range(exit_logits.shape[0]):
        for key, value in calc_metrics(exit_logits[exit_id], references).items():
            fixed[f"exit_{exit_id}_{key}"] = value

    thresholds = np.round(np.arange(0, 1, 0.01), 2)
    preds, exits = vectorized_global_sweep(exit_logits, thresholds)
    adaptive = OrderedDict()
    adaptive_exits = OrderedDict()
    for t, threshold in enumerate(sorted(thresholds, reverse=True)):
        for key, value in calc_metrics(preds[t], references).items():
            adaptive[f"threshold_{threshold}_{key}"] = value
        adaptive_exits[f"threshold_{threshold}_exits"] = exits[t].tolist()

    results = {
        "fixed": fixed,
        "adaptive": adaptive,
        "adaptive_exits": adaptive_exits,
    }
    save_json(os.path.join(checkpoint_dir, "results.json"), results)
    return results
