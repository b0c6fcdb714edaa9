"""Evaluation / policy-sweep entry point (parity: EE/eval.py __main__).

Three modes (reference: EE/eval.py:126-141):

1. dump:        no --exit_threshold (== -1) — harvest + dump per-exit logits
2. single:      --exit_threshold T — one policy evaluation
3. full sweep:  --full_test True --exit_threshold T0 --step S — threshold
                sweep [T0, 1) with per-threshold metrics (+ --calibrate True
                for temperature-scaled logits)

    python -m multi_modal_early_exit_tpu_torch.cli.evaluate \
        -c save/<experiment>/checkpoint-1 -d synthetic_rvl_cdip \
        --full_test True --calibrate True --exit_threshold 0.05 --step 0.05

The port's counterpart of the JAX package's ``cli/evaluate.py``, with the
same artifacts under ``results/``. The harvest runs on ``device``, taken
from the command line (``with device=cpu``; the card by default), never
from a saved ``config.json``: one written by the JAX package says ``tpu``.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional

from multi_modal_early_exit_tpu_torch.config.experiment import (
    ExperimentConfig,
    parse_cli,
)
from multi_modal_early_exit_tpu_torch.data.datasets import build_dataset
from multi_modal_early_exit_tpu_torch.evaluation.analysis import Analysis
from multi_modal_early_exit_tpu_torch.evaluation.pipeline import (
    calibrate as calibrate_logits,
    eval_model,
    full_test_iteration,
    get_logits,
)
from multi_modal_early_exit_tpu_torch.models.registry import build_model
from multi_modal_early_exit_tpu_torch.training.checkpoint import load_checkpoint
from multi_modal_early_exit_tpu_torch.utils.artifacts import (
    config_to_checkpoint,
    dump_logits,
)
from multi_modal_early_exit_tpu_torch.utils.logging import logger_message
from multi_modal_early_exit_tpu_torch.utils.seeding import seed_everything
from multi_modal_early_exit_tpu_torch.utils.wandb_compat import init_wandb

# what the command line sets over a saved run config
COMMAND_LINE_KEYS = (
    "checkpoint", "test_dataset", "labelset", "exit_threshold", "inference_strategy",
    "calibrate", "full_test", "step", "exit_policy", "epsilon", "downsampling",
    "eval_batch_size", "plot_exits", "benchmark_OCR", "print_freq", "use_wandb", "device",
)


def load_assets(cfg: ExperimentConfig):
    """``(cfg, model config, model)`` from a checkpoint dir (config
    round-trip, reference: EE/utils.py:47-77 + EE/configs.py:389-395), or a
    random model when ``cfg.checkpoint`` is no directory; the model on
    ``cfg.device``."""
    generator = seed_everything(cfg.seed)
    if cfg.checkpoint and os.path.isdir(cfg.checkpoint):
        state, saved_cfg, _, _ = load_checkpoint(cfg.checkpoint)
        if saved_cfg:
            merged = {**saved_cfg, **{
                k: v for k, v in cfg.to_dict().items() if k in COMMAND_LINE_KEYS
            }}
            cfg = ExperimentConfig.from_dict(merged)
        ds_name = cfg.test_dataset or cfg.dataset
        model_cfg, model = _build_for_dataset(cfg.replace(model_weights=""), ds_name,
                                              generator)
        model.load_state_dict(state, strict=True)
    else:
        ds_name = cfg.test_dataset or cfg.dataset
        model_cfg, model = _build_for_dataset(cfg, ds_name, generator)
    return cfg, model_cfg, model


def _build_for_dataset(cfg: ExperimentConfig, ds_name: str, generator):
    probe = build_dataset(ds_name, "test")
    return build_model(
        cfg, num_labels=probe.num_labels,
        image_size=probe.arrays["pixel_values"].shape[-1],
        seq_len=probe.arrays["input_ids"].shape[-1],
        generator=generator,
    )


def main(argv: Optional[list] = None) -> Dict:
    cfg = parse_cli(argv if argv is not None else sys.argv[1:])
    cfg, model_cfg, model = load_assets(cfg)
    config = cfg.to_dict()

    ds_name = cfg.test_dataset or cfg.dataset
    test_ds = build_dataset(ds_name, cfg.labelset or "test")
    if cfg.downsampling:
        test_ds = test_ds.downsample(cfg.downsampling)

    config["labelset"] = cfg.labelset or "test"
    logits, references, stats = get_logits(
        model, model_cfg, test_ds, config,
        batch_size=max(cfg.eval_batch_size, 1),
        benchmark_ocr=bool(cfg.benchmark_OCR), device=cfg.device,
    )
    if stats:
        logger_message(f"harvest: {stats}")

    dump_mode = config.get("exit_threshold", -1) == -1
    if dump_mode:
        dump_logits(logits, references, config, name=config["labelset"])
        logger_message("dump mode: logits saved; no policy evaluation")
        return {"mode": "dump", "n": len(references)}

    if cfg.calibrate:
        val_ds = build_dataset(ds_name, "validation")
        val_config = dict(config, labelset="validation")
        val_logits, val_refs, _ = get_logits(
            model, model_cfg, val_ds, val_config,
            batch_size=max(cfg.eval_batch_size, 1), device=cfg.device,
        )
        logits = calibrate_logits(logits, val_logits, val_refs, config)

    if cfg.plot_exits:
        # qualitative top-k exit grids (parity: eval.py:109-110 + plots.py)
        from multi_modal_early_exit_tpu_torch.evaluation.plots import plot_exits
        from multi_modal_early_exit_tpu_torch.evaluation.policy import Policy

        exits_store, _, _ = Policy(logits, config) \
            .max_confidence_global_thresholding_policy()
        saved = plot_exits(
            logits, references, exits_store, test_ds.arrays["pixel_values"],
            id2label=test_ds.id2label,
            out_dir=os.path.join(config_to_checkpoint(config), "plots"),
        )
        logger_message(f"exit plots: {saved}")

    analysis = Analysis(model, model_cfg)
    if cfg.full_test:
        # one observability run per threshold (parity: EE/eval.py:253-255)
        results = full_test_iteration(
            logits, references, config,
            start_threshold=config["exit_threshold"], step=cfg.step,
            analysis=analysis, run_factory=init_wandb,
        )
        return {"mode": "full_test", "n_thresholds": len(results)}

    logs = eval_model(logits, references, config, analysis)
    logger_message(f"results: {logs}")
    return logs


if __name__ == "__main__":
    main()
