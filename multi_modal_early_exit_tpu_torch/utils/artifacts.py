"""Artifact I/O: npz logit dumps, JSON results, results-dir naming.

Keeps the reference's on-disk artifact contract so dumped logits are
interchangeable for cross-checking (reference: EE/utils.py:103-122, 240-271):

    results/<ckpt>-<dataset>[-<downsampling>i]/
        exit_logits-{test,validation}.npz     # (num_exits+1, N, num_labels)
        references-{test,validation}.npz
        exit_logits-calibrated.npz
        config.json
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from multi_modal_early_exit_tpu_torch.utils.logging import logger_message


def save_json(file_path: str, data: Any) -> None:
    logger_message(f"Saving results to {file_path}")
    os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
    with open(file_path, "w+") as f:
        json.dump(data, f, indent=4, default=_json_default)


def _json_default(obj):
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return str(obj)


def load_json(file_path: str) -> Any:
    with open(file_path) as f:
        return json.load(f)


def save_npz(file_path: str, array: np.ndarray) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
    np.savez_compressed(file_path, np.asarray(array))


def load_npz(file_path: str) -> np.ndarray:
    return np.load(file_path)["arr_0"]


def config_to_checkpoint(config: Dict[str, Any], root: str = "results") -> str:
    """Results directory for a (checkpoint, dataset) pair
    (reference: EE/utils.py:115-122)."""
    ckpt = str(config.get("checkpoint", "model")) or "model"
    ds = str(config.get("test_dataset", config.get("dataset", "dataset")))
    output_path = os.path.join(root, f"{ckpt.split('/')[-1]}-{ds.split('/')[-1]}")
    if config.get("downsampling"):
        output_path += f"-{config['downsampling']}i"
    return output_path


def dump_logits(
    logits: np.ndarray,
    references: Optional[np.ndarray],
    config: Dict[str, Any],
    name: str = "test",
    root: str = "results",
) -> str:
    """Dump per-exit logits + references + sanitized config
    (reference: EE/utils.py:240-271)."""
    output_path = config_to_checkpoint(config, root=root)
    os.makedirs(output_path, exist_ok=True)
    logger_message(f"Saving {name} to {output_path}")
    if references is not None:
        save_npz(os.path.join(output_path, f"references-{name}.npz"), references)
    save_npz(os.path.join(output_path, f"exit_logits-{name}.npz"), logits)

    to_save = dict(config)
    for key in (
        "exit_threshold", "global_threshold", "inference_strategy", "exit_policy",
        "use_lte", "use_wandb", "calibrate", "full_test", "step", "epsilon",
    ):
        to_save.pop(key, None)
    save_json(os.path.join(output_path, "config.json"), to_save)
    return output_path
