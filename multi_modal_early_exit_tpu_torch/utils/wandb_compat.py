"""wandb experiment logging with a hermetic offline fallback.

Parity: ``init_wandb``/``nameit`` (reference: EE/configs.py:190-206); the
port's copy of the JAX package's module. When wandb is unavailable or the
environment has no network, a JSONL-file logger with the same
``.log()/.finish()`` surface is returned so callers never branch. wandb is
imported only when a run asks for it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


def nameit(config: Dict[str, Any]) -> str:
    """Run name from dataset + checkpoint (+ '-calibrated')
    (reference: EE/configs.py:190-193)."""
    name = str(config.get("test_dataset", config.get("dataset", "run"))).split("/")[-1]
    ckpt = str(config.get("checkpoint", "")).split("/")[-1]
    if ckpt:
        name = f"{name}-{ckpt}"
    if config.get("calibrate"):
        name += "-calibrated"
    if config.get("run_suffix"):
        # per-threshold sweep runs (reference: EE/eval.py:253-255)
        name += f"-{config['run_suffix']}"
    return name


class FileRun:
    """wandb.Run-shaped JSONL logger for offline environments."""

    def __init__(self, name: str, config: Dict[str, Any], directory: str = "runs"):
        self.name = name
        self.dir = os.path.join(directory, name)
        os.makedirs(self.dir, exist_ok=True)
        self._f = open(os.path.join(self.dir, "log.jsonl"), "a")
        self._f.write(json.dumps({"_config": _sanitize(config),
                                  "_t": time.time()}) + "\n")

    def log(self, data: Dict[str, Any], step: Optional[int] = None) -> None:
        rec = {"_t": time.time(), **_sanitize(data)}
        if step is not None:
            rec["_step"] = step
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def finish(self) -> None:
        self._f.close()


def _sanitize(d: Dict[str, Any]) -> Dict[str, Any]:
    import numpy as np
    import torch

    out = {}
    for k, v in d.items():
        if isinstance(v, torch.Tensor):  # a scalar as a number, else a list
            v = v.detach().cpu()
            v = v.item() if v.numel() == 1 and v.ndim == 0 else v.tolist()
        if isinstance(v, (np.integer,)):
            v = int(v)
        elif isinstance(v, (np.floating,)):
            v = float(v)
        elif isinstance(v, np.ndarray):
            v = v.tolist()
        elif not isinstance(v, (str, int, float, bool, list, dict, type(None))):
            v = str(v)
        out[k] = v
    return out


def init_wandb(config: Dict[str, Any], project: str = "EE-tpu"):
    """wandb run when importable+online, FileRun otherwise."""
    name = nameit(config)
    if config.get("use_wandb"):
        try:
            import wandb

            return wandb.init(
                project=project, name=name, config=_sanitize(config),
                reinit=True,
            )
        except Exception:
            pass
    return FileRun(name, config)
