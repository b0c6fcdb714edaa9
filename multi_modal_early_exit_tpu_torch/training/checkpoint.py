"""Checkpoint save/restore and the config round-trip.

Capability parity with the reference's HF-Trainer checkpointing
(EE/IC_only.py:149-166: save per epoch, keep best, limit 3) and the config
round-trip through the saved ``config.json`` whose embedded EE_config becomes
the config on reload (EE/configs.py:389-395).

The port's own layout, since the JAX package's orbax format needs JAX:

    <dir>/
      state.pt      # {"state_dict": ..., "opt_state": ..., "step": ...}
      config.json   # the ExperimentConfig dump, the JAX package's schema

``state.pt`` holds tensors, ints and plain containers only, so it loads with
``torch.load(..., weights_only=True)`` (no pickled classes). The model's
state dict is stored on the CPU; ``load_checkpoint`` returns it there.

Under a ``parallel.mesh.Mesh`` the files hold the full state all the same:
``save_checkpoint`` gathers the model's shards and the AdamW moments of the
split parameters over the model group (``parallel.sharding``), rank 0
alone writes, and every rank waits at a barrier; ``load_checkpoint`` reads
the full state and gives each rank its slices. So a checkpoint written
under one mesh loads under any other, or on one device.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from multi_modal_early_exit_tpu_torch.parallel.sharding import (
    gather_optimizer_state,
    gather_params,
    shard_optimizer_state,
    shard_params,
)

STATE_FILE = "state.pt"


def _is_writer(mesh) -> bool:
    return mesh is None or mesh.rank == 0


def _barrier(mesh) -> None:
    if mesh is not None and dist.is_initialized():
        dist.barrier()


def save_checkpoint(
    directory: str,
    state_dict: Dict[str, torch.Tensor],
    config: Optional[Dict[str, Any]] = None,
    opt_state: Optional[Dict[str, Any]] = None,
    step: Optional[int] = None,
    mesh=None,
    opt_names: Optional[Sequence[str]] = None,
) -> str:
    """Write a model's state dict (+ optional optimizer state and step) and
    the run config into ``directory``; returns it. Under a ``mesh`` the
    state is this rank's and is gathered first (``opt_names``: the
    optimizer's parameter names in its order, ``list(Optimizer.params)``);
    every rank calls it, rank 0 writes."""
    if mesh is not None:
        state_dict = gather_params(state_dict, mesh)
        if opt_state is not None:
            opt_state = gather_optimizer_state(opt_state, opt_names, mesh)
        if not _is_writer(mesh):
            _barrier(mesh)
            return directory
    os.makedirs(directory, exist_ok=True)
    payload: Dict[str, Any] = {
        "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()}}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    if step is not None:
        payload["step"] = int(step)
    tmp = os.path.join(directory, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(directory, STATE_FILE))  # whole or absent
    if config is not None:
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)
    _barrier(mesh)
    return directory


def load_checkpoint(
    directory: str, with_opt_state: bool = False, mesh=None,
    opt_names: Optional[Sequence[str]] = None,
) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, Any]], Optional[Any], Optional[int]]:
    """Restore ``(state_dict, config, opt_state, step)``, as the JAX
    package's 4-tuple; ``opt_state`` only with ``with_opt_state``. Under a
    ``mesh``, this rank's slices of the state (and, with ``opt_names``, of
    the moments)."""
    payload = torch.load(os.path.join(directory, STATE_FILE), map_location="cpu",
                         weights_only=True)
    opt_state = payload.get("opt_state") if with_opt_state else None
    state_dict = payload["state_dict"]
    if mesh is not None:
        state_dict = shard_params(state_dict, mesh)
        if opt_state is not None:
            opt_state = shard_optimizer_state(opt_state, opt_names, mesh)
    step = payload.get("step")
    config = None
    cfg_file = os.path.join(directory, "config.json")
    if os.path.exists(cfg_file):
        with open(cfg_file) as f:
            config = json.load(f)
    return state_dict, config, opt_state, step


class CheckpointManager:
    """Epoch-style rolling checkpoints with best-model tracking
    (save_total_limit=3 + load_best_model_at_end semantics)."""

    def __init__(self, root: str, keep: int = 3, higher_is_better: bool = True):
        self.root = os.path.abspath(root)
        self.keep = keep
        self.higher_is_better = higher_is_better
        self.saved: list = []
        self.best_metric: Optional[float] = None
        self.best_dir: Optional[str] = None
        os.makedirs(self.root, exist_ok=True)

    def save(self, epoch: int, state_dict, config=None, opt_state=None,
             metric: Optional[float] = None, mesh=None, opt_names=None) -> str:
        """``save_checkpoint`` into ``checkpoint-<epoch>`` (every rank calls
        it under a ``mesh``; rank 0 writes and deletes)."""
        directory = os.path.join(self.root, f"checkpoint-{epoch}")
        save_checkpoint(directory, state_dict, config, opt_state, step=epoch, mesh=mesh,
                        opt_names=opt_names)
        self.saved.append(directory)
        if metric is not None and (
            self.best_metric is None
            or (metric > self.best_metric) == self.higher_is_better
        ):
            self.best_metric = metric
            self.best_dir = directory
        # rolling deletion, never deleting the best
        while len(self.saved) > self.keep:
            victim = next((d for d in self.saved if d != self.best_dir), None)
            if victim is None:
                break
            self.saved.remove(victim)
            if _is_writer(mesh):
                shutil.rmtree(victim, ignore_errors=True)
        return directory

    def load_best(self):
        if self.best_dir is None:
            raise RuntimeError("no best checkpoint recorded")
        return load_checkpoint(self.best_dir)
