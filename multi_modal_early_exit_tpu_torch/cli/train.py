"""Training entry point (parity: EE/IC_only.py).

Usage (mirrors the reference's sacred CLI):

    python -m multi_modal_early_exit_tpu_torch.cli.train with layoutlmv3 \
        model=EElayoutlmv3 dataset=synthetic_rvl_cdip epochs=2 \
        exits=text_avg,vision_avg,7 training_strategy=one_stage_subgraphs_weighted

Pipeline: seed -> build model -> build 3 dataset splits -> train with the
configured EE strategy -> evaluate on test (per-exit accuracies), with a
checkpoint per epoch under ``output_dir/<experiment name>``. The port's
counterpart of the JAX package's ``cli/train.py``: ``EETrainer`` on
``device`` (the card unless ``with device=cpu``).

Across devices it runs one process per rank, launched by torchrun:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m multi_modal_early_exit_tpu_torch.cli.train with mesh_shape=2,2 ...

Each rank's device is ``cuda:LOCAL_RANK`` unless ``device`` names one
(``device=cpu``: gloo ranks on the CPU). ``mesh_shape`` is (data, model);
left at (1, 1) under several ranks it is pure data parallelism over all of
them. Each rank loads every batch and takes its rows of the micro-batch
axis (``shard_batch(..., axis=1)``, so gradient accumulation at 1 works
under a data axis); rank 0 alone logs, writes checkpoints and returns the
metrics (the others return ``{}``). A model axis above 1 needs LayoutLMv3
with both towers (``models.registry.splits_over_model_axis``); any other
model raises ``NotImplementedError``. So do ``dit``, ``dit_rvl`` and
``bert`` under any mesh, before any data is built: ``EETrainer`` does not
train them (``models.registry.trains_through_ee_trainer``).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multi_modal_early_exit_tpu_torch.config.experiment import (
    ExperimentConfig,
    parse_cli,
)
from multi_modal_early_exit_tpu_torch.data.datasets import build_dataset
from multi_modal_early_exit_tpu_torch.data.loader import accumulation_layout, iterate_batches
from multi_modal_early_exit_tpu_torch.models.registry import (
    build_model,
    refuse_ee_trainer,
    splits_over_model_axis,
)
from multi_modal_early_exit_tpu_torch.parallel.mesh import create_mesh, default_mesh_shape
from multi_modal_early_exit_tpu_torch.parallel.multihost import maybe_initialize_distributed
from multi_modal_early_exit_tpu_torch.parallel.sharding import shard_batch, shard_model
from multi_modal_early_exit_tpu_torch.training.checkpoint import (
    CheckpointManager,
    load_checkpoint,
)
from multi_modal_early_exit_tpu_torch.training.trainer import EETrainer, TrainingArguments
from multi_modal_early_exit_tpu_torch.utils.logging import logger_message
from multi_modal_early_exit_tpu_torch.utils.seeding import seed_everything
from multi_modal_early_exit_tpu_torch.utils.wandb_compat import init_wandb


def mesh_shape_of(cfg: ExperimentConfig) -> Tuple[int, ...]:
    """``cfg.mesh_shape`` as ints (the command line gives ``"2,2"``)."""
    shape = cfg.mesh_shape
    if isinstance(shape, str):
        shape = shape.strip("()[] ").split(",")
    return tuple(int(n) for n in shape)


def setup_mesh(cfg: ExperimentConfig):
    """``(mesh, device)``: a mesh over the torchrun world (``None`` for one
    process) and this rank's device."""
    device = cfg.device
    shape = mesh_shape_of(cfg)
    if shape[1] > 1 and not splits_over_model_axis(cfg.model):
        raise NotImplementedError(
            f"model {cfg.model!r} under mesh_shape {shape}: a model axis above 1 needs "
            "LayoutLMv3's encoder with both towers; see ROADMAP.md A11. Use a data axis only.")
    rank_device = None if device in ("cuda", None) else device
    if not maybe_initialize_distributed(device=rank_device) or dist.get_world_size() == 1:
        if int(np.prod(shape)) > 1:
            raise ValueError(
                f"mesh_shape {shape} needs one process per device: launch with "
                "python -m torch.distributed.run --nproc-per-node N")
        return (create_mesh((1, 1), device) if dist.is_initialized() else None), device
    if int(np.prod(shape)) == 1:
        shape = default_mesh_shape()
    if rank_device is None:
        rank_device = f"cuda:{os.environ.get('LOCAL_RANK', 0)}"
    mesh = create_mesh(shape, rank_device)
    return mesh, mesh.device


def main(argv: Optional[list] = None) -> Dict[str, float]:
    cfg = parse_cli(argv if argv is not None else sys.argv[1:])
    refuse_ee_trainer(cfg.model)  # before any world, data or model
    owns_world = not dist.is_initialized()
    mesh, device = setup_mesh(cfg)
    try:
        return _train(cfg, mesh, device)
    finally:
        if owns_world and dist.is_initialized():  # the world this call set up
            dist.destroy_process_group()


def step_batch(batch: Dict[str, np.ndarray], accum: int, mesh) -> Dict[str, np.ndarray]:
    """One training step's batch as this rank takes it: the accumulation
    layout ``(accum, micro_bs, ...)``, and under a mesh this rank's rows of
    the micro-batch axis."""
    batch = accumulation_layout(batch, accum)
    return batch if mesh is None else shard_batch(batch, mesh, axis=1)


def _train(cfg: ExperimentConfig, mesh, device) -> Dict[str, float]:
    writer = mesh is None or mesh.rank == 0
    generator = seed_everything(cfg.seed)
    run = init_wandb(cfg.to_dict()) if cfg.use_wandb and writer else None

    name = cfg.dataset
    train_ds = build_dataset(name, "train")
    val_ds = build_dataset(name, "validation")
    test_ds = build_dataset(name, "test")
    if cfg.downsampling:
        train_ds = train_ds.downsample(cfg.downsampling)

    model_cfg, model = build_model(
        cfg, num_labels=train_ds.num_labels,
        num_hidden_layers=None,
        image_size=train_ds.arrays["pixel_values"].shape[-1],
        seq_len=train_ds.arrays["input_ids"].shape[-1],
        generator=generator,
    )
    if mesh is not None:
        model = shard_model(model, mesh, getattr(model_cfg, "backbone", model_cfg)
                            .num_attention_heads)

    accum = max(cfg.gradient_accumulation_steps, 1)
    global_batch = cfg.batch_size * accum
    steps_per_epoch = max(len(train_ds) // global_batch, 1)
    total_steps = steps_per_epoch * cfg.epochs

    args = TrainingArguments(
        learning_rate=cfg.lr,
        num_epochs=cfg.epochs,
        train_batch_size=cfg.batch_size,
        eval_batch_size=cfg.eval_batch_size,
        gradient_accumulation_steps=accum,
        warmup_ratio=cfg.warmup_ratio,
        weight_decay=cfg.weight_decay,
        alpha=cfg.alpha,
        temperature=cfg.temperature,
        gamma=cfg.gamma,
        seed=cfg.seed,
        bf16=cfg.compute_dtype in ("bfloat16", "bf16"),
    )
    trainer = EETrainer(model_cfg, model, args, total_steps, device=device, mesh=mesh)
    manager = CheckpointManager(
        os.path.join(cfg.output_dir, experiment_name(cfg)), keep=3
    )

    def log(message: str, level: str = "info") -> None:
        if writer:
            logger_message(message, level)

    start_epoch = 0
    if cfg.checkpoint and os.path.isdir(cfg.checkpoint):
        # resume: restore the weights (+ epoch counter) of a prior run
        restored, _, _, step = load_checkpoint(cfg.checkpoint, mesh=mesh)
        trainer.model.load_state_dict(restored, strict=True)
        start_epoch = (step or 0) + 1
        log(f"resumed from {cfg.checkpoint} at epoch {start_epoch}")

    log(
        f"Training {cfg.model} on {name}: {cfg.epochs} epochs x "
        f"{steps_per_epoch} steps (global batch {global_batch}) on {trainer.device}"
        + (f", mesh {mesh.shape}" if mesh is not None else "")
    )
    t0 = time.perf_counter()
    # dense baselines (layoutlmv2) have no exit heads
    num_exits = model_cfg.exit.num_exits if hasattr(model_cfg, "exit") else 0
    try:
        for epoch in range(start_epoch, cfg.epochs):
            losses = []
            for batch in iterate_batches(
                train_ds, global_batch, shuffle=True, seed=cfg.seed,
                epoch=epoch, drop_last=True,
            ):
                batch.pop("sample_mask", None)
                loss, _ = trainer.train_step(step_batch(batch, accum, mesh), generator)
                losses.append(loss)
            metrics = trainer.evaluate(
                iterate_batches(val_ds, cfg.eval_batch_size or 8)
            )
            mean_loss = float(np.mean(losses)) if losses else float("nan")
            per_exit = " ".join(
                f"e{j}:acc={metrics[f'exit_{j}_accuracy']:.3f}"
                f"/share={metrics[f'exit_{j}_share']:.3f}"
                for j in range(num_exits)
            )
            log(
                f"epoch {epoch}: loss={mean_loss:.4f} "
                f"val_accuracy={metrics['accuracy']:.4f} {per_exit}"
            )
            dead = [
                j for j in range(num_exits)
                if metrics.get(f"exit_{j}_share", 0.0) < 0.01
            ]
            if dead:
                log(
                    f"epoch {epoch}: exit head(s) {dead} capture <1% of "
                    f"validation traffic at threshold "
                    f"{model_cfg.exit.global_threshold} — dead exits waste "
                    f"compute; consider pruning "
                    f"(evaluation.operating_points.prune_dead_exits)",
                    "warning",
                )
            if run is not None:
                run.log({"epoch": epoch, "loss": mean_loss, **metrics})
            manager.save(
                epoch, trainer.model.state_dict(), config=cfg.to_dict(),
                metric=metrics["accuracy"], mesh=mesh,
            )
    except KeyboardInterrupt:
        # manual stop still proceeds to test evaluation
        # (parity: EE/IC_only.py:210-217)
        log("interrupted — evaluating current model", "warning")

    test_metrics = trainer.evaluate(
        iterate_batches(test_ds, cfg.eval_batch_size or 8)
    )
    log(f"done in {time.perf_counter() - t0:.1f}s; test metrics: {test_metrics}")
    if run is not None:
        run.log({f"test_{k}": v for k, v in test_metrics.items()})
        run.finish()
    return test_metrics if writer else {}


def debug_step(trainer: EETrainer, batch, generator: torch.Generator, n_steps: int = 5) -> list:
    """Tiny overfit harness: n optimizer steps on ONE batch, returning the
    loss trajectory (parity: EE/IC_only.py:40-62 debug_step). The loss must
    drop on a working setup — the quickest smoke test for a new config."""
    return [trainer.train_step(batch, generator)[0] for _ in range(n_steps)]


def experiment_name(cfg: ExperimentConfig) -> str:
    """Run naming (reference: EE/IC_only.py:132-139 + configs.nameit)."""
    exits = cfg.exits if isinstance(cfg.exits, str) else ",".join(
        str(e) for e in cfg.exits
    )
    return (
        f"{cfg.model}_{cfg.dataset.split('/')[-1]}_"
        f"{cfg.training_strategy}_{exits}".replace(",", "-")
    )


if __name__ == "__main__":
    main()
