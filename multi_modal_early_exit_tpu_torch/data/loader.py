"""Batch iteration with static shapes and device prefetch.

The port's copy of the JAX package's ``data/loader.py``, which replaces the
reference's torch DataLoader + collate_fn + CustomTrainer dataloaders
(EE/data/__init__.py:6-60):

- every batch has the same static shape (last partial batch is padded and a
  ``sample_mask`` marks real rows), so the kernels see one shape;
- optional gradient-accumulation layout (accum, micro_bs, ...) matching the
  trainer's steps (training/trainer.py);
- device prefetch one batch ahead: the next batch's copy from pinned host
  memory is enqueued without blocking before the current one is handed out,
  so it overlaps the consumer's work on the card.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from multi_modal_early_exit_tpu_torch.data.datasets import DocClassificationDataset


def iterate_batches(
    dataset: DocClassificationDataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 42,
    drop_last: bool = False,
    pad_final: bool = True,
    epoch: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield dicts of (batch_size, ...) arrays; final short batch is padded
    (rows repeated) with ``sample_mask`` zero on padding."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        order = np.random.default_rng(seed + epoch).permutation(n)
    for start in range(0, n, batch_size):
        idx = order[start : start + batch_size]
        short = len(idx) < batch_size
        if short and drop_last:
            return
        mask = np.ones(batch_size, np.float32)
        if short:
            if not pad_final:
                mask = np.ones(len(idx), np.float32)
            else:
                mask[len(idx):] = 0.0
                idx = np.concatenate(
                    [idx, np.resize(idx, batch_size - len(idx))]
                )
        batch = dataset[idx]
        batch["sample_mask"] = mask
        yield batch


def accumulation_layout(
    batch: Dict[str, np.ndarray], accum_steps: int
) -> Dict[str, np.ndarray]:
    """(accum*micro, ...) -> (accum, micro, ...) for the trainer's scan."""
    def reshape(x):
        micro = x.shape[0] // accum_steps
        return x.reshape((accum_steps, micro) + x.shape[1:])

    return {k: reshape(v) for k, v in batch.items()}


def prefetch_to_device(
    iterator: Iterator[Dict[str, np.ndarray]],
    device,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of numpy arrays as tensors on ``device``, one batch ahead.

    On a CUDA device each array is copied into pinned host memory and sent
    with ``non_blocking=True`` on the current stream, and the next batch is
    enqueued before the current one is yielded, so its transfer overlaps
    the consumer's work (the counterpart of JAX's asynchronous
    ``device_put``); PyTorch's pinned-memory allocator keeps each host
    buffer until the copy from it has run. On the CPU the tensors share the
    arrays' memory (``torch.from_numpy``)."""
    device = torch.device(device)

    def put(batch):
        if device.type != "cuda":
            return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
            device, non_blocking=True) for k, v in batch.items()}

    ahead = None
    for item in iterator:
        nxt = put(item)
        if ahead is not None:
            yield ahead
        ahead = nxt
    if ahead is not None:
        yield ahead
