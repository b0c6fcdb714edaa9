"""Multi-process wiring: ``torch.distributed`` from torchrun's environment.

The counterpart of the JAX package's ``parallel/multihost.py``. A job runs
one process per device (``python -m torch.distributed.run --nproc-per-node N
...``, which sets ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``
and ``LOCAL_RANK``); without those variables nothing is initialised and the
program runs as one process, as the JAX package skips
``jax.distributed.initialize`` without a coordinator.

The backend is chosen once and never swapped: ``nccl`` for CUDA devices,
``gloo`` for the CPU, or the one named by ``MMEE_DIST_BACKEND``.
``MMEE_DIST_BACKEND=gloo`` with ranks on CUDA devices is for one machine
where several ranks share one card: NCCL refuses two ranks on one device,
while gloo moves CUDA tensors through the host for ``all_reduce`` and
``broadcast`` (the only collectives the port uses on CUDA tensors). A failed
initialisation raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from multi_modal_early_exit_tpu_torch.device import resolve_device

TORCHRUN_VARIABLES = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def default_backend(device: torch.device) -> str:
    """``MMEE_DIST_BACKEND`` if set, else ``nccl`` on CUDA and ``gloo`` on
    the CPU."""
    return os.environ.get("MMEE_DIST_BACKEND") or ("nccl" if device.type == "cuda" else "gloo")


def maybe_initialize_distributed(backend: Optional[str] = None, device=None,
                                 timeout: Optional[float] = None) -> bool:
    """Initialise the default process group from torchrun's variables and
    return ``True``; return ``False`` (and do nothing) without them, and
    ``True`` when a world is already initialised. The
    rank's device is ``device``, or ``cuda:LOCAL_RANK``; it becomes the
    current CUDA device. ``backend=None`` takes ``default_backend``.
    ``timeout`` (seconds; ``MMEE_DIST_TIMEOUT`` or 600 when not given)
    bounds every collective, so a rank that hangs fails the job."""
    if dist.is_initialized():  # a world the caller initialised
        return True
    if not all(os.environ.get(k) for k in TORCHRUN_VARIABLES):
        return False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    device = resolve_device(device if device is not None else f"cuda:{local}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if timeout is None:
        timeout = float(os.environ.get("MMEE_DIST_TIMEOUT", 600))
    dist.init_process_group(
        backend or default_backend(device), init_method="env://", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout),
    )
    return True


def process_info() -> Dict[str, int]:
    """This process's place in the job. Each process drives one device."""
    initialised = dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    return {
        "process_index": dist.get_rank() if initialised else 0,
        "process_count": world,
        "local_device_count": 1,
        "global_device_count": world,
    }


def host_batch_slice(global_batch: int, mesh=None) -> slice:
    """The [start, stop) rows of the global batch this process must load:
    by process index, or by data index with a ``mesh`` (the ranks of one
    model group load the same rows)."""
    if mesh is not None:
        index, count = mesh.data_index, mesh.data_size
    else:
        info = process_info()
        index, count = info["process_index"], info["process_count"]
    per = global_batch // count
    return slice(index * per, (index + 1) * per)


def global_batch_from_local(local_batch: Mapping[str, np.ndarray], mesh) -> Dict[str, torch.Tensor]:
    """The batch this rank computes on, from the rows it loaded: torch has
    no global array, so the data-sharded global batch is each rank's rows,
    as tensors on the rank's device."""
    return {k: torch.as_tensor(np.asarray(v)).to(mesh.device) for k, v in local_batch.items()}
