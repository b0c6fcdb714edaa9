"""The (data, model) device mesh over ``torch.distributed``.

The counterpart of the JAX package's ``parallel/mesh.py``. There the mesh is
one ``jax.sharding.Mesh`` over every device and XLA inserts the collectives.
Here each rank is one process holding one device, and the mesh is what that
process needs to run its part by hand: its place on the two axes and one
process group per axis.

Ranks are laid out data-major, as ``np.asarray(devices).reshape(shape)``
lays out the JAX mesh: ``rank = data_index * model + model_index``. The data
group of a rank is every rank with its model index (they hold the same
parameter shards and different rows); the model group is every rank with its
data index (they hold the same rows and different shards).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from multi_modal_early_exit_tpu_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def default_mesh_shape(n_devices: Optional[int] = None) -> Tuple[int, int]:
    """(data, model) shape: pure data parallelism, ``(n, 1)``. ``n`` is the
    world size when not given (1 without an initialised world)."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    return (n, 1)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a (data, model) mesh. A group is ``None`` when no
    world is initialised (a mesh of one rank); a collective over a group of
    one rank is skipped by the callers, so a (1, 1) mesh computes what no
    mesh computes, bit for bit."""

    shape: Tuple[int, int]
    rank: int
    device: torch.device
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def data_size(self) -> int:
        return self.shape[0]

    @property
    def model_size(self) -> int:
        return self.shape[1]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape[1]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape[1]

    @property
    def shard_index(self) -> int:
        """The linear shard index ``data_index * model + model_index``: the
        rank itself, in the data-major layout."""
        return self.data_index * self.model_size + self.model_index

    def __deepcopy__(self, memo):  # process groups are not copyable: share
        return self


def create_mesh(shape: Optional[Sequence[int]] = None, device=None) -> Mesh:
    """This rank's (data, model) mesh over the initialised world (or over one
    rank without one). Every rank must call it, with the same shape: the axis groups are
    made by ``dist.new_group``, which is collective. ``device`` is this
    rank's device, ``cuda:LOCAL_RANK`` when not given (``LOCAL_RANK`` from
    the environment, 0 without it); it is explicit, never taken from the
    backend, and a CUDA device with no card raises."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    shape = tuple(int(n) for n in (shape if shape is not None else default_mesh_shape(world)))
    if len(shape) != 2 or shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {shape} != #devices {world}")
    if device is None:
        device = f"cuda:{os.environ.get('LOCAL_RANK', 0)}"
    device = resolve_device(device)
    data_group = model_group = None
    if dist.is_initialized():
        data, model = shape
        for m in range(model):  # every rank takes part in every new_group
            g = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                data_group = g
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                model_group = g
    return Mesh(shape, rank, device, data_group, model_group)
