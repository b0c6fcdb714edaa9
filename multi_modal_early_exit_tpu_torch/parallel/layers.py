"""Megatron's tensor-parallel operators: the collectives that XLA inserts
from the JAX package's partition specs, written out by hand.

A column-parallel projection (q/k/v, the MLP's ``intermediate``) holds the
rows of its ``(out, in)`` weight that belong to this rank, so its output is
this rank's slice of the features (its heads). A row-parallel projection
(the attention's and the MLP's ``output``) holds the matching columns, so its
output is a partial sum over the model group. Around them:

- ``copy_to_model``: forward identity, backward all-reduce. On the input of
  every column-parallel projection: each rank's backward gives only its
  slice's share of the input's gradient;
- ``reduce_from_model``: forward all-reduce, backward identity. After every
  row-parallel projection, before its replicated bias is added, so that the
  bias counts once;
- ``vocab_parallel_embedding``: a lookup in a table whose rows are split over
  the model group. Each id falls in one rank's rows; the other ranks add
  exact zeros, so the result is the unsharded lookup bit for bit.

Every operator is the identity (and launches no collective) on a mesh whose
model axis is 1, and so is every helper on a group of one rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from multi_modal_early_exit_tpu_torch.parallel.mesh import Mesh

SEED_STRIDE = 1000003  # the JAX package's per-shard dropout-seed stride


def wrap_int32(x: int) -> int:
    """``x`` wrapped to a signed 32-bit integer, as JAX's int32 arithmetic
    wraps (Python ints do not)."""
    return ((int(x) + 2 ** 31) % 2 ** 32) - 2 ** 31


def shard_seed(seed: int, shard: int) -> int:
    """``seed + shard * 1000003`` in int32 arithmetic
    (``parallel/kernels.py`` of the JAX package)."""
    return wrap_int32(int(seed) + int(shard) * SEED_STRIDE)


def model_parallel(module) -> Optional[Mesh]:
    """The mesh a sharded module carries when its model axis is above 1."""
    mesh = getattr(module, "mesh", None)
    return mesh if mesh is not None and mesh.model_size > 1 else None


def all_reduce(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor); ``x`` itself on a
    group of one rank."""
    if size == 1:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def _flat_collective(tensors: Sequence[torch.Tensor], collective) -> list:
    """``collective`` on one flat buffer per dtype and device of
    ``tensors``; the tensors back, in their shapes."""
    tensors = list(tensors)
    out: list = [None] * len(tensors)
    buckets: Dict[tuple, list] = {}
    for i, t in enumerate(tensors):
        buckets.setdefault((t.dtype, t.device), []).append(i)
    for idx in buckets.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        collective(flat)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def all_reduce_many(tensors: Sequence[torch.Tensor], group, size: int) -> list:
    """Each tensor summed over ``group``, by one all-reduce per dtype and
    device (the tensors flattened into one buffer)."""
    if size == 1:
        return list(tensors)
    return _flat_collective(tensors, lambda flat: dist.all_reduce(flat, group=group))


def broadcast_many(tensors: Sequence[torch.Tensor], src: int, group) -> list:
    """Each tensor as global rank ``src`` of ``group`` holds it, by one
    broadcast per dtype and device."""
    return _flat_collective(tensors, lambda flat: dist.broadcast(flat, src=src, group=group))


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return all_reduce(g, mesh.model_group, mesh.model_size), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, mesh.model_group, mesh.model_size)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Forward identity, backward all-reduce over the model group."""
    if mesh is None or mesh.model_size == 1:
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Forward all-reduce over the model group, backward identity."""
    if mesh is None or mesh.model_size == 1:
        return x
    return _ReduceFromModel.apply(x, mesh)


def column_parallel(lin, x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``lin`` (rows split over the model group) on a replicated input."""
    return lin(copy_to_model(x, mesh))


def row_parallel(lin, x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``lin`` (columns split over the model group) on this rank's features:
    the partial products summed over the group, then the replicated bias.
    Without a model axis, ``lin(x)`` as it was."""
    if mesh is None or mesh.model_size == 1:
        return lin(x)
    return reduce_from_model(F.linear(x, lin.weight), mesh) + lin.bias


def shard_bounds(n: int, size: int, index: int) -> tuple:
    """[start, stop) of shard ``index`` of ``n`` rows split over ``size``
    ranks in chunks of ceil(n / size) (the last chunks may be shorter, or
    empty, when ``size`` does not divide ``n``)."""
    chunk = -(-n // size)
    start = min(index * chunk, n)
    return start, min(start + chunk, n)


def vocab_parallel_embedding(ids: torch.Tensor, table: torch.Tensor, rows: int,
                             mesh: Optional[Mesh]) -> torch.Tensor:
    """``table[ids]`` where ``table`` holds this rank's share of ``rows``
    rows (``shard_bounds``): ids outside it look up row 0 and are zeroed,
    then the model group sums the partial lookups."""
    if mesh is None or mesh.model_size == 1:
        return table[ids]
    start, stop = shard_bounds(rows, mesh.model_size, mesh.model_index)
    ids = ids.long()
    inside = (ids >= start) & (ids < stop)
    local = torch.where(inside, ids - start, torch.zeros_like(ids))
    partial = table[local] * inside[..., None].to(table.dtype)
    return reduce_from_model(partial, mesh)
