"""Partitioning rules: parameter names -> the dimension split over the model
axis, and the moves between full and sharded state.

The port's copy of the JAX package's ``_spec_for`` (``parallel/
sharding.py``), on the port's parameter names and in ``nn.Linear``'s
``(out, in)`` layout:

- q/k/v and the MLP's ``intermediate``: column parallel, the weight's dim 0
  and the bias;
- the attention's and the MLP's ``output``: row parallel, the weight's dim 1;
  the bias is replicated;
- ``word_embeddings`` and the 2-D ``*position_embeddings``: vocab parallel,
  dim 0;
- everything else is replicated: LayerNorms, the three relative-position
  tables, the visual tower, the exit heads and the classifier.

Heads are contiguous: rank m of the model axis holds heads
``m·H/tp … (m+1)·H/tp − 1``. An embedding's rows split in chunks of
ceil(rows / tp) (``layers.shard_bounds``), the last rank's chunk short, so a
vocabulary of 50265 rows shards over 2 ranks. The JAX package refuses an
odd vocabulary there: its ``P(model, None)`` spec needs the rows to divide
evenly (ROADMAP.md C11).

Torch has no global array: a sharded state dict is this rank's slices, and
``gather_params`` puts the full tensors back together (every rank of the
model group gets them) for a checkpoint. The gathers sum zero-padded
buffers with ``all_reduce``, which every backend takes, on CUDA tensors too.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Mapping, Optional, Sequence

import torch
from torch import nn

from multi_modal_early_exit_tpu_torch.parallel.layers import all_reduce, shard_bounds
from multi_modal_early_exit_tpu_torch.parallel.mesh import Mesh

_LAYER = r"(^|\.)encoder\.layers\.\d+\."
_COLUMN = re.compile(_LAYER + r"(attention\.(query|key|value)|intermediate)\.(weight|bias)$")
_ROW = re.compile(_LAYER + r"(attention\.)?output\.weight$")


def _spec_for(name: str, ndim: int) -> Optional[int]:
    """The dimension of parameter ``name`` split over the model axis, or
    ``None`` when it is replicated."""
    if _COLUMN.search(name):
        return 0
    if _ROW.search(name):
        return 1
    if name.endswith("word_embeddings"):
        return 0
    if name.endswith("position_embeddings") and ndim == 2:
        return 0
    return None


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_partition_specs(params) -> Dict[str, Optional[int]]:
    """Parameter name -> sharded dim (or ``None``), for a module or a state
    dict."""
    return {n: _spec_for(n, p.ndim) for n, p in _named(params).items()}


def _even(name: str, n: int, size: int) -> None:
    if not name.endswith("embeddings") and n % size:
        raise ValueError(f"{name}: {n} features do not split over {size} model ranks")


def shard_params(state_dict: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's slices of a full state dict (copies, contiguous); the
    replicated tensors as they are. The same dict's tensors without a model
    axis."""
    out = dict(state_dict)
    if mesh.model_size == 1:
        return out
    for name, t in state_dict.items():
        dim = _spec_for(name, t.ndim)
        if dim is None:
            continue
        n = t.shape[dim]
        _even(name, n, mesh.model_size)
        start, stop = shard_bounds(n, mesh.model_size, mesh.model_index)
        out[name] = t.narrow(dim, start, stop - start).contiguous().clone()
    return out


def _full_sizes(local: Sequence[torch.Tensor], dims: Sequence[int], mesh: Mesh) -> list:
    """Each sharded tensor's full size along its split dim: the local sizes
    summed over the model group (one all-reduce)."""
    sizes = torch.tensor([t.shape[d] for t, d in zip(local, dims)], dtype=torch.int64,
                         device=mesh.device)
    return all_reduce(sizes, mesh.model_group, mesh.model_size).tolist()


def _gather(t: torch.Tensor, dim: int, full: int, mesh: Mesh) -> torch.Tensor:
    start, stop = shard_bounds(full, mesh.model_size, mesh.model_index)
    shape = list(t.shape)
    shape[dim] = full
    buf = torch.zeros(shape, dtype=t.dtype, device=mesh.device)
    buf.narrow(dim, start, stop - start).copy_(t)
    return all_reduce(buf, mesh.model_group, mesh.model_size).to(t.device)


def gather_params(state_dict: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_params``: the full tensors, on every rank of
    the model group, on each tensor's device. Collective over the model
    group; the state dict itself without a model axis."""
    out = dict(state_dict)
    if mesh.model_size == 1:
        return out
    names = [n for n, t in state_dict.items() if _spec_for(n, t.ndim) is not None]
    dims = [_spec_for(n, state_dict[n].ndim) for n in names]
    fulls = _full_sizes([state_dict[n] for n in names], dims, mesh)
    for name, dim, full in zip(names, dims, fulls):
        out[name] = _gather(state_dict[name].detach(), dim, full, mesh)
    return out


def _moment_keys(state: Mapping[str, Any]) -> Iterable[str]:
    return [k for k, v in state.items() if isinstance(v, torch.Tensor) and v.ndim > 0]


def _need_names(names) -> None:
    if names is None:
        raise ValueError("the optimizer state's parameter names (opt_names) are needed "
                         "to move its moments between a model axis and full shapes")


def gather_optimizer_state(opt_state: Dict[str, Any], names: Sequence[str],
                           mesh: Mesh) -> Dict[str, Any]:
    """``Optimizer.state_dict()`` (``{"adamw": ..., "step": ...}``) with the
    moments of the sharded parameters gathered to their full shapes.
    ``names`` are the optimizer's parameter names, in its order (the
    ``adamw`` state is keyed by that index). Collective over the model
    group."""
    if mesh.model_size == 1:
        return opt_state
    _need_names(names)
    adamw = dict(opt_state["adamw"])
    state = {i: dict(s) for i, s in adamw["state"].items()}
    for i, name in enumerate(names):
        s = state.get(i)
        if s is None:
            continue
        keys = list(_moment_keys(s))
        dim = _spec_for(name, s[keys[0]].ndim) if keys else None
        if dim is None:
            continue
        full = _full_sizes([s[keys[0]]], [dim], mesh)[0]
        for k in keys:
            s[k] = _gather(s[k], dim, full, mesh)
    adamw["state"] = state
    return {**opt_state, "adamw": adamw}


def shard_optimizer_state(opt_state: Dict[str, Any], names: Sequence[str],
                          mesh: Mesh) -> Dict[str, Any]:
    """The inverse of ``gather_optimizer_state``: this rank's slices of the
    moments of the sharded parameters."""
    if mesh.model_size == 1:
        return opt_state
    _need_names(names)
    adamw = dict(opt_state["adamw"])
    state = {}
    for i, s in adamw["state"].items():
        s = dict(s)
        name = names[int(i)]
        for k in _moment_keys(s):
            s[k] = shard_params({name: s[k]}, mesh)[name]
        state[i] = s
    adamw["state"] = state
    return {**opt_state, "adamw": adamw}


def tensor_parallel_model(model: nn.Module) -> bool:
    """Whether ``model`` can split over a model axis above 1: an ``EEModel``
    (or a bare ``LayoutLMv3Model``) with both towers, whose encoder is the
    one the operators of ``parallel/layers.py`` run through."""
    from multi_modal_early_exit_tpu_torch.models.ee.model import EEModel
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import LayoutLMv3Model

    bb = model.backbone if isinstance(model, EEModel) else model
    return (isinstance(bb, LayoutLMv3Model) and bb.embeddings is not None
            and bb.visual is not None)


def shard_model(model: nn.Module, mesh: Mesh, num_heads: Optional[int] = None) -> nn.Module:
    """Shard ``model`` in place over ``mesh``: each split parameter keeps
    only this rank's slice (``shard_params``), and every submodule carries
    the mesh (``module.mesh``), which the forward reads. With a model axis
    above 1 the model must be a LayoutLMv3 model with both towers
    (``NotImplementedError`` names any other), and ``num_heads`` (the
    config's head count) must split over the axis (``ValueError``).
    Returns the model; a model that is already sharded raises
    ``ValueError``."""
    if getattr(model, "mesh", None) is not None:
        raise ValueError(f"{type(model).__name__} is already sharded over {model.mesh.shape}")
    if mesh.model_size > 1:
        if not tensor_parallel_model(model):
            raise NotImplementedError(
                f"{type(model).__name__}: a model axis above 1 needs LayoutLMv3's encoder "
                "with both towers (ROADMAP.md A11); shard this model over the data axis only")
        if num_heads is not None and num_heads % mesh.model_size:
            raise ValueError(f"{num_heads} heads do not split over {mesh.model_size} model ranks")
    named = dict(model.named_parameters())
    local = shard_params({n: p.detach() for n, p in named.items()}, mesh)
    with torch.no_grad():
        for name, p in named.items():
            if local[name].shape != p.shape:
                p.data = local[name]
    for m in model.modules():
        m.mesh = mesh
    return model


def full_numels(model: nn.Module, mesh: Optional[Mesh]) -> Dict[int, int]:
    """``id(parameter)`` -> its unsharded element count: the local counts of
    the split parameters summed over the model group (one all-reduce)."""
    named = dict(model.named_parameters())
    out = {id(p): p.numel() for p in named.values()}
    if mesh is None or mesh.model_size == 1:
        return out
    split = [n for n, p in named.items() if _spec_for(n, p.ndim) is not None]
    counts = torch.tensor([named[n].numel() for n in split], dtype=torch.int64,
                          device=mesh.device)
    for n, c in zip(split, all_reduce(counts, mesh.model_group, mesh.model_size).tolist()):
        out[id(named[n])] = int(c)
    return out


def batch_sharding(mesh: Mesh, batch_size: int) -> slice:
    """The rows of a global batch of ``batch_size`` that this rank's data
    shard holds."""
    if batch_size % mesh.data_size:
        raise ValueError(f"batch {batch_size} does not split over {mesh.data_size} data ranks")
    per = batch_size // mesh.data_size
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def shard_batch(batch: Mapping[str, Any], mesh: Mesh, axis: int = 0) -> Dict[str, Any]:
    """This rank's rows of every array of ``batch`` (numpy arrays or
    tensors, kept as they are), split on ``axis`` over the data axis. The
    accumulation layout ``(accum, micro_bs, ...)`` passes ``axis=1``: the
    micro-batch axis, as the JAX package's ``dryrun_multichip`` shards it
    (``P(None, DATA_AXIS)``), so that each accumulation step spans the data
    shards."""
    out = {}
    for k, v in batch.items():
        if v is None:
            out[k] = v
            continue
        rows = batch_sharding(mesh, v.shape[axis])
        index = (slice(None),) * axis + (rows,)
        out[k] = v[index]
    return out
