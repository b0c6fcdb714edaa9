"""Weight bridge between the JAX package's parameter tree and the port.

The JAX tree is nested dicts of arrays (convert with ``jax.tree.map(
np.asarray, params)`` first). The port's modules carry the tree's key names,
so the mapping is mechanical:

- a ``{"kernel": (in, out), "bias"}`` dict is a ``Linear``: weight = kernelᵀ;
- a ``{"scale", "bias"}`` dict is a ``LayerNorm``: weight = scale;
- the stacked subtrees ``layers`` (encoder layers) and ``encoder_exits``
  (one head per encoder exit) carry a leading axis that becomes a
  ``ModuleList`` index;
- every other leaf (embedding tables, [CLS] token, bias tables) maps 1:1,
  including ``embedding_exits`` by name and ``lte``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

STACKED = ("layers", "encoder_exits")


def _leaf(x) -> np.ndarray:
    x = np.asarray(x)
    if x.dtype.kind in "iub":
        return x
    return np.asarray(x, np.float32)  # bf16 trees come out as f32 here


def jax_tree_to_state_dict(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Flatten a JAX parameter tree into the port's state-dict names."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, prefix: str) -> None:
        if not isinstance(node, dict):
            out[prefix[:-1]] = _leaf(node)
            return
        keys = set(node)
        if keys == {"kernel", "bias"}:
            out[prefix + "weight"] = np.swapaxes(_leaf(node["kernel"]), -1, -2)
            out[prefix + "bias"] = _leaf(node["bias"])
            return
        if keys == {"scale", "bias"}:
            out[prefix + "weight"] = _leaf(node["scale"])
            out[prefix + "bias"] = _leaf(node["bias"])
            return
        for key, child in node.items():
            if key in STACKED:
                n = len(next(iter(_leaves(child))))
                for i in range(n):
                    walk(_index(child, i), f"{prefix}{key}.{i}.")
            else:
                walk(child, f"{prefix}{key}.")

    walk(tree, "")
    return out


def _leaves(node):
    if isinstance(node, dict):
        for child in node.values():
            yield from _leaves(child)
    else:
        yield node


def _index(node, i: int):
    if isinstance(node, dict):
        return {k: _index(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def state_dict_to_jax_tree(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``jax_tree_to_state_dict``: f32 numpy leaves."""
    tree: Dict[str, Any] = {}
    for name, value in state.items():
        parts = name.split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value.detach().to("cpu", torch.float32).numpy()

    def fold(node):
        if not isinstance(node, dict):
            return node
        if set(node) == {"weight", "bias"}:
            w = node["weight"]
            if w.ndim == 1:
                return {"scale": w, "bias": node["bias"]}
            return {"kernel": np.swapaxes(w, -1, -2), "bias": node["bias"]}
        folded = {}
        for key, child in node.items():
            if key in STACKED:
                items = [fold(child[str(i)]) for i in range(len(child))]
                folded[key] = _stack(items)
            else:
                folded[key] = fold(child)
        return folded

    return fold(tree)


def _stack(items):
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    return np.stack(items)


def load_jax_params(
    model: nn.Module, tree: Dict[str, Any], dtype: Optional[torch.dtype] = None
) -> nn.Module:
    """Copy a JAX parameter tree into ``model`` (strict: every leaf of the
    tree and every parameter of the model must match), then cast floating
    parameters to ``dtype`` if given. Returns ``model``."""
    state = {k: torch.tensor(v) for k, v in jax_tree_to_state_dict(tree).items()}
    model.load_state_dict(state, strict=True)
    if dtype is not None:
        model.to(dtype=dtype)
    return model


def to_jax_params(model: nn.Module) -> Dict[str, Any]:
    """The model's parameters as a JAX-layout tree of numpy arrays."""
    return state_dict_to_jax_tree(model.state_dict())
