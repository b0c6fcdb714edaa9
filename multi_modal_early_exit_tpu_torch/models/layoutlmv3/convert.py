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
  including ``embedding_exits`` by name and ``lte``;
- a list (LayoutLMv2's ``stages`` and ``fpn_lateral``) becomes
  ``ModuleList`` indices too.

``convert_torch_state_dict`` is the port's copy of the JAX package's
converter of a HuggingFace LayoutLMv3 state dict into that tree (numpy
leaves), so a pretrained checkpoint reaches the port as
``jax_tree_to_state_dict(convert_torch_state_dict(...))``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

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
        if isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, f"{prefix}{i}.")
            return
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
            elif isinstance(child, dict) and child and all(k.isdigit() for k in child):
                folded[key] = [fold(child[str(i)]) for i in range(len(child))]
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


# ---------------------------------------------------------------------------
# HuggingFace LayoutLMv3 -> the JAX-layout tree (numpy leaves)
# ---------------------------------------------------------------------------


def _t(x) -> np.ndarray:
    """A tensor (or array) as numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _hf_linear(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": _t(sd[f"{prefix}.weight"]).T.copy(), "bias": _t(sd[f"{prefix}.bias"]).copy()}


def _hf_layer_norm(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _t(sd[f"{prefix}.weight"]).copy(), "bias": _t(sd[f"{prefix}.bias"]).copy()}


def convert_torch_state_dict(sd: Mapping[str, Any], cfg, prefix: str = "layoutlmv3.") -> Dict:
    """Map an HF ``LayoutLMv3ForSequenceClassification`` (or bare
    ``LayoutLMv3Model`` with ``prefix=""``) state dict onto the backbone's
    JAX-layout tree, as the JAX package's converter does; ``cfg`` is the
    backbone's ``LayoutLMv3Config``."""
    p = prefix
    emb = f"{p}embeddings."
    embeddings = {
        name: _t(sd[f"{emb}{name}.weight"]).copy()
        for name in ("word_embeddings", "position_embeddings", "token_type_embeddings",
                     "x_position_embeddings", "y_position_embeddings",
                     "h_position_embeddings", "w_position_embeddings")
    }
    embeddings["LayerNorm"] = _hf_layer_norm(sd, f"{emb}LayerNorm")

    # Conv2d (O, C, kh, kw) -> the patch matmul's ((C*kh*kw), O) kernel; the
    # patch extractor flattens in (c, ph, pw) order, which this reshape matches
    conv_w = _t(sd[f"{p}patch_embed.proj.weight"])
    visual = {
        "patch_embed": {"kernel": conv_w.reshape(conv_w.shape[0], -1).T.copy(),
                        "bias": _t(sd[f"{p}patch_embed.proj.bias"]).copy()},
        "cls_token": _t(sd[f"{p}cls_token"]).copy(),
        "pos_embed": _t(sd[f"{p}pos_embed"]).copy(),
        "norm": _hf_layer_norm(sd, f"{p}norm"),
    }

    layers = []
    for i in range(cfg.num_hidden_layers):
        lp = f"{p}encoder.layer.{i}."
        layers.append({
            "attention": {
                "query": _hf_linear(sd, f"{lp}attention.self.query"),
                "key": _hf_linear(sd, f"{lp}attention.self.key"),
                "value": _hf_linear(sd, f"{lp}attention.self.value"),
                "output": _hf_linear(sd, f"{lp}attention.output.dense"),
                "output_LayerNorm": _hf_layer_norm(sd, f"{lp}attention.output.LayerNorm"),
            },
            "intermediate": _hf_linear(sd, f"{lp}intermediate.dense"),
            "output": _hf_linear(sd, f"{lp}output.dense"),
            "output_LayerNorm": _hf_layer_norm(sd, f"{lp}output.LayerNorm"),
        })
    encoder: Dict[str, Any] = {"layers": _stack(layers)}
    if cfg.has_relative_attention_bias:
        encoder["rel_pos_bias"] = _t(sd[f"{p}encoder.rel_pos_bias.weight"]).T.copy()
    if cfg.has_spatial_attention_bias:
        encoder["rel_pos_x_bias"] = _t(sd[f"{p}encoder.rel_pos_x_bias.weight"]).T.copy()
        encoder["rel_pos_y_bias"] = _t(sd[f"{p}encoder.rel_pos_y_bias.weight"]).T.copy()

    params: Dict[str, Any] = {
        "embeddings": embeddings,
        "visual": visual,
        "LayerNorm": _hf_layer_norm(sd, f"{p}LayerNorm"),
        "encoder": encoder,
    }
    if "classifier.dense.weight" in sd:
        params["classifier"] = {"dense": _hf_linear(sd, "classifier.dense"),
                                "out_proj": _hf_linear(sd, "classifier.out_proj")}
    return params
