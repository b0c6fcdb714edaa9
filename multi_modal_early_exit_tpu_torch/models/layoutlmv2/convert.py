"""Weights into the port's LayoutLMv2.

- ``load_jax_params`` / ``jax_tree_to_state_dict``: the JAX package's v2
  parameter tree (numpy leaves) into ``LayoutLMv2Model``. The weight bridge
  of ``layoutlmv3.convert`` maps it: the convolution weights are OIHW in
  both packages, the frozen-BN ``scale`` is ``weight``, and the lists
  ``stages`` and ``fpn_lateral`` become ``ModuleList`` indices.
- ``convert_v2_torch_state_dict``: the port's copy of the JAX package's
  converter of a HuggingFace ``LayoutLMv2ForSequenceClassification`` (or
  bare ``LayoutLMv2Model``, ``prefix=""``) state dict into that tree's
  layout: embeddings, encoder with its relative-bias tables,
  ``visual_proj``, ``visual_LayerNorm``, classifier. The detectron2 visual
  tower is not converted (its weights exist only in detectron2-format
  checkpoints), so it keeps its initialization. ``fast_qkv`` is folded
  into q/k/v: q = x Wq + q_bias, k = x Wk (bias 0), v = x Wv + v_bias
  (HF LayoutLMv2SelfAttention.compute_qkv).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from multi_modal_early_exit_tpu_torch.models.layoutlmv2.config import LayoutLMv2Config
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.convert import (
    _hf_layer_norm,
    _hf_linear,
    _stack,
    _t,
    jax_tree_to_state_dict,
    load_jax_params,
)

__all__ = ["convert_v2_torch_state_dict", "jax_tree_to_state_dict", "load_jax_params"]


def convert_v2_torch_state_dict(
    sd: Mapping[str, Any], cfg: LayoutLMv2Config, prefix: str = "layoutlmv2."
) -> Dict[str, Any]:
    """HF state dict -> a partial JAX-layout tree (numpy leaves) of
    everything but the visual tower; merge it over a full tree, or over the
    model's state dict after ``jax_tree_to_state_dict``."""
    p = prefix
    h = cfg.hidden_size
    params: Dict[str, Any] = {}

    emb = f"{p}embeddings."
    if f"{emb}word_embeddings.weight" in sd:
        params["embeddings"] = {
            name: _t(sd[f"{emb}{name}.weight"]).copy()
            for name in ("word_embeddings", "position_embeddings", "token_type_embeddings",
                         "x_position_embeddings", "y_position_embeddings",
                         "h_position_embeddings", "w_position_embeddings")
        }
        params["embeddings"]["LayerNorm"] = _hf_layer_norm(sd, f"{emb}LayerNorm")

    if f"{p}encoder.layer.0.attention.output.dense.weight" not in sd:
        return params

    layers = []
    for i in range(cfg.num_hidden_layers):
        lp = f"{p}encoder.layer.{i}."
        att = f"{lp}attention.self."
        if f"{att}qkv_linear.weight" in sd:
            # fast_qkv: one (3H, H) matrix and q/v biases, chunked q|k|v
            qkv_w = _t(sd[f"{att}qkv_linear.weight"])
            wq, wk, wv = qkv_w[:h], qkv_w[h:2 * h], qkv_w[2 * h:]
            qkv_b = (_t(sd[f"{att}qkv_linear.bias"]) if f"{att}qkv_linear.bias" in sd
                     else np.zeros((3 * h,), qkv_w.dtype))
            q_bias = _t(sd[f"{att}q_bias"]).reshape(-1)  # stored (1, 1, H)
            v_bias = _t(sd[f"{att}v_bias"]).reshape(-1)
            attention = {
                "query": {"kernel": wq.T.copy(), "bias": (qkv_b[:h] + q_bias).copy()},
                "key": {"kernel": wk.T.copy(), "bias": qkv_b[h:2 * h].copy()},
                "value": {"kernel": wv.T.copy(), "bias": (qkv_b[2 * h:] + v_bias).copy()},
            }
        else:
            attention = {name: _hf_linear(sd, f"{att}{name}")
                         for name in ("query", "key", "value")}
        attention["output"] = _hf_linear(sd, f"{lp}attention.output.dense")
        attention["output_LayerNorm"] = _hf_layer_norm(sd, f"{lp}attention.output.LayerNorm")
        layers.append({
            "attention": attention,
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
    params["encoder"] = encoder

    if f"{p}visual_proj.weight" in sd:
        params["visual_proj"] = _hf_linear(sd, f"{p}visual_proj")
    if f"{p}visual_LayerNorm.weight" in sd:
        params["visual_LayerNorm"] = _hf_layer_norm(sd, f"{p}visual_LayerNorm")
    if f"{p}visual_segment_embedding" in sd:
        params["visual_segment_embedding"] = _t(sd[f"{p}visual_segment_embedding"]).copy()
    if "classifier.weight" in sd:
        params["classifier"] = _hf_linear(sd, "classifier")
    return params
