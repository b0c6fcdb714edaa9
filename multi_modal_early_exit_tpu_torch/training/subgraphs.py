"""Per-exit compute-subgraph accounting from the model's parameters: the
counterpart of the JAX package's ``training/subgraphs.py``.

- vision_avg: the visual embedding parameters + its head;
- text_avg: the text embedding parameters + its head;
- text_visual_concat: both modalities + the post-concat LayerNorm + its head;
- encoder exit at layer l: all embeddings + the relative-position bias
  tables + encoder layers 1..l + the heads of all earlier exits + its head;
- the final classifier's branch is the classifier head (for entropyreg).

Parameter names are the port's (``named_parameters``, dotted): encoder
layers and encoder-exit heads are ``ModuleList`` entries, so an exit's names
list exactly its own layers and heads.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from multi_modal_early_exit_tpu_torch.models.ee.model import EEModel, canonical_exit_order
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import EEModelConfig

BIAS_TABLES = ("rel_pos_bias", "rel_pos_x_bias", "rel_pos_y_bias")


def subgraph_param_counts(model: EEModel, cfg: EEModelConfig,
                          numel: Optional[Dict[int, int]] = None) -> np.ndarray:
    """(E,) parameter count of each exit's compute subgraph, canonical order.
    ``numel`` (``id(parameter)`` -> count; ``parallel.sharding.full_numels``
    under a mesh) replaces a parameter's own element count."""
    numel = numel or {}

    def _count(module) -> int:
        if module is None:
            return 0
        params = [module] if isinstance(module, torch.Tensor) else module.parameters()
        return sum(numel.get(id(p), p.numel()) for p in params)

    bb = model.backbone
    text, vision, concat_ln = _count(bb.embeddings), _count(bb.visual), _count(bb.LayerNorm)
    enc = bb.encoder
    tables = sum(_count(getattr(enc, name, None)) for name in BIAS_TABLES)
    counts: List[int] = []
    prior_heads = 0
    enc_heads = iter(model.encoder_exits or ())
    for exit_id in canonical_exit_order(cfg.exit):
        if isinstance(exit_id, int):
            head = _count(next(enc_heads))
            base = (vision + text + concat_ln + tables
                    + sum(_count(layer) for layer in enc.layers[:exit_id]) + prior_heads)
        else:
            head = _count(model.embedding_exits[exit_id])
            base = {"vision_avg": vision, "text_avg": text,
                    "text_visual_concat": vision + text + concat_ln}[exit_id]
        counts.append(base + head)
        prior_heads += head
    return np.asarray(counts, dtype=np.int64)


def exit_loss_weights(counts: np.ndarray, beta: float = 1.0) -> torch.Tensor:
    """Normalised 1/param-count weights, f32."""
    inv = beta / counts.astype(np.float64)
    return torch.tensor(inv / inv.sum(), dtype=torch.float32)


def exit_branch_scales(cfg: EEModelConfig, scales: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Parameter-name prefix -> the entropyreg factor of its branch: each
    exit's head, and the classifier for the final branch (index E)."""
    out: Dict[str, torch.Tensor] = {}
    n_enc = 0
    for j, exit_id in enumerate(canonical_exit_order(cfg.exit)):
        if isinstance(exit_id, int):
            out[f"encoder_exits.{n_enc}."] = scales[j]
            n_enc += 1
        else:
            out[f"embedding_exits.{exit_id}."] = scales[j]
    out["backbone.classifier."] = scales[-1]
    return out


def apply_entropyreg(
    grads: Dict[str, torch.Tensor], cfg: EEModelConfig, scales: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Scale each exit branch's gradients by its (1 - normalised entropy)
    factor. ``scales`` is (E + 1,): one factor per exit in canonical order,
    then the final classifier's. Branch parameters receive gradient only from
    their own loss term, so scaling after the backward is exact."""
    prefixes = exit_branch_scales(cfg, scales)
    out = dict(grads)
    for name, g in grads.items():
        for prefix, s in prefixes.items():
            if name.startswith(prefix):
                out[name] = g * s
    return out


def exit_named_parameters(model: nn.Module, cfg: EEModelConfig) -> Dict[str, List[str]]:
    """Exit -> the names of the parameters of its compute subgraph."""
    names = [n for n, _ in model.named_parameters()]
    bb = "backbone."
    emb = (f"{bb}visual.", f"{bb}embeddings.", f"{bb}LayerNorm.")
    result: Dict[str, List[str]] = {}
    prior_heads: List[str] = []
    n_enc = 0
    for exit_id in canonical_exit_order(cfg.exit):
        if exit_id == "vision_avg":
            own = [n for n in names if n.startswith(f"{bb}visual.")]
        elif exit_id == "text_avg":
            own = [n for n in names if n.startswith(f"{bb}embeddings.")]
        elif exit_id == "text_visual_concat":
            own = [n for n in names if n.startswith(emb)]
        else:
            layers = tuple(f"{bb}encoder.layers.{i}." for i in range(exit_id))
            own = [n for n in names
                   if n.startswith(emb + layers)
                   or n in {f"{bb}encoder.{t}" for t in BIAS_TABLES}]
            own += prior_heads
        prefix = (f"encoder_exits.{n_enc}." if isinstance(exit_id, int)
                  else f"embedding_exits.{exit_id}.")
        n_enc += isinstance(exit_id, int)
        head = [n for n in names if n.startswith(prefix)]
        prior_heads += head
        result[str(exit_id)] = sorted(set(own + head))
    return result
