"""Compute-cost analysis: params/FLOPs/latency per exit subgraph and
expected cost under an exit distribution.

Capability parity with ``Analysis`` (reference: EE/analysis.py:11-102) and
``calc_flops`` (EE/eval.py:62-84), with two deliberate upgrades:

- Costs are derived from the model config/param pytree instead of a static
  JSON parameter map + fvcore trace, so they track config changes
  (SURVEY.md §7 step 5). FLOPs use fvcore's convention (1 MAC = 1 FLOP,
  matmul/conv only) so numbers are comparable with the reference's GFLOPs.
- The reference's free-variable-``N`` bug (analysis.py:69 — NameError when
  called outside eval.py's __main__) is fixed: sample count is an explicit
  argument, and the params/FLOPs ratios are N-invariant anyway.

The port's copy of the JAX package's ``evaluation/analysis.py``: the
parameter counts come from the model's ``parameters()`` and the port's
``training/subgraphs.py``; the FLOPs formulas are the JAX module's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import EEModelConfig


def _attention_flops(seq: int, hidden: int) -> float:
    """MACs of one self-attention block at sequence length ``seq``:
    4 projections + 2 batched (S,S,H) contractions."""
    proj = 4 * seq * hidden * hidden
    attn = 2 * seq * seq * hidden
    return proj + attn


def _mlp_flops(seq: int, hidden: int, intermediate: int) -> float:
    return 2 * seq * hidden * intermediate


def encoder_layer_flops(cfg: EEModelConfig, seq: Optional[int] = None) -> float:
    bb = cfg.backbone
    s = seq if seq is not None else 512 + bb.num_visual_tokens
    return _attention_flops(s, bb.hidden_size) + _mlp_flops(
        s, bb.hidden_size, bb.intermediate_size
    )


def embedding_flops(cfg: EEModelConfig, which: str) -> float:
    """MACs to produce one modality's embedding.

    Text embeddings are gathers (0 MACs); the vision path is the patch-embed
    matmul (the reference's Conv2d stride=kernel, LayoutLMv3.py:358-373).
    """
    bb = cfg.backbone
    patch_dim = bb.num_channels * bb.patch_size * bb.patch_size
    vision = (bb.num_visual_tokens - 1) * patch_dim * bb.hidden_size
    if which == "vision":
        return vision
    if which == "text":
        return 0.0
    return vision  # concat path includes the vision matmul


def head_flops(cfg: EEModelConfig, two_layer: bool) -> float:
    bb = cfg.backbone
    f = bb.hidden_size * bb.num_labels
    if two_layer:
        f += bb.hidden_size * bb.hidden_size
    return f


def classifier_flops(cfg: EEModelConfig) -> float:
    bb = cfg.backbone
    return bb.hidden_size * bb.hidden_size + bb.hidden_size * bb.num_labels


class Analysis:
    """Per-exit subgraph params/FLOPs and expected cost under a distribution.

    ``exit_to_params_and_flops`` returns the reference's 6-tuple
    (full_params, expected_params, full_flops, expected_flops,
    full_latency=1, expected_latency) with the same exit-depth latency proxy
    (EE/analysis.py:75-93).
    """

    def __init__(self, model, cfg: EEModelConfig, seq: Optional[int] = None):
        from multi_modal_early_exit_tpu_torch.models.ee.model import canonical_exit_order
        from multi_modal_early_exit_tpu_torch.training.subgraphs import (
            subgraph_param_counts,
        )

        self.cfg = cfg
        bb = cfg.backbone
        self.seq = seq if seq is not None else 512 + bb.num_visual_tokens
        self.order = canonical_exit_order(cfg.exit)
        self.total_params = int(sum(p.numel() for p in model.parameters()))
        self.subgraph_params = subgraph_param_counts(model, cfg)

        # cumulative FLOPs up to (and including) each exit's head
        two_layer = cfg.exit.exit_head_num_layers == 2
        layer_f = encoder_layer_flops(cfg, self.seq)
        head_f = head_flops(cfg, two_layer)
        flops = []
        for e in self.order:
            if isinstance(e, str):
                which = {"vision_avg": "vision", "text_avg": "text"}.get(e, "concat")
                flops.append(embedding_flops(cfg, which) + head_f)
            else:
                flops.append(
                    embedding_flops(cfg, "concat") + e * layer_f + head_f
                )
        self.subgraph_flops = np.asarray(flops, dtype=np.float64)
        self.total_flops = float(
            embedding_flops(cfg, "concat")
            + bb.num_hidden_layers * layer_f
            + classifier_flops(cfg)
        )

    def exit_to_params_and_flops(
        self, exit_distribution: Dict[int, float], n_samples: int = 1
    ) -> Tuple[float, float, float, float, float, float]:
        E = len(self.order)
        dist = np.zeros(E + 1)
        for k, v in exit_distribution.items():
            dist[int(k)] = v

        expected_params = float(
            np.sum(self.subgraph_params * dist[:E]) + dist[E] * self.total_params
        ) * n_samples
        full_params = float(self.total_params) * n_samples

        expected_flops = float(
            np.sum(self.subgraph_flops * dist[:E]) + dist[E] * self.total_flops
        )
        # exit-depth latency proxy (EE/analysis.py:75-79, 92-93)
        depth = (np.arange(E + 1) + 1) / (E + 1)
        expected_latency = float(np.sum(depth * dist))
        return (
            full_params,
            expected_params,
            self.total_flops,
            expected_flops,
            1.0,
            expected_latency,
        )


def calc_flops(
    exit_distribution: Dict[int, float],
    analysis: Analysis,
    config: Dict,
) -> Dict[str, object]:
    """Efficiency log with the reference's key names (EE/eval.py:62-84)."""
    (
        full_params, used_params, full_flops, used_flops, full_lat, used_lat
    ) = analysis.exit_to_params_and_flops(exit_distribution)
    return {
        "#Params(M) used": used_params / 1e6,
        "#Params(M) total": full_params / 1e6,
        "#GFLOPs used": used_flops / 1e9,
        "#GFLOPs total": full_flops / 1e9,
        "GFLOPs reduction": 1 - used_flops / full_flops,
        "Params reduction": 1 - used_params / full_params,
        "Latency reduction": 1 - used_lat / full_lat,
        "exit_distribution": exit_distribution,
        "exit_threshold": config.get("exit_threshold"),
        "epsilon": config.get("epsilon"),
    }


def xla_flops(fn, *example_args) -> Optional[float]:
    """Measured FLOPs of one ``fn(*example_args)`` call, a cross-check of
    the analytic counts: ``utils.profiling.compiled_cost``'s
    ``FlopCounterMode`` count (the JAX package's name; it reads XLA's cost
    analysis there). None when the call fails."""
    from multi_modal_early_exit_tpu_torch.utils.profiling import compiled_cost

    try:
        return compiled_cost(fn, *example_args)["flops"]
    except Exception:  # noqa: BLE001 - a cross-check never fails its caller
        return None
