"""Early-exit heads: ramps, gates, and learning-to-exit regressors.

An exit head is optionally [dropout -> dense -> tanh]
(``exit_head_num_layers == 2``), then dropout -> out_proj. Its output dim is
num_labels for RAMP/EMBEXIT heads and 2 for GATE heads. A pre-norm
backbone's head (Moonlight's) first normalises its input with a norm of its
own. The LTE head is a 1-unit sigmoid regressor.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multi_modal_early_exit_tpu_torch.config.exit_config import EarlyExitHead, ExitConfig
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import LayoutLMv3Config
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import (
    Linear,
    RngStream,
    dropout,
)


def head_output_dim(backbone: LayoutLMv3Config, exit_cfg: ExitConfig) -> int:
    if exit_cfg.encoder_layer_strategy == EarlyExitHead.GATE:
        return 2
    return backbone.num_labels


class ExitHead(nn.Module):
    def __init__(self, backbone: LayoutLMv3Config, exit_cfg: ExitConfig,
                 norm: Optional[nn.Module] = None):
        super().__init__()
        h = backbone.hidden_size
        self.norm = norm
        self.dense = Linear(h, h) if exit_cfg.exit_head_num_layers == 2 else None
        self.out_proj = Linear(h, head_output_dim(backbone, exit_cfg))


def exit_head_apply(
    p: ExitHead,
    backbone: LayoutLMv3Config,
    x: torch.Tensor,
    deterministic: bool = True,
    rngs: Optional[RngStream] = None,
) -> torch.Tensor:
    """The head's logits; with ``deterministic=False`` its dropouts (classifier
    rate) draw their seeds from ``rngs``."""
    rate = backbone.classifier_dropout_prob
    if p.norm is not None:
        x = p.norm(x)
    if p.dense is not None:
        x = dropout(x, rate, deterministic, rngs.next() if rngs else None)
        x = torch.tanh(p.dense(x))
    x = dropout(x, rate, deterministic, rngs.next() if rngs else None)
    return p.out_proj(x)


def lte_head_apply(p: Linear, x: torch.Tensor) -> torch.Tensor:
    """Sigmoid confidence-to-continue score, squeezed to (B,)."""
    return torch.sigmoid(p(x))[..., 0]
