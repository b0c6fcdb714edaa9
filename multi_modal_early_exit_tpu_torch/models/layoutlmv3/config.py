"""LayoutLMv3 model configuration.

The PyTorch port's own copy of the JAX package's
``models/layoutlmv3/config.py``. Field names/defaults track the HuggingFace
``LayoutLMv3Config``; ``base()`` reproduces ``microsoft/layoutlmv3-base``
(12 layers, hidden 768, max_position_embeddings 514 in the released config).
The two scheduling fields, ``gradient_checkpointing`` and ``scan_fold``,
keep the JAX defaults and meanings.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig


@dataclasses.dataclass(frozen=True)
class LayoutLMv3Config:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 514
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    max_2d_position_embeddings: int = 1024
    coordinate_size: int = 128
    shape_size: int = 128
    has_relative_attention_bias: bool = True
    rel_pos_bins: int = 32
    max_rel_pos: int = 128
    rel_2d_pos_bins: int = 64
    max_rel_2d_pos: int = 256
    has_spatial_attention_bias: bool = True
    # v3 adds the relative bias scaled by 1/sqrt(head_dim); v2 adds it
    # unscaled with the query pre-scaled
    scale_bias: bool = True
    text_embed: bool = True
    visual_embed: bool = True
    input_size: int = 224
    num_channels: int = 3
    patch_size: int = 16
    classifier_dropout: Optional[float] = None
    num_labels: int = 16
    # recompute each group of ``scan_fold`` encoder layers in the backward
    # (torch.utils.checkpoint), trading FLOPs for activation memory
    gradient_checkpointing: bool = False
    # layers per encoder step (must divide num_hidden_layers;
    # MMEE_LAYERS_PER_STEP overrides). The port's encoder is a Python loop,
    # so the fold sets only the checkpointed group and, at num_hidden_layers,
    # the chained bias cotangent's default (modeling.use_chained_dbias); it
    # never changes the numbers
    scan_fold: int = 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches_side(self) -> int:
        return self.input_size // self.patch_size

    @property
    def num_visual_tokens(self) -> int:
        # patches + [CLS]  (197 for 224/16)
        return self.num_patches_side * self.num_patches_side + 1

    @property
    def classifier_dropout_prob(self) -> float:
        return (
            self.classifier_dropout
            if self.classifier_dropout is not None
            else self.hidden_dropout_prob
        )

    @classmethod
    def base(cls, num_labels: int = 16) -> "LayoutLMv3Config":
        return cls(num_labels=num_labels)

    @classmethod
    def tiny(cls, num_labels: int = 4) -> "LayoutLMv3Config":
        """Small config for fast tests: 2 layers, hidden 64, 32x32 images."""
        return cls(
            vocab_size=1024,
            hidden_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            intermediate_size=128,
            max_position_embeddings=130,
            # 4*coordinate_size + 2*shape_size must equal hidden_size
            coordinate_size=8,
            shape_size=16,
            rel_pos_bins=8,
            max_rel_pos=32,
            rel_2d_pos_bins=16,
            max_rel_2d_pos=64,
            input_size=32,
            patch_size=16,
            num_labels=num_labels,
        )

    def replace(self, **kwargs) -> "LayoutLMv3Config":
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass(frozen=True)
class EEModelConfig:
    """LayoutLMv3 backbone + early-exit configuration bundle."""

    backbone: LayoutLMv3Config
    exit: ExitConfig

    @property
    def num_exits(self) -> int:
        return self.exit.num_exits

    def replace(self, **kwargs) -> "EEModelConfig":
        return dataclasses.replace(self, **kwargs)
