"""LayoutLMv2 configuration.

The PyTorch port's own copy of the JAX package's
``models/layoutlmv2/config.py``. Parity target: HF ``LayoutLMv2Config``
(microsoft/layoutlmv2-base-uncased), the model the reference builds through
AutoModel (EE/configs.py:451-462). The encoder stack and the relative 1D/2D
attention bias are LayoutLMv3's (v3 inherited them from v2), so the encoder
config is a ``LayoutLMv3Config`` (``encoder_cfg``) with the bias added
unscaled (``scale_bias=False``), and the v3 encoder, bias builder and
attention kernels run it. What differs is modelled in ``modeling.py``: the
visual tower (a ResNeXt-FPN pooled to a 7x7 grid instead of ViT patches),
the visual-grid spatial embeddings and the 3x-hidden concat classifier.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import LayoutLMv3Config


@dataclasses.dataclass(frozen=True)
class LayoutLMv2Config:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    max_2d_position_embeddings: int = 1024
    coordinate_size: int = 128
    shape_size: int = 128
    # relative attention bias (identical semantics to v3)
    has_relative_attention_bias: bool = True
    rel_pos_bins: int = 32
    max_rel_pos: int = 128
    has_spatial_attention_bias: bool = True
    rel_2d_pos_bins: int = 64
    max_rel_2d_pos: int = 256
    has_visual_segment_embedding: bool = False
    # visual tower: ResNeXt-FPN -> adaptive-avg-pool to (7, 7, 256)
    # (HF: image_feature_pool_shape; detectron2 ResNeXt-101 32x8d, out "p2")
    image_feature_pool_shape: Tuple[int, int, int] = (7, 7, 256)
    input_size: int = 224
    backbone_depths: Tuple[int, ...] = (3, 4, 23, 3)  # ResNe(X)t-101
    backbone_groups: int = 32                          # ResNeXt 32x8d
    backbone_width_per_group: int = 8
    backbone_stem_channels: int = 64
    fpn_channels: int = 256
    num_labels: int = 16
    gradient_checkpointing: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_visual_tokens(self) -> int:
        """The pooled grid's tokens (49 for 7x7)."""
        return self.image_feature_pool_shape[0] * self.image_feature_pool_shape[1]

    @classmethod
    def base(cls, num_labels: int = 16) -> "LayoutLMv2Config":
        return cls(num_labels=num_labels)

    @classmethod
    def tiny(cls, num_labels: int = 4) -> "LayoutLMv2Config":
        """2-layer debug config; 32x32 images, 1-block ResNet stages."""
        return cls(
            vocab_size=1024,
            hidden_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            intermediate_size=128,
            max_position_embeddings=130,
            coordinate_size=8,
            shape_size=16,
            rel_pos_bins=8,
            max_rel_pos=32,
            rel_2d_pos_bins=16,
            max_rel_2d_pos=64,
            image_feature_pool_shape=(2, 2, 32),
            input_size=32,
            backbone_depths=(1, 1),
            backbone_groups=1,
            backbone_width_per_group=8,
            backbone_stem_channels=8,
            fpn_channels=32,
            num_labels=num_labels,
        )

    def encoder_cfg(self) -> LayoutLMv3Config:
        """The v3-config view of the (identical) v2 encoder stack, which
        ``layoutlmv3.modeling``'s ``Encoder``, ``encoder_apply`` and
        ``make_attention_bias`` take."""
        return LayoutLMv3Config(
            vocab_size=self.vocab_size,
            hidden_size=self.hidden_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            intermediate_size=self.intermediate_size,
            hidden_dropout_prob=self.hidden_dropout_prob,
            attention_probs_dropout_prob=self.attention_probs_dropout_prob,
            max_position_embeddings=self.max_position_embeddings,
            type_vocab_size=self.type_vocab_size,
            initializer_range=self.initializer_range,
            layer_norm_eps=self.layer_norm_eps,
            pad_token_id=self.pad_token_id,
            max_2d_position_embeddings=self.max_2d_position_embeddings,
            coordinate_size=self.coordinate_size,
            shape_size=self.shape_size,
            has_relative_attention_bias=self.has_relative_attention_bias,
            rel_pos_bins=self.rel_pos_bins,
            max_rel_pos=self.max_rel_pos,
            has_spatial_attention_bias=self.has_spatial_attention_bias,
            rel_2d_pos_bins=self.rel_2d_pos_bins,
            max_rel_2d_pos=self.max_rel_2d_pos,
            scale_bias=False,  # v2 adds the bias unscaled (query pre-scaled)
            num_labels=self.num_labels,
            gradient_checkpointing=self.gradient_checkpointing,
        )

    def replace(self, **kwargs) -> "LayoutLMv2Config":
        return dataclasses.replace(self, **kwargs)
