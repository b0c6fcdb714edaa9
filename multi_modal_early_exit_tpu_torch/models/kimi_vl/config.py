"""Kimi-VL-A3B-Instruct's configuration: MoonViT and its projector in front
of Moonlight's decoder.

The language model is Moonlight-16B-A3B's block at the published
``text_config`` (https://huggingface.co/moonshotai/Kimi-VL-A3B-Instruct),
whose one difference from Moonlight's is ``rope_theta`` 800,000. The
vision tower (``MoonViTConfig``) is a native-resolution ViT: 14 x 14
patches of a page at its own size, 27 pre-norm layers of hidden 1152 (16
heads of 72, a GELU-tanh MLP of 4304, every linear layer with a bias), a
learnable 64 x 64 position table interpolated to each page's grid, 2D
rotary embeddings, and a 2 x 2 merge of neighbouring patches that the
projector (LayerNorm, Linear, GELU, Linear) maps to the decoder's width.
``media_placeholder_token_id`` marks the positions of a sequence that the
page's merged patches replace.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from multi_modal_early_exit_tpu_torch.models.moonlight.config import MoonlightConfig


@dataclasses.dataclass(frozen=True)
class MoonViTConfig:
    patch_size: int = 14
    num_channels: int = 3
    hidden_size: int = 1152
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    intermediate_size: int = 4304
    hidden_act: str = "gelu_pytorch_tanh"
    init_pos_emb_height: int = 64
    init_pos_emb_width: int = 64
    merge_kernel_size: Tuple[int, int] = (2, 2)
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5

    def __post_init__(self):
        object.__setattr__(self, "merge_kernel_size", tuple(self.merge_kernel_size))
        unsupported = {
            "hidden_act": self.hidden_act != "gelu_pytorch_tanh",
            # the 2D rotary embedding turns pairs of a head's dims, a
            # frequency at the column and then at the row
            "hidden_size/num_attention_heads": self.hidden_size % (4 * self.num_attention_heads),
            "merge_kernel_size": len(self.merge_kernel_size) != 2,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(f"MoonViT is built only at its published form; these "
                                      f"keys differ from it: {bad}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def patch_dim(self) -> int:
        """Values in one patch row: channels x patch x patch."""
        return self.num_channels * self.patch_size ** 2

    @property
    def merged(self) -> int:
        """Patches merged into one token."""
        return self.merge_kernel_size[0] * self.merge_kernel_size[1]


@dataclasses.dataclass(frozen=True)
class KimiVLConfig:
    """The language model's config (``text``), the vision tower's
    (``vision``) and the placeholder id. The language model's keys
    (``hidden_size``, ``num_hidden_layers``, ``num_labels``, ...) read
    through to ``text``: the exit heads, the cascade and ``Pipeline`` size
    themselves by the decoder."""

    text: MoonlightConfig = dataclasses.field(
        default_factory=lambda: MoonlightConfig(rope_theta=800000.0,
                                                max_position_embeddings=131072))
    vision: MoonViTConfig = dataclasses.field(default_factory=MoonViTConfig)
    media_placeholder_token_id: int = 163605
    projector_ln_eps: float = 1e-5

    def __post_init__(self):
        if not 0 <= self.media_placeholder_token_id < self.text.vocab_size:
            raise ValueError(f"the placeholder id {self.media_placeholder_token_id} is not a "
                             f"token of the {self.text.vocab_size}-token vocabulary")

    def __getattr__(self, name):
        if name.startswith("_") or name in ("text", "vision"):
            raise AttributeError(name)
        return getattr(self.text, name)

    @classmethod
    def base(cls, num_labels: int = 16) -> "KimiVLConfig":
        """The published model."""
        text = cls().text
        return cls(text=text.replace(num_labels=num_labels))

    @classmethod
    def tiny(cls, num_labels: int = 4) -> "KimiVLConfig":
        """The CPU tests' size: Moonlight's tiny decoder behind a 2-layer
        ViT of hidden 32 (4 heads of 8, MLP 64) on 2 x 2 patches, its
        position table 4 x 4."""
        return cls(text=MoonlightConfig.tiny(num_labels=num_labels),
                   vision=MoonViTConfig(patch_size=2, hidden_size=32, num_hidden_layers=2,
                                        num_attention_heads=4, intermediate_size=64,
                                        init_pos_emb_height=4, init_pos_emb_width=4),
                   media_placeholder_token_id=500)

    def replace(self, **kwargs) -> "KimiVLConfig":
        return dataclasses.replace(self, **kwargs)
