"""Moonlight-16B-A3B's configuration (``model_type`` ``deepseek_v3``).

Field names and defaults are those of the published ``config.json``
(https://huggingface.co/moonshotai/Moonlight-16B-A3B): 27 decoder layers of
hidden 2048, the first dense (SwiGLU of width 11264), the other 26 with 64
routed experts of width 1408 (6 a token, sigmoid scores, ``noaux_tc``
selection on the bias-corrected scores) and 2 shared ones; multi-head latent
attention with no query compression (``q_lora_rank`` null), a 512-wide
latent and 64 rotary dimensions. ``num_labels`` and ``classifier_dropout``
belong to the classifier the early-exit model puts on top.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig


@dataclasses.dataclass(frozen=True)
class MoonlightConfig:
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    n_group: int = 1
    topk_group: int = 1
    topk_method: str = "noaux_tc"
    scoring_func: str = "sigmoid"
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 50000.0
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    hidden_act: str = "silu"
    attention_bias: bool = False
    initializer_range: float = 0.02
    num_labels: int = 16
    classifier_dropout: float = 0.0

    def __post_init__(self):
        # the forms this port computes; anything else is another model
        unsupported = {
            "q_lora_rank": self.q_lora_rank is not None,
            "n_group/topk_group": (self.n_group, self.topk_group) != (1, 1),
            "topk_method": self.topk_method != "noaux_tc",
            "scoring_func": self.scoring_func != "sigmoid",
            "hidden_act": self.hidden_act != "silu",
            "attention_bias": self.attention_bias,
            "moe_layer_freq": self.moe_layer_freq != 1,
            "num_key_value_heads": self.num_key_value_heads != self.num_attention_heads,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(f"Moonlight's block is built only at its published form; "
                                      f"these keys differ from it: {bad}")

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def experts_held(self) -> int:
        """Routed experts each expert layer holds: every one."""
        return self.n_routed_experts

    @property
    def expert_offset(self) -> int:
        """The router's index of the first expert held."""
        return 0

    @property
    def classifier_dropout_prob(self) -> float:
        return self.classifier_dropout

    def is_moe_layer(self, i: int) -> bool:
        """Layer ``i`` (0-based) holds experts: every layer after the
        first ``first_k_dense_replace``."""
        return i >= self.first_k_dense_replace

    @classmethod
    def base(cls, num_labels: int = 16) -> "MoonlightConfig":
        """The published model."""
        return cls(num_labels=num_labels)

    @classmethod
    def tiny(cls, num_labels: int = 4) -> "MoonlightConfig":
        """The CPU tests' size: hidden 64, 4 heads of nope 16 + rope 8
        (values 16), latent 32, 8 experts of width 32 (2 a token) and one
        shared, 3 layers of which the first is dense."""
        return cls(vocab_size=512, hidden_size=64, intermediate_size=128,
                   moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
                   num_key_value_heads=4, n_routed_experts=8, n_shared_experts=1,
                   num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=16,
                   qk_rope_head_dim=8, v_head_dim=16, max_position_embeddings=256,
                   num_labels=num_labels)

    def replace(self, **kwargs) -> "MoonlightConfig":
        return dataclasses.replace(self, **kwargs)


class MoonlightExitConfig(ExitConfig):
    """An ``ExitConfig`` whose encoder exits may sit after any of
    Moonlight's 27 layers (LayoutLMv3's allow 1-12)."""

    max_exit_layer: ClassVar[int] = 27
