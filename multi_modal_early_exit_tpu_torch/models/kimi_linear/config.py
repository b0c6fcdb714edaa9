"""Kimi-Linear-48B-A3B-Instruct's configuration (``model_type``
``kimi_linear``).

Field names and defaults are those of the published ``config.json``
(https://huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct): 27 decoder
layers of hidden 2304 in a 3 : 1 pattern of token mixers (``linear_attn_config``,
flattened here: ``kda_layers`` and ``full_attn_layers``, 1-based). Kimi
Delta Attention (KDA), a gated delta rule with a per-channel forget gate, in
32 heads of 128 behind short convolutions of width 4, runs in 20 layers;
multi-head latent attention without rotary embeddings (``mla_use_nope``: 32
heads, q/k 128 + 64, v 128, a 512-wide latent, no query compression) in
layers 4, 8, ..., 24 and 27. Layer 1's MLP is a SwiGLU of 9216; layers 2-27
hold 256 routed experts of 1024 (8 a token, sigmoid scores, renormalised,
scaling 2.446) and one shared. The block is Moonlight's with a new token
mixer, so the fields the two share read through Moonlight's names
(``n_routed_experts``, ``num_experts_per_tok``, ``norm_topk_prob``,
``n_shared_experts``) and its MLA, router and experts run as Moonlight's.

Two fields are the cut, not the published model: ``experts_held`` routed
experts are held on this card, from ``expert_offset`` on (expert
parallelism); the router still scores all ``num_experts``. ``chunk_size``
is the KDA core's chunk. ``num_labels`` and ``classifier_dropout`` belong to
the classifier the early-exit model puts on top.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

KDA_LAYERS = (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23, 25, 26)
FULL_ATTN_LAYERS = (4, 8, 12, 16, 20, 24, 27)


@dataclasses.dataclass(frozen=True)
class KimiLinearConfig:
    vocab_size: int = 163840
    hidden_size: int = 2304
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    num_hidden_layers: int = 27
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    num_experts: int = 256
    num_experts_per_token: int = 8
    num_shared_experts: int = 1
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    moe_renormalize: bool = True
    moe_router_activation_func: str = "sigmoid"
    num_expert_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    mla_use_nope: bool = True
    kda_layers: Tuple[int, ...] = KDA_LAYERS
    full_attn_layers: Tuple[int, ...] = FULL_ATTN_LAYERS
    kda_num_heads: int = 32
    kda_head_dim: int = 128
    short_conv_kernel_size: int = 4
    rms_norm_eps: float = 1e-5
    model_max_length: int = 1048576
    hidden_act: str = "silu"
    initializer_range: float = 0.02
    num_labels: int = 16
    classifier_dropout: float = 0.0
    experts_held: int = 256
    expert_offset: int = 0
    chunk_size: int = 64

    def __post_init__(self):
        for name in ("kda_layers", "full_attn_layers"):
            object.__setattr__(self, name, tuple(getattr(self, name)))
        layers = sorted(self.kda_layers + self.full_attn_layers)
        # the forms this port computes; anything else is another model
        unsupported = {
            "q_lora_rank": self.q_lora_rank is not None,
            "mla_use_nope": not self.mla_use_nope,
            "num_expert_group/topk_group": (self.num_expert_group, self.topk_group) != (1, 1),
            "moe_router_activation_func": self.moe_router_activation_func != "sigmoid",
            "hidden_act": self.hidden_act != "silu",
            "moe_layer_freq": self.moe_layer_freq != 1,
            "num_key_value_heads": self.num_key_value_heads != self.num_attention_heads,
            "kda_layers/full_attn_layers": layers != list(range(1, self.num_hidden_layers + 1)),
            "experts_held/expert_offset": not (
                0 < self.experts_held and 0 <= self.expert_offset
                and self.expert_offset + self.experts_held <= self.num_experts),
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(f"Kimi-Linear's block is built only at its published form; "
                                      f"these keys differ from it: {bad}")

    # Moonlight's names for the fields the two blocks share (and the
    # context length's)
    @property
    def n_routed_experts(self) -> int:
        return self.num_experts

    @property
    def num_experts_per_tok(self) -> int:
        return self.num_experts_per_token

    @property
    def norm_topk_prob(self) -> bool:
        return self.moe_renormalize

    @property
    def n_shared_experts(self) -> int:
        return self.num_shared_experts

    @property
    def max_position_embeddings(self) -> int:
        return self.model_max_length

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def classifier_dropout_prob(self) -> float:
        return self.classifier_dropout

    def is_moe_layer(self, i: int) -> bool:
        """Layer ``i`` (0-based) holds experts."""
        return i >= self.first_k_dense_replace

    def is_kda_layer(self, i: int) -> bool:
        """Layer ``i`` (0-based) mixes its tokens by KDA (else by MLA)."""
        return i + 1 in self.kda_layers

    @classmethod
    def base(cls, num_labels: int = 16, experts_held: int = 128) -> "KimiLinearConfig":
        """The published model, holding ``experts_held`` of its 256 routed
        experts (from 0): the card's share under expert parallelism over 2
        cards a layer."""
        return cls(num_labels=num_labels, experts_held=experts_held)

    @classmethod
    def tiny(cls, num_labels: int = 4) -> "KimiLinearConfig":
        """The CPU tests' size: one whole 3 : 1 period and a KDA layer (5
        layers, MLA in layer 4), hidden 64, KDA in 2 heads of 16 behind
        width-4 convolutions, MLA in 4 heads of nope 16 + rope 8 (values
        16) on a latent of 32, 8 experts of width 32 (2 a token) of which 4
        are held, one shared, KDA chunks of 16."""
        return cls(vocab_size=512, hidden_size=64, intermediate_size=128,
                   moe_intermediate_size=32, num_hidden_layers=5, num_attention_heads=4,
                   num_key_value_heads=4, num_experts=8, num_experts_per_token=2,
                   kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                   kda_layers=(1, 2, 3, 5), full_attn_layers=(4,), kda_num_heads=2,
                   kda_head_dim=16, num_labels=num_labels, experts_held=4, chunk_size=16)

    def replace(self, **kwargs) -> "KimiLinearConfig":
        return dataclasses.replace(self, **kwargs)
