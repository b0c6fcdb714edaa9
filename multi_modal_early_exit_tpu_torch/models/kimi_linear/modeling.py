"""Kimi-Linear-48B-A3B as the early-exit model's backbone: Moonlight's block
(``models.moonlight``) with two kinds of token mixer.

The decoder, after the public Kimi-Linear modeling code at the published
configuration (``config.KimiLinearConfig``): pre-norm layers, ``h = h +
mixer(norm(h))``, then ``h = h + mlp(norm(h))`` (Moonlight's MLP sub-layer:
layer 1's SwiGLU, the others' expert layers over the real tokens alone,
each holding ``experts_held`` of the router's experts); a final norm. The
mixer is one of two kinds:

- MLA (layers 4, 8, ..., 24, 27): Moonlight's ``attention_apply`` without
  its rotary step (``mla_use_nope``: the 64 shared key dims of
  ``kv_a_proj_with_mqa`` go in unturned), causal, scale 192^-0.5;
- KDA (the other 20), over x = norm(h), h heads of d = 128:
  q, k, v = SiLU(causal depthwise convolution of width 4 over positions
  (W_{q,k,v} x)), no bias; q and k each divided per head by their L2 norm
  (x rsqrt(sum x^2 + 1e-6)), q then times d^-1/2; the log forget gate g =
  -exp(A_log[head]) softplus(W_fb W_fa x + dt_bias) per channel and beta =
  sigmoid(W_b x) per head, in f32; the core (``ops.kda``: the gated delta
  rule from a zero state at each row's first position); out = W_o[
  RMSNorm_d(o) w_o_norm sigmoid(W_gb W_ga x) ], the norm per head over d in
  f32.

Rows are right-padded: causality (the convolution's and the recurrence's)
keeps a padded position out of every real one's result. A stage finds its
rows' lengths once (one host sync), which size the KDA core's work, so the
cascade runs these stages op by op, as Moonlight's.

Spans: ``kda.mixer`` (a KDA sub-layer, the projections to ``o_proj``),
``kda.core`` (the core); Moonlight's ``mla.attention`` and ``moe.*``.
Counters: ``kda.tokens`` (real tokens entering a KDA core, each layer
counted), from the lengths the host holds; the core's launches count in
``launches.kda``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multi_modal_early_exit_tpu_torch.models.kimi_linear.config import KimiLinearConfig
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import (
    ClassificationHead,
    RngStream,
)
from multi_modal_early_exit_tpu_torch.models.moonlight import modeling as moon
from multi_modal_early_exit_tpu_torch.ops.kda import gated_rms_norm, kda, kda_gate, short_conv
from multi_modal_early_exit_tpu_torch.utils import profiling
from multi_modal_early_exit_tpu_torch.utils.profiling import count, span

# ---------------------------------------------------------------------------
# parameter containers (names: the HF checkpoint's)
# ---------------------------------------------------------------------------


class ShortConv(nn.Module):
    """A causal depthwise convolution over positions: weight (C, 1, width),
    no bias."""

    def __init__(self, channels: int, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, width))

    def reset_parameters(self, generator: torch.Generator, std: float) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[-1])  # PyTorch's Conv1d default
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)


class KDA(nn.Module):
    """Kimi Delta Attention's parameters: q/k/v projections and their
    convolutions, the forget gate's low-rank projection (``f_a_proj``,
    ``f_b_proj``), ``A_log`` (heads,) and ``dt_bias`` (channels,), beta's
    projection, the output gate's low-rank projection (``g_a_proj``,
    ``g_b_proj``), the per-head output norm and ``o_proj``."""

    def __init__(self, cfg: KimiLinearConfig):
        super().__init__()
        h, heads, d = cfg.hidden_size, cfg.kda_num_heads, cfg.kda_head_dim
        width = heads * d
        self.q_proj = moon.Proj(h, width)
        self.k_proj = moon.Proj(h, width)
        self.v_proj = moon.Proj(h, width)
        self.q_conv1d = ShortConv(width, cfg.short_conv_kernel_size)
        self.k_conv1d = ShortConv(width, cfg.short_conv_kernel_size)
        self.v_conv1d = ShortConv(width, cfg.short_conv_kernel_size)
        self.A_log = nn.Parameter(torch.empty(heads))
        self.dt_bias = nn.Parameter(torch.empty(width))
        self.f_a_proj = moon.Proj(h, d)
        self.f_b_proj = moon.Proj(d, width)
        self.b_proj = moon.Proj(h, heads)
        self.g_a_proj = moon.Proj(h, d)
        self.g_b_proj = moon.Proj(d, width)
        self.o_norm = moon.RMSNorm(d, cfg.rms_norm_eps)
        self.o_proj = moon.Proj(width, h)

    def reset_parameters(self, generator: torch.Generator, std: float) -> None:
        """A_log = log U(1, 16); dt_bias the inverse softplus of a dt
        log-uniform on [1e-3, 1e-1], so that the channels' decays span slow
        and fast ones."""
        with torch.no_grad():
            self.A_log.uniform_(1.0, 16.0, generator=generator).log_()
            dt = self.dt_bias.uniform_(math.log(1e-3), math.log(1e-1), generator=generator).exp_()
            dt.add_(torch.log(-torch.expm1(-dt)))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: KimiLinearConfig, index: int):
        super().__init__()
        h = cfg.hidden_size
        self.input_layernorm = moon.RMSNorm(h, cfg.rms_norm_eps)
        self.self_attn = KDA(cfg) if cfg.is_kda_layer(index) else moon.Attention(cfg)
        self.post_attention_layernorm = moon.RMSNorm(h, cfg.rms_norm_eps)
        self.mlp = moon.MoE(cfg) if cfg.is_moe_layer(index) else moon.MLP(h, cfg.intermediate_size)


class KimiLinearModel(nn.Module):
    """The decoder's parameters and the classifier on the last real token
    after the final norm, uninitialised, on the default device."""

    def __init__(self, cfg: KimiLinearConfig):
        super().__init__()
        self.embed_tokens = moon.Table(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.norm = moon.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.classifier = ClassificationHead(cfg)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def kda_apply(p: KDA, cfg: KimiLinearConfig, x: torch.Tensor, lengths: torch.Tensor,
              lengths_host: Sequence[int]) -> torch.Tensor:
    """A KDA sub-layer over x (B, S, H) (the normed hidden state), rows of
    ``lengths`` real positions (on x's device and on the host). Its
    elementwise steps (the convolutions with SiLU and q's and k's norms,
    the forget gate, the gated output norm) are ``ops.kda``'s, one kernel
    each on the card."""
    b, s, _ = x.shape
    heads, d = cfg.kda_num_heads, cfg.kda_head_dim
    with span("kda.mixer"):
        q = short_conv(p.q_proj(x), p.q_conv1d.weight, d ** -0.5, d).view(b, s, heads, d)
        k = short_conv(p.k_proj(x), p.k_conv1d.weight, 1.0, d).view(b, s, heads, d)
        v = short_conv(p.v_proj(x), p.v_conv1d.weight, None, d).view(b, s, heads, d)
        g = kda_gate(p.f_b_proj(p.f_a_proj(x)), p.A_log, p.dt_bias, d)
        beta = p.b_proj(x).float().sigmoid()
        count("kda.tokens", int(sum(lengths_host)))
        with span("kda.core"):
            o = kda(q, k, v, g, beta, lengths, lengths_host, cfg.chunk_size)
        gate = p.g_b_proj(p.g_a_proj(x))
        out = gated_rms_norm(o, gate, p.o_norm.weight, cfg.rms_norm_eps)
        return p.o_proj(out.view(b, s, heads * d))


def layer_apply(p: DecoderLayer, cfg: KimiLinearConfig, hidden: torch.Tensor,
                tokens: torch.Tensor, lengths: torch.Tensor,
                lengths_host: Sequence[int]) -> torch.Tensor:
    """One decoder layer over hidden (B, S, H): its mixer by its kind, then
    Moonlight's MLP sub-layer over the real positions ``tokens``."""
    x = p.input_layernorm(hidden)
    if isinstance(p.self_attn, KDA):
        hidden = hidden + kda_apply(p.self_attn, cfg, x, lengths, lengths_host)
    else:
        hidden = hidden + moon.attention_apply(p.self_attn, cfg, x, None)
    return moon.mlp_sublayer_apply(p, cfg, hidden, tokens)


def row_lengths(mask: torch.Tensor):
    """(each row's real positions as int32 on the mask's device, the same
    on the host: one host sync, the span ``sync.row_lengths``)."""
    lengths = mask.sum(dim=1, dtype=torch.int32)
    with profiling.sync("row_lengths"):
        return lengths, lengths.tolist()


def embed(bb: KimiLinearModel, input_ids: torch.Tensor, attention_mask: torch.Tensor):
    """(the token embeddings (B, S, H), each row's last real position)."""
    hidden = F.embedding(input_ids.long(), bb.embed_tokens.weight)
    return hidden, attention_mask.sum(dim=1) - 1


def run_layers(bb: KimiLinearModel, cfg: KimiLinearConfig, hidden: torch.Tensor,
               mask: torch.Tensor, last: torch.Tensor, a: int, b: int) -> List[torch.Tensor]:
    """Layers a..b-1 over hidden; each layer's state at ``last``, (B, H)
    each, the final state last of all."""
    tokens = moon.real_tokens(mask)
    lengths, lengths_host = row_lengths(mask)
    taps = []
    for layer in bb.layers[a:b]:
        hidden = layer_apply(layer, cfg, hidden, tokens, lengths, lengths_host)
        taps.append(moon.last_token(hidden, last))
    return taps + [hidden]


def last_token_states(bb: KimiLinearModel, cfg: KimiLinearConfig, input_ids: torch.Tensor,
                      attention_mask: torch.Tensor) -> List[torch.Tensor]:
    """Every layer's last-real-token state, (B, H) each, the whole batch
    through every layer (the batched forward; the cascade runs stages)."""
    hidden, last = embed(bb, input_ids, attention_mask)
    return run_layers(bb, cfg, hidden, attention_mask, last, 0, cfg.num_hidden_layers)[:-1]


class KimiLinearStages(moon.CascadeStages):
    """Kimi-Linear's pieces of the early-exit model: Moonlight's (text alone,
    ramp heads each with its own RMSNorm, the classifier after the final
    norm, the cascade's state (hidden, mask, last real position), op by op)
    with layers that pick their mixer by kind and no rotary tables. No
    mixer state crosses a stage: a classifier runs each layer over the whole
    sequence from a zero state."""

    static_shapes = False

    def module(self) -> KimiLinearModel:
        return KimiLinearModel(self.cfg)

    def forward(self, model, order, input_ids, bbox, pixel_values, attention_mask,
                deterministic, rng, collect_hidden, seq_pad_multiple):
        taps = last_token_states(model.backbone, self.cfg, input_ids, attention_mask)
        return [taps[layer - 1] for layer in order], taps[-1], None

    def embed(self, model, input_ids, bbox, pixel_values, attention_mask):
        hidden, last = embed(model.backbone, input_ids, attention_mask)
        return [hidden, attention_mask, last], {}, None

    def layers(self, model, state, sel, a: int, b: int, carry=None):
        hidden, mask, last = (t[sel] for t in state)
        *_, hidden = run_layers(model.backbone, self.cfg, hidden, mask, last, a, b)
        return hidden, (mask, last), moon.last_token(hidden, last)

    def classify(self, model, x, deterministic: bool = True,
                 rngs: Optional[RngStream] = None):
        return moon.classify(model.backbone, self.cfg, x, deterministic, rngs)
