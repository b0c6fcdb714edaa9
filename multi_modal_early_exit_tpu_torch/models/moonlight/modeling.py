"""Moonlight-16B-A3B (DeepSeek-V3's block) as the early-exit model's backbone.

The decoder, after the public DeepSeek-V3 modeling code at the published
configuration (``config.MoonlightConfig``):

- pre-norm layers, RMSNorm with f32 moments: ``h = h + attn(norm(h))``, then
  ``h = h + mlp(norm(h))``; a final norm;
- multi-head latent attention with no query compression: q (16 heads of 128
  + 64 rotary dims) from the hidden state; one 512-wide latent and one 64-wide
  rotary key shared by the heads from ``kv_a_proj_with_mqa``; the latent's
  RMSNorm, then ``kv_b_proj`` to each head's 128-wide key part and value;
  rotary embedding on adjacent pairs (2i, 2i + 1) at pos * theta^(-2i/64),
  causal softmax at scale 192^-0.5;
- layer 0's MLP a SwiGLU of width 11264; layers 1-26 a mixture of experts:
  router logits in f32, sigmoid scores, the top 6 by score plus
  ``e_score_correction_bias`` (``noaux_tc`` with one group), weights the
  uncorrected scores of those 6 over their sum, times 2.446; each of the 64
  routed experts and the shared one (2 experts' width, 2816) a SwiGLU.

Each gate and up projection is one (2 F, H) matrix, gate rows first, and
the routed experts' are stacked, (E, 2 F, H) and (E, H, F), so that one
grouped product (``ops.grouped_mm``) runs every expert's tokens. Only the
real tokens of a batch (attention mask 1) enter the MLP sub-layer: they are
gathered into a flat list, in passes of at most ``MLP_TOKENS``, and
scattered back, so padding costs attention and its projections, never
experts. Right padding and
causal attention keep a padded position out of every real token's result.

An expert layer may hold a share of the router's experts (expert
parallelism: ``experts_held`` of them from ``expert_offset`` on, as
Kimi-Linear's configuration is cut): it routes over all of them and
computes its own experts' pairs alone (``experts_apply`` given the share's
``offset``). ``attention_apply`` without rotary tables skips the rotary step
(Kimi-Linear's MLA, ``mla_use_nope``).

Spans (``utils.profiling.span``) sit at sub-layer edges: ``mla.attention``
(the attention core), ``moe.router``, ``moe.experts`` (routed experts:
token sort, both grouped products, the weighted sum) and ``moe.shared``.
Counters: ``moe.tokens`` (real tokens entering an expert layer, each layer
counted) and ``moe.routed_pairs`` (token-expert pairs, 6 a token); both
read sizes the host already holds. Each SwiGLU (layer 0's, the shared and
the routed experts') runs its activation, and the routed experts their
weights and their pairs' sum, through ``ops.moe_pairs``: hand-written
kernels on the card outside autograd (counted in ``launches.swiglu_weigh``
and ``launches.combine_pairs``), the composed ops elsewhere. A cascade
stage's one wait on the card, finding its real tokens, is the span
``sync.real_tokens``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import (
    ClassificationHead,
    RngStream,
    _needs_grad,
    classifier_apply,
    reset_parameters,
)
from multi_modal_early_exit_tpu_torch.models.moonlight.config import MoonlightConfig
from multi_modal_early_exit_tpu_torch.ops import moe_pairs
from multi_modal_early_exit_tpu_torch.ops.causal_attention import causal_attention
from multi_modal_early_exit_tpu_torch.ops.grouped_mm import grouped_mm
from multi_modal_early_exit_tpu_torch.utils import profiling
from multi_modal_early_exit_tpu_torch.utils.profiling import count, span


def _empty(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape))


# ---------------------------------------------------------------------------
# parameter containers (names: the HF checkpoint's, with each gate and up
# projection stacked into one matrix)
# ---------------------------------------------------------------------------


class Proj(nn.Module):
    """y = x W^T, W (out, in), no bias."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = _empty(d_out, d_in)

    def reset_parameters(self, generator: torch.Generator, std: float) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) in f32, cast back to x's dtype, times ``weight``."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return weight * xf.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = _empty(d)

    def reset_parameters(self, generator: torch.Generator, std: float) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class Table(nn.Module):
    """The token embedding, (vocab, hidden)."""

    def __init__(self, n: int, d: int):
        super().__init__()
        self.weight = _empty(n, d)

    def reset_parameters(self, generator: torch.Generator, std: float) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)


class MLP(nn.Module):
    """SwiGLU: down(silu(gate x) * up x), gate and up in one (2 F, H)."""

    def __init__(self, hidden: int, width: int):
        super().__init__()
        self.gate_up_proj = Proj(hidden, 2 * width)
        self.down_proj = Proj(width, hidden)


class Router(nn.Module):
    """The expert scores' (E, H) matrix and the selection's bias (E,)."""

    def __init__(self, n: int, hidden: int):
        super().__init__()
        self.weight = _empty(n, hidden)
        self.e_score_correction_bias = _empty(n)

    def reset_parameters(self, generator: torch.Generator, std: float) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)
            self.e_score_correction_bias.zero_()


class Experts(nn.Module):
    """The routed experts' SwiGLU matrices, stacked: (E, 2 F, H), (E, H, F)."""

    def __init__(self, n: int, hidden: int, width: int):
        super().__init__()
        self.gate_up_proj = _empty(n, 2 * width, hidden)
        self.down_proj = _empty(n, hidden, width)

    def reset_parameters(self, generator: torch.Generator, std: float) -> None:
        with torch.no_grad():
            for p in (self.gate_up_proj, self.down_proj):
                p.normal_(0.0, std, generator=generator)


class MoE(nn.Module):
    """The router over every routed expert, the experts held here
    (``experts_held``: all of them unless the configuration holds a share)
    and the shared experts."""

    def __init__(self, cfg: MoonlightConfig):
        super().__init__()
        h, f = cfg.hidden_size, cfg.moe_intermediate_size
        self.gate = Router(cfg.n_routed_experts, h)
        self.experts = Experts(cfg.experts_held, h, f)
        self.shared_experts = MLP(h, f * cfg.n_shared_experts)


class Attention(nn.Module):
    def __init__(self, cfg: MoonlightConfig):
        super().__init__()
        h, heads = cfg.hidden_size, cfg.num_attention_heads
        self.q_proj = Proj(h, heads * cfg.q_head_dim)
        self.kv_a_proj_with_mqa = Proj(h, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = Proj(cfg.kv_lora_rank, heads * (cfg.qk_nope_head_dim + cfg.v_head_dim))
        self.o_proj = Proj(heads * cfg.v_head_dim, h)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: MoonlightConfig, index: int):
        super().__init__()
        h = cfg.hidden_size
        self.input_layernorm = RMSNorm(h, cfg.rms_norm_eps)
        self.self_attn = Attention(cfg)
        self.post_attention_layernorm = RMSNorm(h, cfg.rms_norm_eps)
        self.mlp = MoE(cfg) if cfg.is_moe_layer(index) else MLP(h, cfg.intermediate_size)


class MoonlightModel(nn.Module):
    """The decoder's parameters and the classifier (dense, tanh, out_proj)
    on the last real token after the final norm, uninitialised, on the
    default device (build under ``torch.device("meta")`` to allocate
    nothing)."""

    def __init__(self, cfg: MoonlightConfig):
        super().__init__()
        self.embed_tokens = Table(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.classifier = ClassificationHead(cfg)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _fused(x: torch.Tensor, *params: torch.Tensor) -> bool:
    """Whether an MLP call runs ``ops.moe_pairs``' kernels: on a CUDA x
    outside autograd (else their plain versions)."""
    return moe_pairs.on_card(x) and not _needs_grad(x, *params)


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU over x (T, H)."""
    fused = _fused(x, p.gate_up_proj.weight, p.down_proj.weight)
    gate_up = p.gate_up_proj(x)
    act = moe_pairs.swiglu_weigh(gate_up)[0] if fused else moe_pairs.swiglu_weigh_plain(gate_up)
    return p.down_proj(act)


def route(p: Router, cfg: MoonlightConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(experts (T, k) int64, weights (T, k) f32) of the tokens x (T, H):
    f32 logits, sigmoid scores, the top k of score + correction bias
    (``torch.topk``'s order and ties), weights from the uncorrected scores,
    normalised over the k when ``norm_topk_prob``, times the scaling."""
    scores = F.linear(x.float(), p.weight.float()).sigmoid()
    chosen = torch.topk(scores + p.e_score_correction_bias.float(), cfg.num_experts_per_tok,
                        dim=-1, sorted=False).indices
    weights = scores.gather(1, chosen)
    if cfg.norm_topk_prob:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    return chosen, weights * cfg.routed_scaling_factor


def experts_apply(p: Experts, x: torch.Tensor, chosen: torch.Tensor,
                  weights: torch.Tensor, offset: Optional[int] = None) -> torch.Tensor:
    """sum_j weights[t, j] expert_{chosen[t, j]}(x[t]), (T, H) summed in f32
    and returned in x's dtype: the token-expert pairs sorted by expert
    (stably; each expert's end found by a search of the sorted ids, so no
    count reaches the host), both SwiGLU products as one grouped product
    each over all experts, each pair's weight applied to its down
    projection's input (the product is linear), the results put back in
    pair order and summed per token. Between and after the products
    ``ops.moe_pairs``: its kernels on the card outside autograd (each pair
    row read and written once a side), else its plain versions.

    With ``offset`` p holds a share of the router's experts, ``offset`` to
    ``offset + E - 1`` (E stacked in p): every pair of an absent expert is
    sorted after the held ones (one key past the last held), so the grouped
    products run the held pairs alone, and ``held``, their count, stays on
    the card; the SwiGLU computes those rows, and each token's sum counts an
    absent pair as zero. The result is this share's part of the layer: the
    shares' parts sum to the whole layer's routed output."""
    k = chosen.shape[1]
    n_held = p.gate_up_proj.shape[0]
    flat = chosen.reshape(-1)
    if offset is not None:
        flat = flat - offset
        flat = torch.where((flat >= 0) & (flat < n_held), flat, n_held)
    order = torch.argsort(flat, stable=True)
    experts = torch.arange(n_held, device=flat.device)
    offs = torch.searchsorted(flat[order], experts, right=True).to(torch.int32)
    held = None if offset is None else offs[-1:]
    fused = _fused(x, p.gate_up_proj, p.down_proj, weights)
    gate_up = grouped_mm(x[order // k], p.gate_up_proj, offs)
    if fused:
        act, inv = moe_pairs.swiglu_weigh(gate_up, weights, order, held)
    else:
        act = moe_pairs.swiglu_weigh_plain(gate_up, weights, order, held)
    del gate_up  # each (pairs, F)-sized buffer lives only as long as it must
    out_sorted = grouped_mm(act, p.down_proj, offs)
    del act
    if fused:
        return moe_pairs.combine_pairs(out_sorted, inv, k, held)
    return moe_pairs.combine_pairs_plain(out_sorted, order, k, held)


def moe_apply(p: MoE, cfg: MoonlightConfig, x: torch.Tensor) -> torch.Tensor:
    """The expert layer over real tokens x (T, H), in x's dtype: the routed
    experts' weighted sum (of the experts held here), then the shared
    experts added."""
    t = x.shape[0]
    count("moe.tokens", t)
    count("moe.routed_pairs", t * cfg.num_experts_per_tok)
    with span("moe.router"):
        chosen, weights = route(p.gate, cfg, x)
    with span("moe.experts"):
        held_all = cfg.experts_held == cfg.n_routed_experts
        y = experts_apply(p.experts, x, chosen, weights, None if held_all else cfg.expert_offset)
    with span("moe.shared"):
        return y + mlp_apply(p.shared_experts, x)


class Rope(NamedTuple):
    cos: torch.Tensor  # (S, d/2)
    sin: torch.Tensor


def rope_tables(cfg: MoonlightConfig, s: int, device, dtype) -> Rope:
    """cos and sin of pos * theta^(-2i/d) for positions 0..s-1, in
    ``dtype`` (HF rounds them to the model's type too)."""
    d = cfg.qk_rope_head_dim
    inv = cfg.rope_theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=device) / d)
    angle = torch.arange(s, dtype=torch.float32, device=device)[:, None] * inv
    return Rope(angle.cos().to(dtype), angle.sin().to(dtype))


def apply_rope(x: torch.Tensor, rope: Rope) -> torch.Tensor:
    """x (B, S, heads, d) with each adjacent pair (2i, 2i + 1) turned by
    its angle. HF's interleaved form also reorders the pairs' halves; q and
    k share the order, so the scores are the same."""
    even, odd = x[..., 0::2], x[..., 1::2]
    cos, sin = rope.cos[:, None, :], rope.sin[:, None, :]
    return torch.stack([even * cos - odd * sin, odd * cos + even * sin], dim=-1).flatten(-2)


def attention_apply(p: Attention, cfg: MoonlightConfig, x: torch.Tensor,
                    rope: Optional[Rope]) -> torch.Tensor:
    """Causal MLA over x (B, S, H); without ``rope`` the rotary dims of q
    and of the shared key go in unturned."""
    b, s, _ = x.shape
    heads, nope, rd, vd = (cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                           cfg.v_head_dim)
    q_nope, q_pe = p.q_proj(x).view(b, s, heads, nope + rd).split([nope, rd], dim=-1)
    latent, k_pe = p.kv_a_proj_with_mqa(x).split([cfg.kv_lora_rank, rd], dim=-1)
    kv = p.kv_b_proj(p.kv_a_layernorm(latent)).view(b, s, heads, nope + vd)
    k_nope, v = kv.split([nope, vd], dim=-1)
    if rope is None:
        q = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)
        k_pe = k_pe.view(b, s, 1, rd).expand(b, s, heads, rd)
    else:  # each turned copy freed before the next is made
        q = torch.cat([q_nope, apply_rope(q_pe, rope)], dim=-1).transpose(1, 2)
        k_pe = apply_rope(k_pe.view(b, s, 1, rd), rope).expand(b, s, heads, rd)
    k = torch.cat([k_nope, k_pe], dim=-1).transpose(1, 2)
    with span("mla.attention"):
        out = causal_attention(q, k, v.transpose(1, 2), cfg.q_head_dim ** -0.5)
    return p.o_proj(out.transpose(1, 2).reshape(b, s, heads * vd))


# The MLP sub-layer's real tokens a pass (32 rows of the shortest document
# served, 512 tokens): its buffers grow with the tokens, the attention
# sub-layer's with the padded rows, so in passes of a fixed size the card's
# memory peak is the same for every batch, whatever its documents' lengths.
MLP_TOKENS = 16384


def layer_apply(p: DecoderLayer, cfg: MoonlightConfig, hidden: torch.Tensor,
                tokens: torch.Tensor, rope: Rope) -> torch.Tensor:
    """One decoder layer over hidden (B, S, H); ``tokens`` are the flat
    indices of its real positions, the only ones the MLP sub-layer runs, in
    passes of ``MLP_TOKENS``. The padded positions keep their attention
    output."""
    hidden = hidden + attention_apply(p.self_attn, cfg, p.input_layernorm(hidden), rope)
    return mlp_sublayer_apply(p, cfg, hidden, tokens)


def mlp_sublayer_apply(p: DecoderLayer, cfg: MoonlightConfig, hidden: torch.Tensor,
                       tokens: torch.Tensor) -> torch.Tensor:
    """A layer's MLP sub-layer, in place on hidden (B, S, H): its norm and
    its MLP or expert layer over the real positions ``tokens`` alone, in
    passes of ``MLP_TOKENS``, each added to its residual."""
    flat = hidden.view(-1, hidden.shape[-1])
    for part in tokens.split(MLP_TOKENS):
        x = flat[part]
        h = p.post_attention_layernorm(x)
        y = moe_apply(p.mlp, cfg, h) if isinstance(p.mlp, MoE) else mlp_apply(p.mlp, h)
        flat.index_copy_(0, part, x + y)
    return hidden


def real_tokens(mask: torch.Tensor) -> torch.Tensor:
    """Flat indices of the positions whose mask is set (one host sync, the
    span ``sync.real_tokens``)."""
    with profiling.sync("real_tokens"):
        return mask.reshape(-1).nonzero().squeeze(1)


def last_token(hidden: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """(B, H): each row's state at its last real position ``last`` (B,)."""
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), last]


def classify(bb: MoonlightModel, cfg: MoonlightConfig, x: torch.Tensor,
             deterministic: bool = True, rngs: Optional[RngStream] = None) -> torch.Tensor:
    """The final classifier on last-token states x (B, H): the final norm,
    then dense, tanh, out_proj."""
    return classifier_apply(bb.classifier, cfg, bb.norm(x), deterministic, rngs)


def embed(bb: MoonlightModel, cfg: MoonlightConfig, input_ids: torch.Tensor,
          attention_mask: torch.Tensor) -> Tuple[torch.Tensor, Rope, torch.Tensor]:
    """(the token embeddings (B, S, H), the rotary tables for S positions,
    each row's last real position (B,))."""
    hidden = F.embedding(input_ids.long(), bb.embed_tokens.weight)
    rope = rope_tables(cfg, hidden.shape[1], hidden.device, hidden.dtype)
    return hidden, rope, attention_mask.sum(dim=1) - 1


def last_token_states(bb: MoonlightModel, cfg: MoonlightConfig, input_ids: torch.Tensor,
                      attention_mask: torch.Tensor) -> List[torch.Tensor]:
    """Every layer's last-real-token state, (B, H) each, the whole batch
    through every layer (the batched forward; the cascade runs stages)."""
    hidden, rope, last = embed(bb, cfg, input_ids, attention_mask)
    return decoder_taps(bb, cfg, hidden, rope, last, attention_mask)


def decoder_taps(bb: MoonlightModel, cfg: MoonlightConfig, hidden: torch.Tensor, rope: Rope,
                 last: torch.Tensor, attention_mask: torch.Tensor) -> List[torch.Tensor]:
    """Every layer's state at ``last`` from input embeddings ``hidden``."""
    tokens = real_tokens(attention_mask)
    taps = []
    for layer in bb.layers:
        hidden = layer_apply(layer, cfg, hidden, tokens, rope)
        taps.append(last_token(hidden, last))
    return taps


class CascadeStages:
    """Moonlight's pieces of the early-exit model (``models.ee``).

    For ``EEModel`` and ``init_ee_params``: the decoder, which reads text
    alone (no embedding exits) and takes ramp heads only, each with an
    RMSNorm of its own; parameters allocated on the device and drawn there.
    For ``ee_forward``: every exit and the classifier read the last real
    token. For the capacity cascade: the state a stage gathers its rows
    from is (hidden, mask, last real position); a stage finds its real
    tokens once (one host sync) for all its layers. That sync sizes the
    stage's work by the data, so the cascade runs these stages op by op,
    never from a CUDA graph."""

    static_shapes = False

    def __init__(self, cfg: MoonlightConfig):
        self.cfg = cfg

    def backbone(self, exit_cfg, with_text: bool = True, with_vision: bool = True):
        """The backbone (``module``) on the default device; refuses the
        exits it cannot serve."""
        if exit_cfg.embedding_exits:
            raise ValueError(f"a Moonlight decoder has no embedding exits, got "
                             f"{exit_cfg.embedding_exits}")
        if exit_cfg.apply_gating or exit_cfg.use_lte:
            raise NotImplementedError("a Moonlight backbone takes ramp exit heads; gate and "
                                      "LTE heads are LayoutLMv3's")
        return self.module()

    def module(self) -> MoonlightModel:
        return MoonlightModel(self.cfg)

    def head_norm(self) -> RMSNorm:
        """The norm an exit head applies first: its own RMSNorm."""
        return RMSNorm(self.cfg.hidden_size, self.cfg.rms_norm_eps)

    def init_model(self, build, generator: torch.Generator, device, dtype):
        """``build("meta")`` allocated on ``device`` in ``dtype`` and drawn
        there, from a generator on that device seeded by the CPU
        ``generator`` (on the CPU, ``generator`` itself)."""
        with torch.device("meta"):
            model = build("meta")
        model = model.to(dtype).to_empty(device=device)
        if device.type != "cpu":
            seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
            generator = torch.Generator(device=device).manual_seed(seed)
        reset_parameters(model, generator, self.cfg.initializer_range)
        return model

    def forward(self, model, order, input_ids, bbox, pixel_values, attention_mask,
                deterministic, rng, collect_hidden, seq_pad_multiple):
        """The batched forward: (each exit's last-token state in ``order``,
        the last layer's, None: no hidden state is kept)."""
        taps = last_token_states(model.backbone, self.cfg, input_ids, attention_mask)
        return [taps[layer - 1] for layer in order], taps[-1], None

    def embed(self, model, input_ids, bbox, pixel_values, attention_mask):
        hidden, rope, last = embed(model.backbone, self.cfg, input_ids, attention_mask)
        return [hidden, attention_mask, last], {}, rope

    def layers(self, model, state, sel, a: int, b: int, rope):
        hidden, mask, last = (t[sel] for t in state)
        tokens = real_tokens(mask)
        for layer in model.backbone.layers[a:b]:
            hidden = layer_apply(layer, self.cfg, hidden, tokens, rope)
        return hidden, (mask, last), last_token(hidden, last)

    def classify(self, model, x, deterministic: bool = True,
                 rngs: Optional[RngStream] = None):
        return classify(model.backbone, self.cfg, x, deterministic, rngs)
