"""LayoutLMv3 inference in PyTorch: parameter modules and the forward path.

The counterpart of the JAX package's ``models/layoutlmv3/modeling.py``.
Parameters live in ``nn.Module`` containers whose attribute names follow the
JAX parameter tree (``models/layoutlmv3/convert.py`` maps one onto the
other); the forward path is a set of plain functions over those modules
with the JAX names (``embed_text``, ``encoder_apply``, ``backbone_apply``,
...). Encoder layers are a ``ModuleList`` run in a Python loop.

Attention is one path: ``make_attention_bias`` builds the (B, H, P, P)
relative-position + mask bias once per forward (``ops.materialize_bias``),
and every layer runs ``ops.flash_attention_packed`` on the packed (B, S,
H*D) projections. On CUDA tensors both are the hand-written kernels, on CPU
tensors their plain PyTorch versions. Masked keys carry -1e30 in both. The
QKV, output and MLP projections are ``F.linear``; the patch embedding is an
unfold + matmul, as in the JAX package, not a convolution.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multi_modal_early_exit_tpu_torch.device import resolve_device
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import LayoutLMv3Config
from multi_modal_early_exit_tpu_torch.ops.flash_attention import flash_attention_packed
from multi_modal_early_exit_tpu_torch.ops.fused_bias_attention import materialize_bias

# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def _empty(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape))


class Linear(nn.Module):
    """y = x W^T + b with W (out, in) — the JAX ``kernel`` (in, out) transposed."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = _empty(d_out, d_in)
        self.bias = _empty(d_out)

    def reset_parameters(self, generator: torch.Generator, std: float) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """LayerNorm with f32 two-pass moments; output in x's dtype."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = _empty(d)
        self.bias = _empty(d)

    def reset_parameters(self, generator: torch.Generator, std: float) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


# ---------------------------------------------------------------------------
# parameter containers (attribute names = JAX parameter-tree keys)
# ---------------------------------------------------------------------------


class TextEmbeddings(nn.Module):
    def __init__(self, cfg: LayoutLMv3Config):
        super().__init__()
        self.pad_token_id = cfg.pad_token_id
        h = cfg.hidden_size
        self.word_embeddings = _empty(cfg.vocab_size, h)
        self.position_embeddings = _empty(cfg.max_position_embeddings, h)
        self.token_type_embeddings = _empty(cfg.type_vocab_size, h)
        self.x_position_embeddings = _empty(cfg.max_2d_position_embeddings, cfg.coordinate_size)
        self.y_position_embeddings = _empty(cfg.max_2d_position_embeddings, cfg.coordinate_size)
        self.h_position_embeddings = _empty(cfg.max_2d_position_embeddings, cfg.shape_size)
        self.w_position_embeddings = _empty(cfg.max_2d_position_embeddings, cfg.shape_size)
        self.LayerNorm = LayerNorm(h, cfg.layer_norm_eps)

    def reset_parameters(self, generator: torch.Generator, std: float) -> None:
        with torch.no_grad():
            for p in self._parameters.values():
                p.normal_(0.0, std, generator=generator)
            self.word_embeddings[self.pad_token_id] = 0.0
            self.position_embeddings[self.pad_token_id] = 0.0


class VisualEmbeddings(nn.Module):
    def __init__(self, cfg: LayoutLMv3Config):
        super().__init__()
        h = cfg.hidden_size
        self.patch_embed = Linear(cfg.num_channels * cfg.patch_size ** 2, h)
        self.cls_token = _empty(1, 1, h)
        self.pos_embed = _empty(1, cfg.num_visual_tokens, h)
        self.norm = LayerNorm(h, 1e-6)  # the visual LayerNorm's eps

    def reset_parameters(self, generator: torch.Generator, std: float) -> None:
        with torch.no_grad():
            self.cls_token.zero_()
            self.pos_embed.zero_()


class Attention(nn.Module):
    def __init__(self, cfg: LayoutLMv3Config):
        super().__init__()
        h = cfg.hidden_size
        self.query = Linear(h, h)
        self.key = Linear(h, h)
        self.value = Linear(h, h)
        self.output = Linear(h, h)
        self.output_LayerNorm = LayerNorm(h, cfg.layer_norm_eps)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: LayoutLMv3Config):
        super().__init__()
        self.attention = Attention(cfg)
        self.intermediate = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output = Linear(cfg.intermediate_size, cfg.hidden_size)
        self.output_LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class Encoder(nn.Module):
    def __init__(self, cfg: LayoutLMv3Config):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)
        )
        heads = cfg.num_attention_heads
        if cfg.has_relative_attention_bias:
            self.rel_pos_bias = _empty(cfg.rel_pos_bins, heads)
        if cfg.has_spatial_attention_bias:
            self.rel_pos_x_bias = _empty(cfg.rel_2d_pos_bins, heads)
            self.rel_pos_y_bias = _empty(cfg.rel_2d_pos_bins, heads)

    def reset_parameters(self, generator: torch.Generator, std: float) -> None:
        with torch.no_grad():
            for p in self._parameters.values():
                p.normal_(0.0, std, generator=generator)


class ClassificationHead(nn.Module):
    def __init__(self, cfg: LayoutLMv3Config):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size)
        self.out_proj = Linear(cfg.hidden_size, cfg.num_labels)


class LayoutLMv3Model(nn.Module):
    """The multimodal backbone's parameters (text + vision + encoder +
    classifier), uninitialised, on ``device`` (``cuda`` by default);
    ``init_params`` or ``convert.load_jax_params`` fills them."""

    def __init__(self, cfg: LayoutLMv3Config, device=None):
        super().__init__()
        device = resolve_device(device)
        self.embeddings = TextEmbeddings(cfg)
        self.visual = VisualEmbeddings(cfg)
        # post-concat modality LayerNorm
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.encoder = Encoder(cfg)
        self.classifier = ClassificationHead(cfg)
        self.to(device)


def reset_parameters(module: nn.Module, generator: torch.Generator, std: float) -> None:
    """Fill every parameter of ``module`` in a fixed order: normal(0, std)
    matrices and tables, zero biases, unit LayerNorm scales, zero [CLS] and
    visual position embeddings, zero pad-token rows."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator, std)


def init_params(
    cfg: LayoutLMv3Config,
    generator: Optional[torch.Generator] = None,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> LayoutLMv3Model:
    """Random backbone parameters from a (CPU) ``generator``, with the JAX
    package's shapes and std, moved to ``device`` (``cuda`` by default)."""
    device = resolve_device(device)
    model = LayoutLMv3Model(cfg, device="cpu")
    reset_parameters(model, generator or torch.Generator().manual_seed(0),
                     cfg.initializer_range)
    return model.to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def create_position_ids_from_input_ids(
    input_ids: torch.Tensor, padding_idx: int
) -> torch.Tensor:
    """RoBERTa-style position ids: padding stays at padding_idx, others count up."""
    mask = (input_ids != padding_idx).long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


def spatial_position_embeddings(p: TextEmbeddings, bbox: torch.Tensor) -> torch.Tensor:
    """Concat of left/upper/right/lower coordinate + h/w shape embeddings."""
    bbox = bbox.long()
    left = p.x_position_embeddings[bbox[:, :, 0]]
    upper = p.y_position_embeddings[bbox[:, :, 1]]
    right = p.x_position_embeddings[bbox[:, :, 2]]
    lower = p.y_position_embeddings[bbox[:, :, 3]]
    h = p.h_position_embeddings[torch.clamp(bbox[:, :, 3] - bbox[:, :, 1], 0, 1023)]
    w = p.w_position_embeddings[torch.clamp(bbox[:, :, 2] - bbox[:, :, 0], 0, 1023)]
    return torch.cat([left, upper, right, lower, h, w], dim=-1)


def embed_text(
    p: TextEmbeddings,
    cfg: LayoutLMv3Config,
    input_ids: torch.Tensor,
    bbox: torch.Tensor,
    token_type_ids: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    input_ids = input_ids.long()
    if position_ids is None:
        position_ids = create_position_ids_from_input_ids(input_ids, cfg.pad_token_id)
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    x = p.word_embeddings[input_ids]
    x = x + p.token_type_embeddings[token_type_ids.long()]
    x = x + p.position_embeddings[position_ids.long()]
    x = x + spatial_position_embeddings(p, bbox)
    return p.LayerNorm(x)


def extract_patches(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, h*w, C*patch*patch) with (c, ph, pw) flattening
    order, the layout of a Conv2d(stride=kernel) weight."""
    b, c, h, w = pixel_values.shape
    hp, wp = h // patch, w // patch
    x = pixel_values.reshape(b, c, hp, patch, wp, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)  # (B, hp, wp, C, patch, patch)
    return x.reshape(b, hp * wp, c * patch * patch)


def embed_vision(
    p: VisualEmbeddings, cfg: LayoutLMv3Config, pixel_values: torch.Tensor
) -> torch.Tensor:
    """Patch embedding + [CLS] + learned position embedding + LayerNorm
    (eps 1e-6). Pixels are cast to the parameters' dtype first."""
    patches = extract_patches(
        pixel_values.to(p.patch_embed.weight.dtype), cfg.patch_size
    )
    x = p.patch_embed(patches)  # (B, N, H): unfold + matmul
    cls = p.cls_token.expand(x.shape[0], 1, cfg.hidden_size).to(x.dtype)
    x = torch.cat([cls, x], dim=1)
    x = x + p.pos_embed
    return p.norm(x)


def visual_bbox(cfg: LayoutLMv3Config, device=None, max_len: int = 1000) -> torch.Tensor:
    """(N+1, 4) int32 boxes of the visual patch tokens on the 0-1000 grid,
    with the [CLS] box [1, 1, 999, 999] first; edges use integer division."""
    size = cfg.num_patches_side
    edges = torch.arange(0, max_len * (size + 1), max_len, device=device) // size
    x0 = edges[:-1].repeat(size, 1)
    x1 = edges[1:].repeat(size, 1)
    y0 = x0.T
    y1 = x1.T
    boxes = torch.stack([x0, y0, x1, y1], dim=-1).reshape(-1, 4)
    cls_box = torch.tensor([[1, 1, max_len - 1, max_len - 1]], device=device)
    return torch.cat([cls_box, boxes], dim=0).to(torch.int32)


# ---------------------------------------------------------------------------
# attention bias
# ---------------------------------------------------------------------------


def make_attention_bias(
    p: LayoutLMv3Model,
    cfg: LayoutLMv3Config,
    position_ids: torch.Tensor,
    bbox: torch.Tensor,
    attention_mask: torch.Tensor,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, H, P, P) additive bias: (rel_pos + rel_2d_pos) / sqrt(d) + mask.

    The counterpart of both ``make_attention_bias`` and
    ``kernel_attention_bias`` of the JAX package: one function
    (``ops.materialize_bias``) sums the table lookups in f32 and rounds
    once to ``dtype``, so it serves f32 and bf16 models alike. The 1D bias
    uses ``position_ids`` (a plain arange over text then visual tokens), the
    2D bias x0 = bbox[..., 0] and y1 = bbox[..., 3] (the bucketing,
    ``ops.fused_bias_attention.relative_position_bucket``, is a table
    lookup); masked keys and pad columns carry -1e30. P = ceil(S / 128) *
    128. A config without the relative or spatial bias uses zero tables.
    """
    enc = p.encoder
    heads = cfg.num_attention_heads
    scale = 1.0 / math.sqrt(cfg.head_dim) if cfg.scale_bias else 1.0
    dev = position_ids.device

    def table(name: str, bins: int, present: bool) -> torch.Tensor:
        if not present:
            return torch.zeros((bins, heads), dtype=torch.float32, device=dev)
        return (getattr(enc, name).to(torch.float32) * scale).contiguous()

    def vec(x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.int32).contiguous()

    return materialize_bias(
        vec(position_ids), vec(bbox[:, :, 0]), vec(bbox[:, :, 3]),
        vec(attention_mask),
        table("rel_pos_bias", cfg.rel_pos_bins, cfg.has_relative_attention_bias),
        table("rel_pos_x_bias", cfg.rel_2d_pos_bins, cfg.has_spatial_attention_bias),
        table("rel_pos_y_bias", cfg.rel_2d_pos_bins, cfg.has_spatial_attention_bias),
        rel_bins=cfg.rel_pos_bins, max_rel=cfg.max_rel_pos,
        rel2d_bins=cfg.rel_2d_pos_bins, max_rel2d=cfg.max_rel_2d_pos,
        out_dtype=dtype,
    )


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _attn_epilogue(
    p: Attention, cfg: LayoutLMv3Config, ctx: torch.Tensor, hidden: torch.Tensor
) -> torch.Tensor:
    """Output projection and residual LayerNorm."""
    return p.output_LayerNorm(p.output(ctx) + hidden)


def attention_apply(
    p: Attention, cfg: LayoutLMv3Config, hidden: torch.Tensor, attn_bias: torch.Tensor
) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + bias) v on the packed projections, then the
    epilogue."""
    ctx = flash_attention_packed(
        p.query(hidden), p.key(hidden), p.value(hidden), attn_bias,
        cfg.num_attention_heads,
    ).to(hidden.dtype)
    return _attn_epilogue(p, cfg, ctx, hidden)


def encoder_layer_apply(
    p: EncoderLayer, cfg: LayoutLMv3Config, hidden: torch.Tensor, attn_bias: torch.Tensor
) -> torch.Tensor:
    attn_out = attention_apply(p.attention, cfg, hidden, attn_bias)
    inter = gelu_exact(p.intermediate(attn_out))
    return p.output_LayerNorm(p.output(inter) + attn_out)


def encoder_apply(
    p: Encoder,
    cfg: LayoutLMv3Config,
    hidden: torch.Tensor,
    attn_bias: torch.Tensor,
    collect_cls: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run every layer; returns ``(final_hidden, cls_per_layer)`` where
    ``cls_per_layer`` is (L, B, H): the [CLS] state after each layer, the
    encoder exits' input."""
    taps = []
    for layer in p.layers:
        hidden = encoder_layer_apply(layer, cfg, hidden, attn_bias)
        if collect_cls:
            taps.append(hidden[:, 0, :])
    return hidden, (torch.stack(taps) if collect_cls else None)


def classifier_apply(
    p: ClassificationHead, cfg: LayoutLMv3Config, x: torch.Tensor
) -> torch.Tensor:
    return p.out_proj(torch.tanh(p.dense(x)))


# ---------------------------------------------------------------------------
# full backbone
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BackboneOutput:
    last_hidden_state: torch.Tensor  # (B, S', H), S' = S or the padded width
    cls_per_layer: Optional[torch.Tensor]  # (L, B, H)
    visual_embeddings: torch.Tensor  # (B, Sv, H) pre-concat
    text_embeddings: torch.Tensor  # (B, St, H) pre-concat
    combined_embeddings: torch.Tensor  # (B, S, H) post-LN encoder input


def sequence_layout(
    cfg: LayoutLMv3Config,
    bbox: torch.Tensor,
    attention_mask: torch.Tensor,
    s_v: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Boxes, position ids and mask of the concatenated text + visual
    sequence. The position ids of the relative bias are a plain arange over
    the text tokens, then over the visual tokens (not the RoBERTa ids)."""
    b, s_t = attention_mask.shape
    dev = attention_mask.device
    vis_bbox = visual_bbox(cfg, dev)[None].expand(b, s_v, 4)
    full_bbox = torch.cat([bbox.to(torch.int32), vis_bbox], dim=1)
    pos = torch.cat(
        [torch.arange(s_t, device=dev).expand(b, s_t),
         torch.arange(s_v, device=dev).expand(b, s_v)], dim=1,
    ).to(torch.int32)
    full_mask = torch.cat(
        [attention_mask.to(torch.int32),
         torch.ones((b, s_v), dtype=torch.int32, device=dev)], dim=1,
    )
    return full_bbox, pos, full_mask


def pad_sequence(multiple: int, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Zero-pad dim 1 of each tensor to a multiple of ``multiple``; padded
    positions carry mask 0, so they never influence real tokens."""
    s = tensors[0].shape[1]
    pad = (-s) % multiple
    if not pad:
        return tensors
    return tuple(
        F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) for t in tensors
    )


@torch.no_grad()
def backbone_apply(
    p: LayoutLMv3Model,
    cfg: LayoutLMv3Config,
    input_ids: torch.Tensor,
    bbox: torch.Tensor,
    pixel_values: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    collect_cls: bool = True,
    seq_pad_multiple: Optional[int] = None,
) -> BackboneOutput:
    """The multimodal backbone (inference). ``seq_pad_multiple`` pads the
    concatenated sequence once before the encoder; the bias is always built
    at a width that is a multiple of 128."""
    b, s_t = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, s_t), dtype=torch.int32, device=input_ids.device)
    text_emb = embed_text(p.embeddings, cfg, input_ids, bbox)
    vis_emb = embed_vision(p.visual, cfg, pixel_values)
    combined = p.LayerNorm(torch.cat([text_emb, vis_emb], dim=1))
    full_bbox, pos, full_mask = sequence_layout(
        cfg, bbox, attention_mask, vis_emb.shape[1]
    )
    hidden = combined
    if seq_pad_multiple:
        hidden, full_bbox, pos, full_mask = pad_sequence(
            seq_pad_multiple, hidden, full_bbox, pos, full_mask
        )
    attn_bias = make_attention_bias(
        p, cfg, pos, full_bbox, full_mask, dtype=hidden.dtype
    )
    final, cls_per_layer = encoder_apply(
        p.encoder, cfg, hidden, attn_bias, collect_cls=collect_cls
    )
    return BackboneOutput(
        last_hidden_state=final,
        cls_per_layer=cls_per_layer,
        visual_embeddings=vis_emb,
        text_embeddings=text_emb,
        combined_embeddings=combined,
    )
