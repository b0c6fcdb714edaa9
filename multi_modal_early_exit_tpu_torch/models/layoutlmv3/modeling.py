"""LayoutLMv3 in PyTorch: parameter modules and the forward path.

The counterpart of the JAX package's ``models/layoutlmv3/modeling.py``.
Parameters live in ``nn.Module`` containers whose attribute names follow the
JAX parameter tree (``models/layoutlmv3/convert.py`` maps one onto the
other); the forward path is a set of plain functions over those modules
with the JAX names (``embed_text``, ``encoder_apply``, ``backbone_apply``,
...). Encoder layers are a ``ModuleList`` run in a Python loop.

``make_attention_bias`` builds the (B, H, P, P) relative-position + mask
bias once per forward (``ops.materialize_bias``, differentiable in the
three tables). Inference (``deterministic`` with autograd off) runs
``ops.flash_attention_packed`` in every layer. Training, or any forward
under autograd, runs the chained ``ops.flash_attention_packed_train_chained``
instead: the bias rides from layer to layer (``ChainedBiasContext``), so each
layer's backward adds its bias cotangent to the running one in the kernel,
and the bias builder's backward (``ops.table_grads``) reduces the total into
the tables once per step. The port has no layer scan, so the encoder is
always fully unrolled, the case in which the JAX package chains by default.
On CUDA tensors the attention and bias ops are the hand-written kernels, on
CPU tensors their plain PyTorch versions. Masked keys carry -1e30.

Two opt-in bias modes, off by default as in the JAX package and switched by
the same environment variables, read at call time:

- ``MMEE_FUSED_BIAS`` (inference only): the layers get a ``FusedBiasContext``
  of the (B, S) vectors and the scaled tables, and
  ``ops.fused_bias_attention`` builds the bias inside the attention kernel,
  so no bias tensor exists;
- ``MMEE_TABLE_GRADS`` (training): the layers get a ``TrainBiasContext``
  with the bias detached, and ``ops.flash_attention_packed_train_tables``
  reduces each layer's bias cotangent straight into the tables' gradients.

Unlike the JAX package, the modes are not gated on the device: on the CPU
the contexts run the plain versions of the two kernels.

Dropout is the position-hash dropout of ``ops.hashing`` with int32 seeds
from an ``RngStream`` over one ``torch.Generator``; LayerNorm and GELU have
the JAX package's hand-written backwards. The QKV, output and MLP
projections are ``F.linear``; the patch embedding is an unfold + matmul, as
in the JAX package, not a convolution.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multi_modal_early_exit_tpu_torch.device import resolve_device
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import LayoutLMv3Config
from multi_modal_early_exit_tpu_torch.ops.flash_attention import (
    flash_attention_packed,
    flash_attention_packed_train_chained,
    flash_attention_packed_train_tables,
)
from multi_modal_early_exit_tpu_torch.ops.fused_bias_attention import (
    fused_bias_attention,
    materialize_bias,
)
from multi_modal_early_exit_tpu_torch.ops.hashing import hash_dropout

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


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _LayerNormCore(torch.autograd.Function):
    """LayerNorm with f32 one-pass moments and a hand-written backward that
    keeps only the input and the (..., S) moments, and recomputes the
    normalised tensor."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float):
        xf = x.to(torch.float32)
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.square().mean(dim=-1, keepdim=True) - mean.square()
        rsig = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
        y = (xf - mean) * rsig
        ctx.save_for_backward(x, mean[..., 0], rsig[..., 0], scale)
        return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, mean, rsig, scale = ctx.saved_tensors
        mean, rsig = mean[..., None], rsig[..., None]
        gf = g.to(torch.float32)
        xhat = (x.to(torch.float32) - mean) * rsig
        dims = tuple(range(x.ndim - 1))
        dscale = (gf * xhat).sum(dim=dims).to(scale.dtype)
        dbias = gf.sum(dim=dims).to(scale.dtype)
        gs = gf * scale.to(torch.float32)
        dx = rsig * (
            gs - gs.mean(dim=-1, keepdim=True)
            - xhat * (gs * xhat).mean(dim=-1, keepdim=True)
        )
        return dx.to(x.dtype), dscale, dbias, None


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """LayerNorm with f32 moments; output in x's dtype. Under autograd it is
    ``_LayerNormCore`` (one-pass moments, hand VJP); otherwise two-pass
    moments, as the JAX package's primal."""
    if _needs_grad(x, weight, bias):
        return _LayerNormCore.apply(x, weight, bias, float(eps))
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


class _GeluExact(torch.autograd.Function):
    """Exact (erf) GELU whose backward keeps only the pre-activation and
    recomputes the two transcendentals."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.gelu(x, approximate="none")

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        xf = x.to(torch.float32)
        cdf = 0.5 * torch.erfc(-xf * (1.0 / math.sqrt(2.0)))
        pdf = torch.exp(-0.5 * xf.square()) * (1.0 / math.sqrt(2.0 * math.pi))
        return (g.to(torch.float32) * (cdf + xf * pdf)).to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU with a recompute backward."""
    if _needs_grad(x):
        return _GeluExact.apply(x)
    return F.gelu(x, approximate="none")


def dropout(
    x: torch.Tensor, rate: float, deterministic: bool, seed: Optional[int]
) -> torch.Tensor:
    """Position-hash dropout (``ops.hashing.hash_dropout``); the identity
    when deterministic, at rate 0 or without a seed."""
    if deterministic or rate == 0.0 or seed is None:
        return x
    return hash_dropout(x, rate, seed)


class RngStream:
    """A stream of int32 dropout seeds drawn from one (CPU)
    ``torch.Generator``; with no generator every seed is ``None``."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator = generator

    def next(self) -> Optional[int]:
        if self.generator is None:
            return None
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.generator))


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
    deterministic: bool = True,
    rngs: Optional[RngStream] = None,
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
    x = p.LayerNorm(x)
    return dropout(x, cfg.hidden_dropout_prob, deterministic,
                   rngs.next() if rngs else None)


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
    return materialize_bias(
        *bias_vectors(position_ids, bbox, attention_mask),
        *bias_tables(p, cfg, position_ids.device), **bucket_kwargs(cfg),
        out_dtype=dtype,
    )


def bias_vectors(position_ids, bbox, attention_mask):
    """(pos, x0, y1, mask): the bias's (B, S) int32 inputs."""
    return tuple(x.to(torch.int32).contiguous()
                 for x in (position_ids, bbox[:, :, 0], bbox[:, :, 3], attention_mask))


def bias_tables(p: LayoutLMv3Model, cfg: LayoutLMv3Config, device):
    """(T1, Tx, Ty) f32 with 1/sqrt(d) folded in (when ``cfg.scale_bias``),
    differentiable in the encoder's tables; zeros for a bias the config
    does not have."""
    enc = p.encoder
    heads = cfg.num_attention_heads
    scale = 1.0 / math.sqrt(cfg.head_dim) if cfg.scale_bias else 1.0

    def table(name: str, bins: int, present: bool) -> torch.Tensor:
        if not present:
            return torch.zeros((bins, heads), dtype=torch.float32, device=device)
        return (getattr(enc, name).to(torch.float32) * scale).contiguous()

    return (
        table("rel_pos_bias", cfg.rel_pos_bins, cfg.has_relative_attention_bias),
        table("rel_pos_x_bias", cfg.rel_2d_pos_bins, cfg.has_spatial_attention_bias),
        table("rel_pos_y_bias", cfg.rel_2d_pos_bins, cfg.has_spatial_attention_bias),
    )


def bucket_kwargs(cfg: LayoutLMv3Config) -> dict:
    return dict(rel_bins=cfg.rel_pos_bins, max_rel=cfg.max_rel_pos,
                rel2d_bins=cfg.rel_2d_pos_bins, max_rel2d=cfg.max_rel_2d_pos)


def _switch(name: str, default: bool) -> bool:
    flag = os.environ.get(name)
    if flag == "0":
        return False
    if flag:
        return True
    return default


def use_table_grad_attention(default: bool = False) -> bool:
    """Training attention with the table gradients in its backward
    (``ops.flash_attention_packed_train_tables``). MMEE_TABLE_GRADS=1 forces
    it on, =0 off; unset (or empty) gives ``default``."""
    return _switch("MMEE_TABLE_GRADS", default)


def use_fused_bias_attention(default: bool = False) -> bool:
    """Inference attention with the bias built in the kernel
    (``ops.fused_bias_attention``). MMEE_FUSED_BIAS=1 forces it on, =0 off;
    unset (or empty) gives ``default``. Not gated on the device."""
    return _switch("MMEE_FUSED_BIAS", default)


def has_both_biases(cfg: LayoutLMv3Config) -> bool:
    """The bias modes need the relative and the spatial tables."""
    return cfg.has_relative_attention_bias and cfg.has_spatial_attention_bias


class FusedBiasContext(NamedTuple):
    """The bias's raw inputs, handed to the encoder in place of the (B, H,
    P, P) tensor: ``ops.fused_bias_attention`` builds it in the kernel."""

    position_ids: torch.Tensor  # (B, S) int32
    cx: torch.Tensor            # (B, S) int32, bbox x0
    cy: torch.Tensor            # (B, S) int32, bbox y1
    mask: torch.Tensor          # (B, S) int32
    t1: torch.Tensor            # (rel_bins, H) f32, 1/sqrt(d) folded
    tx: torch.Tensor            # (rel2d_bins, H)
    ty: torch.Tensor            # (rel2d_bins, H)


class TrainBiasContext(NamedTuple):
    """The training bias for ``ops.flash_attention_packed_train_tables``:
    built once per step and detached; the scaled tables receive its
    gradient from every layer's backward."""

    bias: torch.Tensor          # (B, H, P, P), detached
    position_ids: torch.Tensor  # (B, S) int32
    cx: torch.Tensor            # (B, S) int32
    cy: torch.Tensor            # (B, S) int32
    t1: torch.Tensor            # (rel_bins, H) f32, 1/sqrt(d) folded
    tx: torch.Tensor            # (rel2d_bins, H)
    ty: torch.Tensor            # (rel2d_bins, H)


def fused_bias_context(
    p: LayoutLMv3Model, cfg: LayoutLMv3Config, position_ids: torch.Tensor,
    bbox: torch.Tensor, attention_mask: torch.Tensor,
) -> FusedBiasContext:
    return FusedBiasContext(*bias_vectors(position_ids, bbox, attention_mask),
                            *bias_tables(p, cfg, position_ids.device))


def train_bias_context(
    p: LayoutLMv3Model, cfg: LayoutLMv3Config, position_ids: torch.Tensor,
    bbox: torch.Tensor, attention_mask: torch.Tensor, dtype: torch.dtype,
) -> TrainBiasContext:
    """The bias, detached (``table_grads`` never runs), and the tables that
    receive its gradient."""
    pos, cx, cy, mask = bias_vectors(position_ids, bbox, attention_mask)
    tables = bias_tables(p, cfg, position_ids.device)
    with torch.no_grad():
        bias = materialize_bias(pos, cx, cy, mask, *tables, **bucket_kwargs(cfg),
                                out_dtype=dtype)
    return TrainBiasContext(bias, pos, cx, cy, *tables)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


class ChainedBiasContext(NamedTuple):
    """Training-path marker: the (B, H, P, P) bias rides from layer to
    layer through ``flash_attention_packed_train_chained``, so each layer's
    backward adds its bias cotangent to the running one in the kernel."""

    bias: torch.Tensor


def _packed_qkv_and_seed(
    p: Attention, cfg: LayoutLMv3Config, hidden: torch.Tensor,
    deterministic: bool, seed_attn: Optional[int],
):
    """Packed (B, S, hidden) q/k/v and the attention dropout (rate, seed);
    the rate is 0 when deterministic or without a seed."""
    rate = 0.0 if deterministic or seed_attn is None else cfg.attention_probs_dropout_prob
    seed = seed_attn if rate > 0.0 else 0
    return p.query(hidden), p.key(hidden), p.value(hidden), rate, seed


def _attn_epilogue(
    p: Attention, cfg: LayoutLMv3Config, ctx: torch.Tensor, hidden: torch.Tensor,
    deterministic: bool = True, seed_out: Optional[int] = None,
) -> torch.Tensor:
    """Output projection, dropout and residual LayerNorm."""
    out = dropout(p.output(ctx), cfg.hidden_dropout_prob, deterministic, seed_out)
    return p.output_LayerNorm(out + hidden)


def attention_apply(
    p: Attention,
    cfg: LayoutLMv3Config,
    hidden: torch.Tensor,
    attn_bias,
    deterministic: bool = True,
    seed_attn: Optional[int] = None,
    seed_out: Optional[int] = None,
):
    """softmax(q k^T / sqrt(d) + bias) v on the packed projections, then the
    epilogue. The bias is a (B, H, P, P) tensor (inference) or a context:
    with a ``ChainedBiasContext`` (training) it returns ``(out,
    ChainedBiasContext(bias passed through))``; a ``TrainBiasContext``
    (training) runs the table-gradient attention, a ``FusedBiasContext``
    (inference) the attention that builds the bias in the kernel."""
    heads = cfg.num_attention_heads
    if isinstance(attn_bias, ChainedBiasContext):
        qp, kp, vp, rate, seed = _packed_qkv_and_seed(p, cfg, hidden, deterministic, seed_attn)
        ctx, bias_out = flash_attention_packed_train_chained(
            qp, kp, vp, attn_bias.bias, seed, heads, rate=rate,
        )
        out = _attn_epilogue(p, cfg, ctx.to(hidden.dtype), hidden, deterministic, seed_out)
        return out, ChainedBiasContext(bias_out)
    if isinstance(attn_bias, TrainBiasContext):
        qp, kp, vp, rate, seed = _packed_qkv_and_seed(p, cfg, hidden, deterministic, seed_attn)
        c = attn_bias
        ctx = flash_attention_packed_train_tables(
            qp, kp, vp, c.bias, c.t1, c.tx, c.ty, c.position_ids, c.cx, c.cy, seed,
            heads, rate=rate, **bucket_kwargs(cfg),
        )
        return _attn_epilogue(p, cfg, ctx.to(hidden.dtype), hidden, deterministic, seed_out)
    if not isinstance(attn_bias, FusedBiasContext):
        ctx = flash_attention_packed(
            p.query(hidden), p.key(hidden), p.value(hidden), attn_bias, heads,
        ).to(hidden.dtype)
        return _attn_epilogue(p, cfg, ctx, hidden)
    b, s, width = hidden.shape

    def split(x):  # (B, S, H*D) -> a (B, H, S, D) view, no copy
        return x.view(b, s, heads, cfg.head_dim).transpose(1, 2)

    c = attn_bias
    ctx = fused_bias_attention(
        split(p.query(hidden)), split(p.key(hidden)), split(p.value(hidden)),
        c.position_ids, c.cx, c.cy, c.mask, c.t1, c.tx, c.ty, **bucket_kwargs(cfg),
    )
    # the kernel writes q's layout, so this is a view of (B, S, H, D)
    ctx = ctx.transpose(1, 2).reshape(b, s, width).to(hidden.dtype)
    return _attn_epilogue(p, cfg, ctx, hidden)


def encoder_layer_apply(
    p: EncoderLayer,
    cfg: LayoutLMv3Config,
    hidden: torch.Tensor,
    attn_bias,
    deterministic: bool = True,
    seeds: Optional[Tuple[Optional[int], ...]] = None,
):
    """One layer; ``seeds`` are the (attention, attention-output, MLP-output)
    dropout seeds. Returns ``(out, ChainedBiasContext)`` when chained."""
    r = seeds or (None, None, None)
    attn_out = attention_apply(p.attention, cfg, hidden, attn_bias, deterministic, r[0], r[1])
    chained = None
    if isinstance(attn_bias, ChainedBiasContext):
        attn_out, chained = attn_out
    inter = gelu_exact(p.intermediate(attn_out))
    out = dropout(p.output(inter), cfg.hidden_dropout_prob, deterministic, r[2])
    out = p.output_LayerNorm(out + attn_out)
    return out if chained is None else (out, chained)


def encoder_apply(
    p: Encoder,
    cfg: LayoutLMv3Config,
    hidden: torch.Tensor,
    attn_bias,
    collect_cls: bool = True,
    deterministic: bool = True,
    rng: Optional[RngStream] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run every layer; returns ``(final_hidden, cls_per_layer)`` where
    ``cls_per_layer`` is (L, B, H): the [CLS] state after each layer, the
    encoder exits' input. A ``ChainedBiasContext`` is carried from each
    layer to the next; each layer draws three dropout seeds from ``rng``."""
    taps = []
    for layer in p.layers:
        seeds = (rng.next(), rng.next(), rng.next()) if rng else None
        out = encoder_layer_apply(layer, cfg, hidden, attn_bias, deterministic, seeds)
        if isinstance(attn_bias, ChainedBiasContext):
            hidden, attn_bias = out
        else:
            hidden = out
        if collect_cls:
            taps.append(hidden[:, 0, :])
    return hidden, (torch.stack(taps) if collect_cls else None)


def classifier_apply(
    p: ClassificationHead,
    cfg: LayoutLMv3Config,
    x: torch.Tensor,
    deterministic: bool = True,
    rngs: Optional[RngStream] = None,
) -> torch.Tensor:
    rate = cfg.classifier_dropout_prob
    x = dropout(x, rate, deterministic, rngs.next() if rngs else None)
    x = torch.tanh(p.dense(x))
    x = dropout(x, rate, deterministic, rngs.next() if rngs else None)
    return p.out_proj(x)


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


def backbone_apply(
    p: LayoutLMv3Model,
    cfg: LayoutLMv3Config,
    input_ids: torch.Tensor,
    bbox: torch.Tensor,
    pixel_values: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    rng: Optional[torch.Generator] = None,
    collect_cls: bool = True,
    seq_pad_multiple: Optional[int] = None,
) -> BackboneOutput:
    """The multimodal backbone. ``seq_pad_multiple`` pads the concatenated
    sequence once before the encoder; the bias is always built at a width
    that is a multiple of 128. With ``deterministic=False`` the dropout
    seeds come from ``rng``. Inference callers run it under
    ``torch.no_grad()``: under autograd (or when not deterministic) the
    encoder takes the chained training attention, which has a backward, or
    with ``MMEE_TABLE_GRADS=1`` the table-gradient attention. Inference with
    ``MMEE_FUSED_BIAS=1`` builds no bias tensor; the fused attention has no
    backward, so it is never taken under autograd."""
    rngs = RngStream(None if deterministic else rng)
    b, s_t = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, s_t), dtype=torch.int32, device=input_ids.device)
    text_emb = embed_text(p.embeddings, cfg, input_ids, bbox,
                          deterministic=deterministic, rngs=rngs)
    vis_emb = embed_vision(p.visual, cfg, pixel_values)
    combined = p.LayerNorm(torch.cat([text_emb, vis_emb], dim=1))
    combined = dropout(combined, cfg.hidden_dropout_prob, deterministic, rngs.next())
    full_bbox, pos, full_mask = sequence_layout(
        cfg, bbox, attention_mask, vis_emb.shape[1]
    )
    hidden = combined
    if seq_pad_multiple:
        hidden, full_bbox, pos, full_mask = pad_sequence(
            seq_pad_multiple, hidden, full_bbox, pos, full_mask
        )
    training = not deterministic or torch.is_grad_enabled()
    both = has_both_biases(cfg)
    if not training and both and use_fused_bias_attention():
        attn_bias = fused_bias_context(p, cfg, pos, full_bbox, full_mask)
    elif training and both and use_table_grad_attention():
        attn_bias = train_bias_context(p, cfg, pos, full_bbox, full_mask, hidden.dtype)
    else:
        attn_bias = make_attention_bias(
            p, cfg, pos, full_bbox, full_mask, dtype=hidden.dtype
        )
        if training:
            attn_bias = ChainedBiasContext(attn_bias)
    final, cls_per_layer = encoder_apply(
        p.encoder, cfg, hidden, attn_bias, collect_cls=collect_cls,
        deterministic=deterministic, rng=rngs,
    )
    return BackboneOutput(
        last_hidden_state=final,
        cls_per_layer=cls_per_layer,
        visual_embeddings=vis_emb,
        text_embeddings=text_emb,
        combined_embeddings=combined,
    )
