"""LayoutLMv3 in PyTorch: parameter modules and the forward path.

The counterpart of the JAX package's ``models/layoutlmv3/modeling.py``.
Parameters live in ``nn.Module`` containers whose attribute names follow the
JAX parameter tree (``models/layoutlmv3/convert.py`` maps one onto the
other); the forward path is a set of plain functions over those modules
with the JAX names (``embed_text``, ``encoder_apply``, ``backbone_apply``,
...). Encoder layers are a ``ModuleList`` run in a Python loop.

``make_attention_bias`` builds the (B, H, P, P) relative-position + mask
bias once per forward (``ops.materialize_bias``, differentiable in the
three tables). Every layer then takes the bias as it is: at attention
dropout 0 (deterministic, or a rate of 0) ``ops.flash_attention_packed``,
whose backward runs the head-form kernels, else
``ops.flash_attention_packed_train``; autograd sums the layers' bias
cotangents and the bias builder's backward (``ops.table_grads``) reduces
the sum into the tables once per step. When training (not
``deterministic``) with the chained bias cotangent on
(``use_chained_dbias``, by default exactly when ``effective_scan_fold``
folds every layer into one step, as in the JAX package), the bias rides
from layer to layer instead (``ChainedBiasContext``) through
``ops.flash_attention_packed_train_chained``, so each layer's backward adds
its bias cotangent to the running one in the kernel. With
``cfg.gradient_checkpointing`` each group of ``effective_scan_fold`` layers
is recomputed in the backward (``torch.utils.checkpoint``). On CUDA tensors
the attention and bias ops are the hand-written kernels, on CPU tensors
their plain PyTorch versions; outside autograd, LayerNorm and the residual
add before it are one kernel on CUDA tensors (``layer_norm``). Masked keys
carry -1e30. With no bias at all (the image-only ``dit``,
``forward_image_classification``) the attention is composed of torch ops,
as the JAX package composes it in XLA: no kernel.
``LayoutLMv3Model`` allocates only the towers a variant uses (``bert``:
text, ``dit``: vision). ``LayoutLMv3Stages`` holds the backbone's pieces of
the early-exit model (``models.ee``): its modules, their initialisation,
the exits' inputs of the batched forward, and the cascade's stages.

Two opt-in bias modes, off by default as in the JAX package and switched by
the same environment variables, read at call time:

- ``MMEE_FUSED_BIAS`` (inference only): the layers get a ``FusedBiasContext``
  of the (B, S) vectors and the scaled tables, and
  ``ops.fused_bias_attention`` builds the bias inside the attention kernel,
  so no bias tensor exists;
- ``MMEE_TABLE_GRADS`` (training): the layers get a ``TrainBiasContext``
  with the bias detached, and ``ops.flash_attention_packed_train_tables``
  reduces each layer's bias cotangent straight into the tables' gradients.

``MMEE_CHAINED_DBIAS`` (1 on, 0 off) and ``MMEE_LAYERS_PER_STEP`` (the fold)
override the chained default and ``cfg.scan_fold`` as in the JAX package.
Unlike the JAX package, none of the modes is gated on the device or on
bf16: on the CPU the contexts run the plain versions of the kernels.

Dropout is the position-hash dropout of ``ops.hashing`` with int32 seeds
from an ``RngStream`` over one ``torch.Generator``; LayerNorm and GELU have
the JAX package's hand-written backwards. The QKV, output and MLP
projections are ``F.linear``; the patch embedding is an unfold + matmul, as
in the JAX package, not a convolution.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from multi_modal_early_exit_tpu_torch.device import resolve_device
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import LayoutLMv3Config
from multi_modal_early_exit_tpu_torch.ops import layer_norm as ln_ops
from multi_modal_early_exit_tpu_torch.ops.flash_attention import (
    flash_attention_packed,
    flash_attention_packed_train,
    flash_attention_packed_train_chained,
    flash_attention_packed_train_tables,
)
from multi_modal_early_exit_tpu_torch.ops.fused_bias_attention import (
    LANE,
    fused_bias_attention,
    materialize_bias,
)
from multi_modal_early_exit_tpu_torch.ops.hashing import hash_dropout
from multi_modal_early_exit_tpu_torch.parallel.layers import (
    column_parallel,
    copy_to_model,
    model_parallel,
    row_parallel,
    shard_seed,
    vocab_parallel_embedding,
)
from multi_modal_early_exit_tpu_torch.utils.profiling import count

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
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """LayerNorm(x + residual) with f32 moments; output in x's dtype. Under
    autograd it is ``x + residual``, then ``_LayerNormCore`` (one-pass
    moments, hand VJP). Otherwise two-pass moments, as the JAX package's
    primal: on CUDA tensors the hand-written kernel
    (``ops.layer_norm.add_layer_norm``, the add and the norm in one pass;
    a strided or misaligned x or residual is copied dense first, and a
    dtype or width the kernel does not build raises), on the CPU the same
    composed of torch ops. Each call's rows count in
    ``layer_norm.fused_rows`` or ``layer_norm.composed_rows``."""
    rows = x.numel() // x.shape[-1]
    grad = (_needs_grad(x, weight, bias) if residual is None
            else _needs_grad(x, residual, weight, bias))
    if grad:
        count("layer_norm.composed_rows", rows)
        if residual is not None:
            x = x + residual
        return _LayerNormCore.apply(x, weight, bias, float(eps))
    if ln_ops.on_card(x):
        count("layer_norm.fused_rows", rows)
        return ln_ops.add_layer_norm(ln_ops.dense(x), weight, bias, eps,
                                     None if residual is None else ln_ops.dense(residual))
    count("layer_norm.composed_rows", rows)
    return ln_ops.add_layer_norm_plain(x, weight, bias, eps, residual)


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

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps, residual)


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
    ``torch.Generator``; with no generator every seed is ``None``.

    Under a ``mesh`` every rank draws the same sequence and offsets it by
    ``parallel.layers.shard_seed``: a hidden or embedding dropout seed by the
    rank's data index (the replicated activations of one model group keep
    identical masks), an attention-probability seed by its linear shard index
    (each rank's kernel hashes its local batch and head indices, as the JAX
    package's ``sharded_flash_attention`` offsets them). Without a mesh, or
    at index 0, the seeds are the drawn ones."""

    def __init__(self, generator: Optional[torch.Generator], mesh=None):
        self.generator = generator
        self.data_shard = mesh.data_index if mesh is not None else 0
        self.shard = mesh.shard_index if mesh is not None else 0

    def _draw(self, shard: int) -> Optional[int]:
        if self.generator is None:
            return None
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=self.generator))
        return shard_seed(seed, shard) if shard else seed

    def next(self) -> Optional[int]:
        """A hidden, embedding or classifier dropout seed."""
        return self._draw(self.data_shard)

    def next_attention(self) -> Optional[int]:
        """An attention-probability dropout seed."""
        return self._draw(self.shard)


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

    def forward(self, cfg, hidden, attn_bias, deterministic=True, seeds=None):
        """``encoder_layer_apply`` of this layer, for ``functional_call``."""
        return encoder_layer_apply(self, cfg, hidden, attn_bias, deterministic, seeds)


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
    ``init_params`` or ``convert.load_jax_params`` fills them. The
    single-modality variants (``dit`` image-only, ``bert`` text-only) pass
    ``with_text=False`` / ``with_vision=False``: the unused tower is not
    allocated, and neither is the post-concat LayerNorm."""

    def __init__(self, cfg: LayoutLMv3Config, device=None, with_text: bool = True,
                 with_vision: bool = True):
        super().__init__()
        device = resolve_device(device)
        self.embeddings = TextEmbeddings(cfg) if with_text else None
        self.visual = VisualEmbeddings(cfg) if with_vision else None
        # post-concat modality LayerNorm
        self.LayerNorm = (LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
                          if with_text and with_vision else None)
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
    with_text: bool = True,
    with_vision: bool = True,
) -> LayoutLMv3Model:
    """Random backbone parameters from a (CPU) ``generator``, with the JAX
    package's shapes and std, moved to ``device`` (``cuda`` by default);
    ``with_text``/``with_vision`` as in ``LayoutLMv3Model``."""
    device = resolve_device(device)
    model = LayoutLMv3Model(cfg, device="cpu", with_text=with_text, with_vision=with_vision)
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


def spatial_position_embeddings(p: TextEmbeddings, bbox: torch.Tensor, mesh=None,
                                rows: int = 0) -> torch.Tensor:
    """Concat of left/upper/right/lower coordinate + h/w shape embeddings.
    Under a model axis (``mesh``) the tables hold this rank's share of their
    ``rows`` rows (``vocab_parallel_embedding``)."""
    def lookup(table, ids):
        return vocab_parallel_embedding(ids, table, rows, mesh)

    bbox = bbox.long()
    left = lookup(p.x_position_embeddings, bbox[:, :, 0])
    upper = lookup(p.y_position_embeddings, bbox[:, :, 1])
    right = lookup(p.x_position_embeddings, bbox[:, :, 2])
    lower = lookup(p.y_position_embeddings, bbox[:, :, 3])
    h = lookup(p.h_position_embeddings, torch.clamp(bbox[:, :, 3] - bbox[:, :, 1], 0, 1023))
    w = lookup(p.w_position_embeddings, torch.clamp(bbox[:, :, 2] - bbox[:, :, 0], 0, 1023))
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
    # under a model axis the word and position tables are split by rows
    # (each partial lookup summed over the model group: the unsharded lookup
    # bit for bit); without one these are plain lookups
    mesh = model_parallel(p)
    x = vocab_parallel_embedding(input_ids, p.word_embeddings, cfg.vocab_size, mesh)
    x = x + p.token_type_embeddings[token_type_ids.long()]
    x = x + vocab_parallel_embedding(position_ids.long(), p.position_embeddings,
                                     cfg.max_position_embeddings, mesh)
    x = x + spatial_position_embeddings(p, bbox, mesh, cfg.max_2d_position_embeddings)
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
    with the [CLS] box [1, 1, 999, 999] first; edges use integer division.
    Made once per grid and device and shared, so callers only read it: its
    [CLS] box is copied from the host, a wait that no CUDA graph of the
    cascade can hold."""
    return _visual_bbox(cfg.num_patches_side, torch.device(device or "cpu"), max_len)


@functools.lru_cache(maxsize=None)
def _visual_bbox(size: int, device: torch.device, max_len: int) -> torch.Tensor:
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
    does not have. Under a model axis, the columns of this rank's heads
    only (the tables are replicated; each rank's gradient lands in its own
    columns)."""
    enc = p.encoder
    mesh = model_parallel(enc)
    heads = local_heads(cfg, mesh)
    first = mesh.model_index * heads if mesh is not None else 0
    scale = 1.0 / math.sqrt(cfg.head_dim) if cfg.scale_bias else 1.0

    def table(name: str, bins: int, present: bool) -> torch.Tensor:
        if not present:
            return torch.zeros((bins, heads), dtype=torch.float32, device=device)
        t = getattr(enc, name)
        if mesh is not None:
            t = t[:, first:first + heads]
        return (t.to(torch.float32) * scale).contiguous()

    return (
        table("rel_pos_bias", cfg.rel_pos_bins, cfg.has_relative_attention_bias),
        table("rel_pos_x_bias", cfg.rel_2d_pos_bins, cfg.has_spatial_attention_bias),
        table("rel_pos_y_bias", cfg.rel_2d_pos_bins, cfg.has_spatial_attention_bias),
    )


def local_heads(cfg: LayoutLMv3Config, mesh=None) -> int:
    """The heads this rank computes: all of them, or H / tp under a model
    axis."""
    return cfg.num_attention_heads // (mesh.model_size if mesh is not None else 1)


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


def use_chained_dbias(default: bool = False) -> bool:
    """Training attention with the chained bias cotangent
    (``ops.flash_attention_packed_train_chained``). MMEE_CHAINED_DBIAS=1
    forces it on, =0 off; unset (or empty) gives ``default``, which
    ``backbone_apply`` sets to ``effective_scan_fold(cfg) ==
    num_hidden_layers``, as the JAX package does."""
    return _switch("MMEE_CHAINED_DBIAS", default)


def effective_scan_fold(cfg: LayoutLMv3Config) -> int:
    """Layers per encoder step: MMEE_LAYERS_PER_STEP if set to a positive
    integer, else ``cfg.scan_fold``; 1 when that is not a divisor of the
    layer count (the JAX package's rule, read at call time)."""
    try:
        fold = int(os.environ.get("MMEE_LAYERS_PER_STEP", "0"))
    except ValueError:  # empty or not a number: as if unset
        fold = 0
    fold = fold or cfg.scan_fold
    if fold < 1 or cfg.num_hidden_layers % fold:
        return 1
    return fold


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
    """Packed (B, S, hidden) q/k/v (this rank's heads, hidden / tp wide,
    under a model axis) and the attention dropout (rate, seed); the rate is
    0 when deterministic or without a seed."""
    rate = 0.0 if deterministic or seed_attn is None else cfg.attention_probs_dropout_prob
    seed = seed_attn if rate > 0.0 else 0
    return (*_qkv(p, hidden), rate, seed)


def _qkv(p: Attention, hidden: torch.Tensor):
    """The packed q/k/v projections: column parallel under a model axis."""
    hidden = copy_to_model(hidden, model_parallel(p))
    return p.query(hidden), p.key(hidden), p.value(hidden)


def _attn_epilogue(
    p: Attention, cfg: LayoutLMv3Config, ctx: torch.Tensor, hidden: torch.Tensor,
    deterministic: bool = True, seed_out: Optional[int] = None,
) -> torch.Tensor:
    """Output projection (row parallel under a model axis), dropout and
    residual LayerNorm."""
    out = dropout(row_parallel(p.output, ctx, model_parallel(p)), cfg.hidden_dropout_prob,
                  deterministic, seed_out)
    return p.output_LayerNorm(out, residual=hidden)


def _attention_no_bias(
    p: Attention, cfg: LayoutLMv3Config, hidden: torch.Tensor,
    deterministic: bool, seed_attn: Optional[int], seed_out: Optional[int],
) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v composed of torch ops, as the JAX package
    composes it in XLA when there is no bias (``dit``): the products
    accumulate in f32, the probabilities take v's type, then the attention
    dropout."""
    b, s, _ = hidden.shape
    heads, d = local_heads(cfg, model_parallel(p)), cfg.head_dim

    def split(x):  # (B, S, H*D) -> (B, H, S, D)
        return x.view(b, s, heads, d).transpose(1, 2)

    q, k, v = (split(x) for x in _qkv(p, hidden))
    scores = torch.matmul((q / math.sqrt(d)).float(), k.float().transpose(-1, -2))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    probs = dropout(probs, cfg.attention_probs_dropout_prob, deterministic, seed_attn)
    ctx = torch.matmul(probs.float(), v.float()).to(hidden.dtype)
    ctx = ctx.transpose(1, 2).reshape(b, s, heads * d)
    return _attn_epilogue(p, cfg, ctx, hidden, deterministic, seed_out)


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
    epilogue. The bias is None (composed of torch ops: no kernel, as in the
    JAX package), a (B, H, P, P) tensor or a context. A tensor runs
    ``flash_attention_packed`` at attention dropout 0 (differentiable, as
    in the JAX package) and ``flash_attention_packed_train`` above it. With
    a ``ChainedBiasContext`` (training) it returns ``(out,
    ChainedBiasContext(bias passed through))``; a ``TrainBiasContext``
    (training) runs the table-gradient attention, a ``FusedBiasContext``
    (inference) the attention that builds the bias in the kernel. Under a
    model axis every path runs this rank's heads (the bias and the tables
    hold only their columns)."""
    heads = local_heads(cfg, model_parallel(p))
    if attn_bias is None:
        return _attention_no_bias(p, cfg, hidden, deterministic, seed_attn, seed_out)
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
        qp, kp, vp, rate, seed = _packed_qkv_and_seed(p, cfg, hidden, deterministic, seed_attn)
        if rate > 0.0:
            ctx = flash_attention_packed_train(qp, kp, vp, attn_bias, seed, heads, rate=rate)
        else:
            ctx = flash_attention_packed(qp, kp, vp, attn_bias, heads)
        return _attn_epilogue(p, cfg, ctx.to(hidden.dtype), hidden, deterministic, seed_out)
    b, s, _ = hidden.shape

    def split(x):  # (B, S, H*D) -> a (B, H, S, D) view, no copy
        return x.view(b, s, heads, cfg.head_dim).transpose(1, 2)

    c = attn_bias
    ctx = fused_bias_attention(
        *(split(x) for x in _qkv(p, hidden)),
        c.position_ids, c.cx, c.cy, c.mask, c.t1, c.tx, c.ty, **bucket_kwargs(cfg),
    )
    # the kernel writes q's layout, so this is a view of (B, S, H, D)
    ctx = ctx.transpose(1, 2).reshape(b, s, heads * cfg.head_dim).to(hidden.dtype)
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
    dropout seeds. Returns ``(out, ChainedBiasContext)`` when chained. Under
    a model axis the MLP is Megatron's: ``intermediate`` column parallel,
    ``output`` row parallel (``parallel/layers.py``)."""
    r = seeds or (None, None, None)
    attn_out = attention_apply(p.attention, cfg, hidden, attn_bias, deterministic, r[0], r[1])
    chained = None
    if isinstance(attn_bias, ChainedBiasContext):
        attn_out, chained = attn_out
    mesh = model_parallel(p)
    inter = gelu_exact(column_parallel(p.intermediate, attn_out, mesh))
    out = dropout(row_parallel(p.output, inter, mesh), cfg.hidden_dropout_prob, deterministic,
                  r[2])
    out = p.output_LayerNorm(out, residual=attn_out)
    return out if chained is None else (out, chained)


def encoder_apply(
    p: Encoder,
    cfg: LayoutLMv3Config,
    hidden: torch.Tensor,
    attn_bias,
    collect_cls: bool = True,
    deterministic: bool = True,
    rng: Optional[RngStream] = None,
    collect_hidden: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Run every layer; returns ``(final_hidden, cls_per_layer,
    hidden_per_layer)`` where ``cls_per_layer`` is (L, B, H): the [CLS]
    state after each layer, the encoder exits' input, and, with
    ``collect_hidden``, ``hidden_per_layer`` is (L, B, S, H): each layer's
    output state (else None). A ``ChainedBiasContext`` is carried from each
    layer to the next; each layer draws three dropout seeds from ``rng``.

    With ``cfg.gradient_checkpointing`` under autograd, each group of
    ``effective_scan_fold(cfg)`` layers runs in ``torch.utils.checkpoint``,
    the counterpart of the JAX package's ``jax.checkpoint`` of one scan
    step. The group's seeds are drawn before the call, and its parameters
    are the tensors the layers hold then (the bf16 copies under
    ``functional_call``), so the recompute in the backward repeats the
    forward bit for bit. The fold changes the grouping only, never the
    numbers."""
    layers = list(p.layers)
    fold = effective_scan_fold(cfg)
    remat = cfg.gradient_checkpointing and torch.is_grad_enabled()
    chained = isinstance(attn_bias, ChainedBiasContext)

    def run(h, bias, group, seeds, params):
        taps, states = [], []
        for layer, layer_seeds, prm in zip(group, seeds, params):
            args = (cfg, h, bias, deterministic, layer_seeds)
            out = (encoder_layer_apply(layer, *args) if prm is None
                   else functional_call(layer, prm, args))
            h, bias = out if chained else (out, bias)
            if collect_cls:
                taps.append(h[:, 0, :])
            if collect_hidden:
                states.append(h)
        return h, bias, taps, states

    taps, states = [], []
    for start in range(0, len(layers), fold):
        group = layers[start:start + fold]
        seeds = [(rng.next_attention(), rng.next(), rng.next()) if rng else None
                 for _ in group]
        if remat:
            params = [dict(layer.named_parameters()) for layer in group]
            hidden, attn_bias, group_taps, group_states = checkpoint(
                run, hidden, attn_bias, group, seeds, params,
                use_reentrant=False, preserve_rng_state=False,  # no torch RNG inside
            )
        else:
            hidden, attn_bias, group_taps, group_states = run(
                hidden, attn_bias, group, seeds, [None] * len(group))
        taps += group_taps
        states += group_states
    return (hidden, torch.stack(taps) if collect_cls else None,
            torch.stack(states) if collect_hidden else None)


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
    hidden_per_layer: Optional[torch.Tensor] = None  # (L, B, S', H), collect_hidden only


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
    collect_hidden: bool = False,
    seq_pad_multiple: Optional[int] = None,
) -> BackboneOutput:
    """The multimodal backbone. ``seq_pad_multiple`` pads the concatenated
    sequence once before the encoder; the bias is always built at a width
    that is a multiple of 128. ``collect_hidden`` fills
    ``hidden_per_layer`` with every layer's output state, at the padded
    width when ``seq_pad_multiple`` pads. With ``deterministic=False`` the dropout
    seeds come from ``rng``. The attention follows the JAX package's
    selection: when not deterministic, the table-gradient attention with
    ``MMEE_TABLE_GRADS=1``, else the chained training attention when
    ``use_chained_dbias(default=effective_scan_fold(cfg) ==
    num_hidden_layers)``; otherwise every layer takes the bias tensor
    (``attention_apply``), which is differentiable. Inference with
    ``MMEE_FUSED_BIAS=1`` builds no bias tensor; the fused attention has no
    backward, so it is taken only when deterministic with autograd off."""
    rngs = RngStream(None if deterministic else rng, getattr(p, "mesh", None))
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
    both = has_both_biases(cfg)
    if deterministic and not torch.is_grad_enabled() and both and use_fused_bias_attention():
        attn_bias = fused_bias_context(p, cfg, pos, full_bbox, full_mask)
    elif not deterministic and both and use_table_grad_attention():
        attn_bias = train_bias_context(p, cfg, pos, full_bbox, full_mask, hidden.dtype)
    else:
        attn_bias = make_attention_bias(
            p, cfg, pos, full_bbox, full_mask, dtype=hidden.dtype
        )
        if not deterministic and use_chained_dbias(
            default=effective_scan_fold(cfg) == cfg.num_hidden_layers
        ):
            attn_bias = ChainedBiasContext(attn_bias)
    final, cls_per_layer, hidden_per_layer = encoder_apply(
        p.encoder, cfg, hidden, attn_bias, collect_cls=collect_cls,
        deterministic=deterministic, rng=rngs, collect_hidden=collect_hidden,
    )
    return BackboneOutput(
        last_hidden_state=final,
        cls_per_layer=cls_per_layer,
        visual_embeddings=vis_emb,
        text_embeddings=text_emb,
        combined_embeddings=combined,
        hidden_per_layer=hidden_per_layer,
    )


# ---------------------------------------------------------------------------
# classification forwards
# ---------------------------------------------------------------------------


def forward_image_classification(
    p: LayoutLMv3Model,
    cfg: LayoutLMv3Config,
    pixel_values: torch.Tensor,
    deterministic: bool = True,
    rng: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Image-only ViT-style classification (the reference's ``dit`` model,
    EE/configs.py:429-449): patch embedding + an encoder with no bias (its
    attention composed of torch ops) + the classifier on [CLS]."""
    rngs = RngStream(None if deterministic else rng, getattr(p, "mesh", None))
    vis_emb = embed_vision(p.visual, cfg, pixel_values)
    final, _, _ = encoder_apply(p.encoder, cfg, vis_emb, None, collect_cls=False,
                                deterministic=deterministic, rng=rngs)
    return classifier_apply(p.classifier, cfg, final[:, 0, :], deterministic, rngs)


def forward_text_classification(
    p: LayoutLMv3Model,
    cfg: LayoutLMv3Config,
    input_ids: torch.Tensor,
    bbox: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    rng: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Text-only classification (the reference's ``bert`` model,
    EE/configs.py:482-493): text(+layout) embeddings + an encoder with the
    1D relative bias (``make_attention_bias``; the spatial tables are zero
    when the config has none) + the classifier on [CLS]. ``bbox`` defaults
    to zeros (no layout signal)."""
    rngs = RngStream(None if deterministic else rng, getattr(p, "mesh", None))
    b, s = input_ids.shape
    dev = input_ids.device
    if bbox is None:
        bbox = torch.zeros((b, s, 4), dtype=torch.int32, device=dev)
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    text_emb = embed_text(p.embeddings, cfg, input_ids, bbox,
                          deterministic=deterministic, rngs=rngs)
    position_ids = torch.arange(s, device=dev).expand(b, s)
    bias = make_attention_bias(p, cfg, position_ids, bbox, attention_mask,
                               dtype=text_emb.dtype)
    final, _, _ = encoder_apply(p.encoder, cfg, text_emb, bias, collect_cls=False,
                                deterministic=deterministic, rng=rngs)
    return classifier_apply(p.classifier, cfg, final[:, 0, :], deterministic, rngs)


def forward_sequence_classification(
    p: LayoutLMv3Model,
    cfg: LayoutLMv3Config,
    input_ids: torch.Tensor,
    bbox: torch.Tensor,
    pixel_values: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    rng: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Dense (no-exit) classification logits
    (parity: LayoutLMv3ForSequenceClassification.forward)."""
    out = backbone_apply(p, cfg, input_ids, bbox, pixel_values, attention_mask,
                         deterministic=deterministic, rng=rng, collect_cls=False)
    rngs = RngStream(None if deterministic else rng, getattr(p, "mesh", None))
    return classifier_apply(p.classifier, cfg, out.last_hidden_state[:, 0, :],
                            deterministic, rngs)


# ---------------------------------------------------------------------------
# the early-exit model's pieces (models.ee)
# ---------------------------------------------------------------------------


class _BiasCarry:
    """One cascade call's bias state: the fused switch, and the previous
    stage's bias and rows (a later stage gathers its rows out of them)."""

    __slots__ = ("fused", "bias", "sel", "batch")

    def __init__(self, fused: bool, batch: int):
        self.fused, self.bias, self.sel, self.batch = fused, None, None, batch


class LayoutLMv3Stages:
    """LayoutLMv3's pieces of the early-exit model (``models.ee``).

    For ``EEModel`` and ``init_ee_params``: the backbone module, no norm
    before an exit head, parameters drawn on the CPU and then moved. For
    ``ee_forward``: the exits' inputs (modality means, the [CLS] state
    after a layer) and the classifier's. For the cascade: the text and
    vision embeddings (the embedding exits' sources), the sequence padded
    once to the bias width, the relative-position bias built at stage 0 and
    gathered after (or, with ``MMEE_FUSED_BIAS=1``, read per call, built in
    each stage's attention kernel), the [CLS] state at each exit. Every
    shape follows from the inputs' shapes and the capacities, and nothing
    waits on the card (``static_shapes``), so each part can be captured in
    a CUDA graph; ``graph_key`` is what else a capture holds fixed."""

    static_shapes = True

    def __init__(self, cfg: LayoutLMv3Config):
        self.cfg = cfg

    def backbone(self, exit_cfg, with_text: bool = True, with_vision: bool = True):
        """The backbone module, on the CPU (any exit config)."""
        return LayoutLMv3Model(self.cfg, device="cpu", with_text=with_text,
                               with_vision=with_vision)

    def head_norm(self):
        """The norm an exit head applies first: none."""
        return None

    def init_model(self, build, generator: torch.Generator, device, dtype):
        """``build("cpu")``'s parameters drawn from the CPU ``generator``,
        then moved to ``device`` in ``dtype``."""
        model = build("cpu")
        reset_parameters(model, generator, self.cfg.initializer_range)
        return model.to(device=device, dtype=dtype)

    def forward(self, model, order, input_ids, bbox, pixel_values, attention_mask,
                deterministic, rng, collect_hidden, seq_pad_multiple):
        """The batched forward: (each exit's input in ``order``, the
        classifier's input, the encoder's output)."""
        bb = backbone_apply(
            model.backbone, self.cfg, input_ids, bbox, pixel_values, attention_mask,
            deterministic=deterministic, rng=rng,
            collect_cls=any(isinstance(e, int) for e in order),
            collect_hidden=collect_hidden, seq_pad_multiple=seq_pad_multiple,
        )
        sources = {"vision_avg": bb.visual_embeddings, "text_avg": bb.text_embeddings,
                   "text_visual_concat": bb.combined_embeddings}
        inputs = [sources[e].mean(dim=1) if isinstance(e, str) else bb.cls_per_layer[e - 1]
                  for e in order]
        return inputs, bb.last_hidden_state[:, 0, :], bb.last_hidden_state

    def graph_key(self):
        """What a captured cascade holds fixed besides the model and the
        inputs: the fused-bias switch."""
        return use_fused_bias_attention()

    def embed(self, model, input_ids, bbox, pixel_values, attention_mask):
        """(state: per-row tensors a stage gathers, the embedding exits'
        sources, the call's carry)."""
        bb, cfg = model.backbone, self.cfg
        text_emb = embed_text(bb.embeddings, cfg, input_ids, bbox)
        vis_emb = embed_vision(bb.visual, cfg, pixel_values)
        combined = bb.LayerNorm(torch.cat([text_emb, vis_emb], dim=1))
        full_bbox, pos_ids, full_mask = sequence_layout(
            cfg, bbox, attention_mask, vis_emb.shape[1]
        )
        sources = {"vision_avg": vis_emb, "text_avg": text_emb,
                   "text_visual_concat": combined}
        carry = _BiasCarry(has_both_biases(cfg) and use_fused_bias_attention(),
                           input_ids.shape[0])
        # pad once to the bias width: every stage runs at P = S_pad
        state = list(pad_sequence(LANE, combined, full_bbox, pos_ids, full_mask))
        return state, sources, carry

    def layers(self, model, state, sel, a: int, b: int, carry: _BiasCarry):
        """Layers a..b-1 over the rows ``sel`` of ``state``: (hidden, the
        other state tensors of those rows, the exit input). The gathered
        input is referenced here alone, so it is freed after the first
        layer."""
        bb, cfg = model.backbone, self.cfg
        hidden_c, bbox_c, pos_c, mask_c = (t[sel] for t in state)
        if carry.fused:
            # the attention kernel builds each stage's bias from its
            # rows' vectors; no bias tensor exists to gather from
            bias_c = fused_bias_context(bb, cfg, pos_c, bbox_c, mask_c)
        elif carry.bias is None:
            bias_c = make_attention_bias(bb, cfg, pos_c, bbox_c, mask_c, dtype=hidden_c.dtype)
            carry.bias, carry.sel = bias_c, sel
        else:
            # this stage's rows are a subset of the previous stage's:
            # gather their bias rows instead of rebuilding them
            pos_in_prev = torch.zeros((carry.batch,), dtype=torch.int64, device=sel.device)
            pos_in_prev[carry.sel] = torch.arange(carry.sel.shape[0], device=sel.device)
            bias_c = carry.bias[pos_in_prev[sel]]
            carry.bias, carry.sel = bias_c, sel
        for layer in bb.encoder.layers[a:b]:
            hidden_c = encoder_layer_apply(layer, cfg, hidden_c, bias_c)
        return hidden_c, (bbox_c, pos_c, mask_c), hidden_c[:, 0, :]

    def classify(self, model, x, deterministic: bool = True,
                 rngs: Optional[RngStream] = None):
        return classifier_apply(model.backbone.classifier, self.cfg, x, deterministic, rngs)
