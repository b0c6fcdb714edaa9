"""Kimi-VL-A3B-Instruct as the early-exit model's backbone: MoonViT reads
each scanned page at its own resolution and its merged patches take the
placeholder positions of Moonlight's input.

The vision tower, after the public MoonViT modeling code at its published
configuration (``config.MoonViTConfig``), over every page of a batch at
once, packed by their real patches (page i's h_i x w_i patches in row-major
order, back to back, so no padding patch is computed or attended):

- the patch embedding, a 14 x 14 convolution at stride 14 with a bias, as
  one product over each patch's 588 values (channels, then rows, then
  columns: the convolution's weight flattened);
- a learnable 64 x 64 position table, added as it is to a 64 x 64 grid and
  otherwise after bicubic interpolation to the page's grid
  (``F.interpolate``'s, ``align_corners`` False), computed in f32 as two
  products with the interpolation's matrices (``bicubic_matrix``: PyTorch's
  CUDA bicubic kernel loops over the table's 1152 channels in each thread,
  about 10 ms a page on an H100);
- 27 pre-LayerNorm layers: ``x += wo(attn(rope2d(wqkv(norm0(x)))))``, then
  ``x += fc1(gelu_tanh(fc0(norm1(x))))``; a final LayerNorm. The
  attention is bidirectional within each page and never across pages, at
  scale 72^-0.5 (``ops.page_attention``); the 2D rotary embedding turns
  each adjacent pair (2j, 2j + 1) of q's and k's 72 dims as one complex
  number in f32 (one complex product for q and k), pair 2i by the patch's
  column and pair 2i + 1 by its row, each times theta^(-4i/72) (theta
  10,000);
- the merge: each 2 x 2 block of a page's patches becomes one token of 4 x
  1152 values (the block's rows in order), after the projector's
  LayerNorm on each patch; then Linear 4608 -> 4608, exact GELU, Linear
  4608 -> 2048.

Every LayerNorm is PyTorch's ``layer_norm`` (f32 moments whatever the
input's type; the port's own kernel builds widths up to 1024). The page's
tokens replace, in order, the positions of its row whose id is
``media_placeholder_token_id``; the decoder then runs as Moonlight's, with
plain 1D positions for every token (``models.moonlight.modeling``).

Spans: ``vit.tower`` (the patch embedding through the projector),
``vit.attention`` (each layer's attention core), ``vit.merge`` (the
merge and the projector). Counters, from the page grids the host holds:
``vit.pages``, ``vit.patches`` (the pages' patches, N summed) and
``vit.patch_pairs`` (N^2 summed: the attention's query-key pairs a head
and layer).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multi_modal_early_exit_tpu_torch.models.kimi_vl.config import KimiVLConfig, MoonViTConfig
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import LayerNorm, Linear
from multi_modal_early_exit_tpu_torch.models.moonlight import modeling as moon
from multi_modal_early_exit_tpu_torch.ops.page_attention import page_attention
from multi_modal_early_exit_tpu_torch.utils import profiling
from multi_modal_early_exit_tpu_torch.utils.profiling import count, span

# ---------------------------------------------------------------------------
# parameter containers (names: the HF checkpoint's)
# ---------------------------------------------------------------------------


class PatchConv(nn.Module):
    """The patch embedding's convolution: weight (hidden, C, p, p), bias."""

    def __init__(self, cfg: MoonViTConfig):
        super().__init__()
        p = cfg.patch_size
        self.weight = nn.Parameter(torch.empty(cfg.hidden_size, cfg.num_channels, p, p))
        self.bias = nn.Parameter(torch.empty(cfg.hidden_size))

    def reset_parameters(self, generator: torch.Generator, std: float) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)
            self.bias.zero_()


class PositionTable(nn.Module):
    """The learnable (height, width, hidden) position table."""

    def __init__(self, cfg: MoonViTConfig):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cfg.init_pos_emb_height, cfg.init_pos_emb_width,
                                               cfg.hidden_size))

    def reset_parameters(self, generator: torch.Generator, std: float) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: MoonViTConfig):
        super().__init__()
        self.proj = PatchConv(cfg)
        self.pos_emb = PositionTable(cfg)


class VisionMLP(nn.Module):
    def __init__(self, cfg: MoonViTConfig):
        super().__init__()
        self.fc0 = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc1 = Linear(cfg.intermediate_size, cfg.hidden_size)


class VisionBlock(nn.Module):
    def __init__(self, cfg: MoonViTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.norm0 = LayerNorm(d, cfg.layer_norm_eps)
        self.norm1 = LayerNorm(d, cfg.layer_norm_eps)
        self.wqkv = Linear(d, 3 * d)
        self.wo = Linear(d, d)
        self.mlp = VisionMLP(cfg)


class VisionEncoder(nn.Module):
    def __init__(self, cfg: MoonViTConfig):
        super().__init__()
        self.blocks = nn.ModuleList(VisionBlock(cfg) for _ in range(cfg.num_hidden_layers))
        self.final_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class VisionTower(nn.Module):
    def __init__(self, cfg: MoonViTConfig):
        super().__init__()
        self.patch_embed = PatchEmbed(cfg)
        self.encoder = VisionEncoder(cfg)


class Projector(nn.Module):
    """LayerNorm on each patch, then Linear, GELU, Linear over the merged
    token."""

    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        v = cfg.vision
        width = v.hidden_size * v.merged
        self.pre_norm = LayerNorm(v.hidden_size, cfg.projector_ln_eps)
        self.linear_1 = Linear(width, width)
        self.linear_2 = Linear(width, cfg.text.hidden_size)


class KimiVLModel(moon.MoonlightModel):
    """Moonlight's decoder and classifier (the same names) with the vision
    tower and the projector beside them."""

    def __init__(self, cfg: KimiVLConfig):
        super().__init__(cfg.text)
        self.vision_tower = VisionTower(cfg.vision)
        self.multi_modal_projector = Projector(cfg)


# ---------------------------------------------------------------------------
# the pages of a batch
# ---------------------------------------------------------------------------


def bicubic_matrix(size_in: int, size_out: int) -> np.ndarray:
    """(size_out, size_in) f64: ``F.interpolate``'s bicubic resampling along
    one axis (A = -0.75, ``align_corners`` False, edge taps clamped) as a
    matrix; the 2D resampling is one such product along each axis."""
    a = -0.75
    x = (np.arange(size_out) + 0.5) * (size_in / size_out) - 0.5
    x0 = np.floor(x)
    t = x - x0

    def near(s):
        return ((a + 2) * s - (a + 3)) * s * s + 1

    def far(s):
        return ((a * s - 5 * a) * s + 8 * a) * s - 4 * a

    taps = np.stack([far(t + 1), near(t), near(1 - t), far(2 - t)], axis=1)
    cols = np.clip(x0[:, None].astype(np.int64) + np.arange(-1, 3), 0, size_in - 1)
    out = np.zeros((size_out, size_in))
    np.add.at(out, (np.repeat(np.arange(size_out), 4), cols.ravel()), taps.ravel())
    return out


class Pages(NamedTuple):
    """Where a batch's pages lie once packed by their real patches: each
    page's (h, w) and first packed row (``starts``, T last) on the host;
    on the device, each packed patch's row in the padded (B x P) patch
    rows (``gather``), its row and column in its page, the packed rows in
    merge order (each 2 x 2 block's four patches together), ``starts`` as
    int32 (``cu_seqlens``), and per page the f32 matrices (h x H0, w x W0)
    that resample the position table to its grid (None at the table's own
    grid)."""

    grid: List[Tuple[int, int]]
    starts: List[int]
    gather: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    merge: torch.Tensor
    cu_seqlens: torch.Tensor
    resample: List[Optional[Tuple[torch.Tensor, torch.Tensor]]]


def pages_of(grid: Sequence[Tuple[int, int]], max_patches: int, cfg: MoonViTConfig,
             device) -> Pages:
    """The packing of pages of patch grids ``grid`` whose patch rows lie
    padded to ``max_patches`` a page, built on the host and copied in two
    transfers (the indices, the resampling matrices)."""
    kh, kw = cfg.merge_kernel_size
    table = (cfg.init_pos_emb_height, cfg.init_pos_emb_width)
    gather, rows, cols, merge, starts, mats = [], [], [], [], [0], []
    for i, (h, w) in enumerate(grid):
        if h * w > max_patches or h % kh or w % kw:
            raise ValueError(f"page {i}'s {h} x {w} patches do not fit {max_patches} rows or "
                             f"do not tile {kh} x {kw} blocks")
        n = h * w
        gather.append(i * max_patches + np.arange(n))
        r, c = np.divmod(np.arange(n), w)
        rows.append(r)
        cols.append(c)
        block = np.arange(n).reshape(h // kh, kh, w // kw, kw).transpose(0, 2, 1, 3)
        merge.append(starts[-1] + block.reshape(-1))
        starts.append(starts[-1] + n)
        if (h, w) != table:
            mats += [bicubic_matrix(table[0], h).ravel(), bicubic_matrix(table[1], w).ravel()]
    host = np.concatenate([np.concatenate(x) for x in (gather, rows, cols, merge)] + [starts])
    mats = np.concatenate(mats or [np.zeros(0)]).astype(np.float32)
    # a copy from pageable host memory waits for the card's queue
    with profiling.sync("pages"):
        dev = torch.from_numpy(host.astype(np.int64)).to(device)
    with profiling.sync("pages"):
        flat = torch.from_numpy(mats).to(device)
    resample, at = [], 0
    for h, w in grid:
        if (h, w) == table:
            resample.append(None)
            continue
        a_h = flat[at:at + h * table[0]].view(h, table[0])
        at += h * table[0]
        resample.append((a_h, flat[at:at + w * table[1]].view(w, table[1])))
        at += w * table[1]
    t = starts[-1]
    return Pages([tuple(g) for g in grid], starts, dev[:t], dev[t:2 * t], dev[2 * t:3 * t],
                 dev[3 * t:4 * t], dev[4 * t:].to(torch.int32), resample)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def layer_norm(p: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p.weight, p.bias, p.eps)


def positions(p: PositionTable, pages: Pages, dtype) -> torch.Tensor:
    """(T, hidden): the table as it is at its own grid, else resampled
    bicubically to each page's (A_h table A_w^T a channel, in f32),
    flattened row-major."""
    table = p.weight
    h0, w0, d = table.shape
    wide = table.float().reshape(h0, w0 * d)
    out = []
    for (h, w), mats in zip(pages.grid, pages.resample):
        if mats is None:
            out.append(table.reshape(h * w, d).to(dtype))
            continue
        a_h, a_w = mats
        rows = (a_h @ wide).view(h, w0, d)
        out.append(torch.matmul(a_w, rows).reshape(h * w, d).to(dtype))
    return torch.cat(out)


def rope2d(cfg: MoonViTConfig, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(T, head_dim / 2) complex64 turns: pair 2i by col * theta^(-4i/d),
    pair 2i + 1 by row * theta^(-4i/d)."""
    d = cfg.head_dim
    freqs = cfg.rope_theta ** (-torch.arange(0, d, 4, dtype=torch.float32,
                                             device=rows.device)[:d // 4] / d)
    angle = torch.stack([cols[:, None] * freqs, rows[:, None] * freqs], dim=-1).flatten(1)
    return torch.polar(torch.ones_like(angle), angle)


def apply_rope2d(x: torch.Tensor, turns: torch.Tensor) -> torch.Tensor:
    """x (T, ..., heads, d) with each adjacent pair of a head's dims, in f32
    as one complex number, times its patch's turn (T, d/2); in x's type."""
    xc = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2))
    shape = (turns.shape[0],) + (1,) * (x.dim() - 2) + (turns.shape[1],)
    return torch.view_as_real(xc * turns.view(shape)).flatten(-2).to(x.dtype)


def block_apply(p: VisionBlock, cfg: MoonViTConfig, x: torch.Tensor, turns: torch.Tensor,
                pages: Pages) -> torch.Tensor:
    t, d, heads = x.shape[0], cfg.hidden_size, cfg.num_attention_heads
    qkv = p.wqkv(layer_norm(p.norm0, x)).view(t, 3, heads, cfg.head_dim)
    qk = apply_rope2d(qkv[:, :2], turns)
    with span("vit.attention"):
        out = page_attention(qk[:, 0], qk[:, 1], qkv[:, 2], pages.starts, pages.cu_seqlens,
                             cfg.head_dim ** -0.5)
    x = x + p.wo(out.reshape(t, d))
    h = F.gelu(p.mlp.fc0(layer_norm(p.norm1, x)), approximate="tanh")
    return x + p.mlp.fc1(h)


def vision_apply(bb: KimiVLModel, cfg: KimiVLConfig, pixel_values: torch.Tensor,
                 grid: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """(sum of the pages' tokens, text hidden) in the pages' order: the
    tower and the projector over patch rows ``pixel_values`` (B, P,
    patch_dim), page b's first h_b w_b rows real."""
    v = cfg.vision
    with span("vit.pack"):
        pages = pages_of(grid, pixel_values.shape[1], v, pixel_values.device)
    sizes = np.array([h * w for h, w in pages.grid], dtype=np.int64)
    count("vit.pages", len(sizes))
    count("vit.patches", int(sizes.sum()))
    count("vit.patch_pairs", int((sizes * sizes).sum()))
    vt, proj = bb.vision_tower, bb.multi_modal_projector
    with span("vit.tower"):
        conv = vt.patch_embed.proj
        x = pixel_values.reshape(-1, v.patch_dim)[pages.gather]
        x = F.linear(x, conv.weight.reshape(v.hidden_size, -1), conv.bias)
        x = x + positions(vt.patch_embed.pos_emb, pages, x.dtype)
        turns = rope2d(v, pages.rows, pages.cols)
        for block in vt.encoder.blocks:
            x = block_apply(block, v, x, turns, pages)
        x = layer_norm(vt.encoder.final_layernorm, x)
        with span("vit.merge"):
            x = layer_norm(proj.pre_norm, x)[pages.merge].reshape(-1, v.merged * v.hidden_size)
            return proj.linear_2(F.gelu(proj.linear_1(x)))


def splice(hidden: torch.Tensor, input_ids: torch.Tensor, features: torch.Tensor,
           placeholder: int) -> torch.Tensor:
    """``hidden`` (B, S, H) with its placeholder positions, in row-major
    order, taking the rows of ``features`` in turn (no host sync)."""
    where = (input_ids == placeholder)[..., None]
    return hidden.masked_scatter(where, features.to(hidden.dtype))


def embed(bb: KimiVLModel, cfg: KimiVLConfig, input_ids: torch.Tensor,
          attention_mask: torch.Tensor, pixel_values: torch.Tensor,
          image_grid_hws: torch.Tensor) -> Tuple[torch.Tensor, moon.Rope, torch.Tensor]:
    """Moonlight's ``embed`` with each row's page spliced in: (the input
    embeddings (B, S, H), the rotary tables, each row's last real
    position). Reading the grids is the call's one host sync that reads
    the card (``sync.grids``); the packing's two copies to the card wait
    for its queue too (``sync.pages``, inside ``vit.pack``)."""
    with profiling.sync("grids"):
        grid = [tuple(g) for g in image_grid_hws.tolist()]
    features = vision_apply(bb, cfg, pixel_values, grid)
    hidden, rope, last = moon.embed(bb, cfg.text, input_ids, attention_mask)
    return splice(hidden, input_ids, features, cfg.media_placeholder_token_id), rope, last


def last_token_states(bb: KimiVLModel, cfg: KimiVLConfig, input_ids: torch.Tensor,
                      attention_mask: torch.Tensor, pixel_values: torch.Tensor,
                      image_grid_hws: torch.Tensor) -> List[torch.Tensor]:
    """Every decoder layer's last-real-token state, (B, H) each: the batched
    forward."""
    hidden, rope, last = embed(bb, cfg, input_ids, attention_mask, pixel_values,
                               image_grid_hws)
    return moon.decoder_taps(bb, cfg.text, hidden, rope, last, attention_mask)


class KimiVLStages(moon.CascadeStages):
    """Kimi-VL's pieces of the early-exit model: Moonlight's (its decoder
    layers, heads, classifier and cascade state), with ``embed`` running
    the vision tower over every row's page and splicing it in. Each row
    brings its patch rows (``pixel_values``, (B, P, 588)) and its patch
    grid (``image_grid_hws``, (B, 2))."""

    def __init__(self, cfg: KimiVLConfig):
        super().__init__(cfg.text)
        self.vl = cfg

    def module(self) -> KimiVLModel:
        return KimiVLModel(self.vl)

    def forward(self, model, order, input_ids, bbox, pixel_values, attention_mask,
                deterministic, rng, collect_hidden, seq_pad_multiple, image_grid_hws=None):
        taps = last_token_states(model.backbone, self.vl, input_ids, attention_mask,
                                 pixel_values, self._grid(image_grid_hws))
        return [taps[layer - 1] for layer in order], taps[-1], None

    def embed(self, model, input_ids, bbox, pixel_values, attention_mask,
              image_grid_hws=None):
        hidden, rope, last = embed(model.backbone, self.vl, input_ids, attention_mask,
                                   pixel_values, self._grid(image_grid_hws))
        return [hidden, attention_mask, last], {}, rope

    @staticmethod
    def _grid(image_grid_hws):
        if image_grid_hws is None:
            raise ValueError("a Kimi-VL backbone reads each row's page: pass its patch rows as "
                             "pixel_values and its patch grid as image_grid_hws")
        return image_grid_hws
