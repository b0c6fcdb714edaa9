"""LayoutLMv2 in PyTorch: parameter modules and the forward path.

The counterpart of the JAX package's ``models/layoutlmv2/modeling.py``.
Parity target: HF ``LayoutLMv2ForSequenceClassification``
(microsoft/layoutlmv2-base-uncased), the model the reference builds through
AutoModel (EE/configs.py:451-462), as a dense classifier with no exits.

Shared with the LayoutLMv3 port (``layoutlmv3.modeling``):

- the encoder (post-LN layers, exact GELU): ``Encoder`` and
  ``encoder_apply``, with a plain (B, H, P, P) bias tensor in every layer,
  so on the card each layer runs ``flash_attention_packed`` (or the
  training kernels at attention dropout above 0) and the bias builder's
  backward ``table_grads``. v2 never builds a chained, tables or fused
  context: ``MMEE_FUSED_BIAS``, ``MMEE_TABLE_GRADS`` and
  ``MMEE_CHAINED_DBIAS`` do not apply, as in the JAX package;
- the relative 1D/2D bias (``make_attention_bias``, ``materialize_bias`` on
  the card), added unscaled (``encoder_cfg().scale_bias`` is False);
- the text-embedding parameters (``TextEmbeddings``) and the 6-way spatial
  embedding; v2's position ids are a plain arange, not RoBERTa's.

v2's own:

- the visual tower, a ResNeXt-FPN: a 7x7/2 stem, a 3x3/2 max pool,
  bottleneck stages with grouped 3x3 convolutions and frozen-BN affines,
  the FPN's lateral 1x1 convolutions, a nearest top-down pass and the p2
  3x3 convolution, p2 average-pooled to ``image_feature_pool_shape``. The
  convolutions are ``F.conv2d`` (cuDNN on the card), as the JAX package's
  are ``lax.conv_general_dilated`` in XLA, not Pallas. The frozen-BN
  affines and the pixel mean and std are ``nn.Parameter``s: they are leaves
  of the JAX parameter tree, which the optimizer updates;
- the visual embeddings: pooled features -> ``visual_proj`` + position +
  the spatial embedding of the grid's boxes, with their own LayerNorm;
- the head: concat([CLS], the mean of the initial visual embeddings, the
  mean of the final visual states) -> dropout -> Linear(3H, K).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from multi_modal_early_exit_tpu_torch.device import resolve_device
from multi_modal_early_exit_tpu_torch.models.layoutlmv2.config import LayoutLMv2Config
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import (
    Encoder,
    LayerNorm,
    Linear,
    RngStream,
    TextEmbeddings,
    _empty,
    dropout,
    encoder_apply,
    make_attention_bias,
    pad_sequence,
    reset_parameters,
    spatial_position_embeddings,
)
from multi_modal_early_exit_tpu_torch.training.losses import batch_to_device, cross_entropy
from multi_modal_early_exit_tpu_torch.utils.profiling import span

# detectron2 normalizes inside the backbone (BGR means and stds)
PIXEL_MEAN = (103.53, 116.28, 123.675)
PIXEL_STD = (57.375, 57.12, 58.395)


# ---------------------------------------------------------------------------
# visual tower: ResNeXt-FPN with frozen-BN affines (detectron2 equivalent)
# ---------------------------------------------------------------------------


def _conv(c_out: int, c_in: int, k: int) -> nn.Parameter:
    """An OIHW convolution weight, the JAX tree's and torch's layout."""
    return _empty(c_out, c_in, k, k)


class FrozenBN(nn.Module):
    """detectron2 FrozenBatchNorm2d as a per-channel affine
    y = x * weight + bias (the JAX tree's ``scale`` is ``weight``); the
    identity at random init."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = _empty(c)
        self.bias = _empty(c)

    def reset_parameters(self, generator: torch.Generator, std: float) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight[None, :, None, None] + self.bias[None, :, None, None]


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, c_mid: int, c_out: int, groups: int, stride: int):
        super().__init__()
        self.groups, self.stride = groups, stride
        self.conv1 = _conv(c_mid, c_in, 1)
        self.bn1 = FrozenBN(c_mid)
        self.conv2 = _conv(c_mid, c_mid // groups, 3)
        self.bn2 = FrozenBN(c_mid)
        self.conv3 = _conv(c_out, c_mid, 1)
        self.bn3 = FrozenBN(c_out)
        if stride != 1 or c_in != c_out:
            self.shortcut = _conv(c_out, c_in, 1)
            self.shortcut_bn = FrozenBN(c_out)
        else:
            self.shortcut = self.shortcut_bn = None

    def reset_parameters(self, generator: torch.Generator, std: float) -> None:
        with torch.no_grad():
            for p in self._parameters.values():
                if p is not None:
                    p.normal_(0.0, std, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(F.conv2d(x, self.conv1)))
        out = F.relu(self.bn2(F.conv2d(out, self.conv2, stride=self.stride, padding=1,
                                       groups=self.groups)))
        out = self.bn3(F.conv2d(out, self.conv3))
        if self.shortcut is not None:
            x = self.shortcut_bn(F.conv2d(x, self.shortcut, stride=self.stride))
        return F.relu(out + x)


class ConvBias(nn.Module):
    """A convolution weight with a per-channel bias (the FPN's)."""

    def __init__(self, c_out: int, c_in: int, k: int):
        super().__init__()
        self.conv = _conv(c_out, c_in, k)
        self.bias = _empty(c_out)

    def reset_parameters(self, generator: torch.Generator, std: float) -> None:
        with torch.no_grad():
            self.conv.normal_(0.0, std, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, padding: int = 0) -> torch.Tensor:
        return F.conv2d(x, self.conv, padding=padding) + self.bias[None, :, None, None]


class VisualBackbone(nn.Module):
    """The ResNeXt-FPN's parameters; ``stages[s][b]`` is block b of stage
    s, ``fpn_lateral[s]`` stage s's lateral 1x1 convolution."""

    def __init__(self, cfg: LayoutLMv2Config):
        super().__init__()
        stem_c = cfg.backbone_stem_channels
        self.stem_conv = _conv(stem_c, 3, 7)
        self.stem_bn = FrozenBN(stem_c)
        self.pixel_mean = _empty(1, 3, 1, 1)
        self.pixel_std = _empty(1, 3, 1, 1)
        c_in = stem_c
        stages, lateral = [], []
        for s, depth in enumerate(cfg.backbone_depths):
            c_mid = cfg.backbone_groups * cfg.backbone_width_per_group * (2 ** s)
            c_out = stem_c * 4 * (2 ** s)
            blocks = []
            for b in range(depth):
                blocks.append(Bottleneck(c_in, c_mid, c_out, cfg.backbone_groups,
                                         stride=2 if (b == 0 and s > 0) else 1))
                c_in = c_out
            stages.append(nn.ModuleList(blocks))
            lateral.append(ConvBias(cfg.fpn_channels, c_out, 1))
        self.stages = nn.ModuleList(stages)
        self.fpn_lateral = nn.ModuleList(lateral)
        # only the finest level ("p2") is consumed: only its 3x3 output conv
        self.fpn_output_p2 = ConvBias(cfg.fpn_channels, cfg.fpn_channels, 3)

    def reset_parameters(self, generator: torch.Generator, std: float) -> None:
        with torch.no_grad():
            self.stem_conv.normal_(0.0, std, generator=generator)
            self.pixel_mean.copy_(torch.tensor(PIXEL_MEAN)[None, :, None, None])
            self.pixel_std.copy_(torch.tensor(PIXEL_STD)[None, :, None, None])


def visual_backbone_apply(
    p: VisualBackbone, cfg: LayoutLMv2Config, images: torch.Tensor
) -> torch.Tensor:
    """(B, 3, H, W) images -> (B, pool_h * pool_w, fpn_channels) features:
    the ResNeXt stages, the FPN (lateral 1x1, nearest top-down, the p2 3x3
    output), p2 average-pooled to ``image_feature_pool_shape`` (HF
    LayoutLMv2VisualBackbone.forward). Images are cast to the weights'
    dtype first."""
    x = images.to(p.stem_conv.dtype)
    x = (x - p.pixel_mean) / p.pixel_std
    x = F.relu(p.stem_bn(F.conv2d(x, p.stem_conv, stride=2, padding=3)))
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)  # pads with -inf
    feats = []
    for blocks in p.stages:
        for blk in blocks:
            x = blk(x)
        feats.append(x)
    laterals = [lat(f) for lat, f in zip(p.fpn_lateral, feats)]
    out = laterals[-1]
    for lvl in range(len(laterals) - 2, -1, -1):
        h, w = laterals[lvl].shape[2:]
        up = out.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)[:, :, :h, :w]
        out = laterals[lvl] + up
    p2 = p.fpn_output_p2(out, padding=1)
    ph, pw = cfg.image_feature_pool_shape[0], cfg.image_feature_pool_shape[1]
    b, c, h, w = p2.shape
    if h % ph or w % pw:
        raise ValueError(f"backbone output {h}x{w} must divide the pool shape {ph}x{pw}")
    pooled = p2.reshape(b, c, ph, h // ph, pw, w // pw).mean(dim=(3, 5))
    return pooled.reshape(b, c, ph * pw).transpose(1, 2)  # (B, 49, C)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class LayoutLMv2Model(nn.Module):
    """LayoutLMv2's parameters, uninitialised, on ``device`` (``cuda`` by
    default); ``init_params`` or ``convert.load_jax_params`` fills them.
    Attribute names follow the JAX parameter tree."""

    def __init__(self, cfg: LayoutLMv2Config, device=None):
        super().__init__()
        device = resolve_device(device)
        enc_cfg = cfg.encoder_cfg()
        self.embeddings = TextEmbeddings(enc_cfg)
        self.visual_backbone = VisualBackbone(cfg)
        self.visual_proj = Linear(cfg.image_feature_pool_shape[2], cfg.hidden_size)
        self.visual_LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.encoder = Encoder(enc_cfg)
        self.classifier = Linear(3 * cfg.hidden_size, cfg.num_labels)
        self.visual_segment_embedding = (
            _empty(cfg.hidden_size) if cfg.has_visual_segment_embedding else None)
        self.to(device)

    def reset_parameters(self, generator: torch.Generator, std: float) -> None:
        if self.visual_segment_embedding is not None:
            with torch.no_grad():
                self.visual_segment_embedding.normal_(0.0, std, generator=generator)

    def forward(self, cfg: LayoutLMv2Config, *args, **kwargs) -> "LayoutLMv2Output":
        """``forward_sequence_classification(self, cfg, ...)``, so that
        ``torch.func.functional_call`` can run the model on other parameters
        (the training loss's bf16 copies)."""
        return forward_sequence_classification(self, cfg, *args, **kwargs)


def init_params(
    cfg: LayoutLMv2Config,
    generator: Optional[torch.Generator] = None,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> LayoutLMv2Model:
    """Random parameters from a (CPU) ``generator`` (seed 0 if none), with
    the JAX package's shapes and std (identity frozen-BN affines,
    detectron2's pixel mean and std), on ``device`` in ``dtype``."""
    device = resolve_device(device)
    model = LayoutLMv2Model(cfg, device="cpu")
    reset_parameters(model, generator or torch.Generator().manual_seed(0),
                     cfg.initializer_range)
    return model.to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def visual_grid_bbox(cfg: LayoutLMv2Config, device=None, max_len: int = 1000) -> torch.Tensor:
    """(pool_h * pool_w, 4) int32 boxes of the pool-grid visual tokens on
    the 0-1000 grid, no [CLS] box (parity: LayoutLMv2Model._calc_visual_bbox)."""
    ph, pw = cfg.image_feature_pool_shape[0], cfg.image_feature_pool_shape[1]
    ex = torch.arange(0, max_len * (pw + 1), max_len, device=device) // pw
    ey = torch.arange(0, max_len * (ph + 1), max_len, device=device) // ph
    x0 = ex[:-1].repeat(ph, 1)
    x1 = ex[1:].repeat(ph, 1)
    y0 = ey[:-1].repeat(pw, 1).T
    y1 = ey[1:].repeat(pw, 1).T
    return torch.stack([x0, y0, x1, y1], dim=-1).reshape(-1, 4).to(torch.int32)


def embed_text_v2(
    p: TextEmbeddings,
    cfg: LayoutLMv2Config,
    input_ids: torch.Tensor,
    bbox: torch.Tensor,
    token_type_ids: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    rngs: Optional[RngStream] = None,
) -> torch.Tensor:
    """word + plain-arange position + 6-way spatial + token type, LayerNorm,
    dropout (parity: LayoutLMv2Model._calc_text_embeddings; not RoBERTa's
    skip-padding position ids)."""
    input_ids = input_ids.long()
    b, s = input_ids.shape
    position_ids = torch.arange(s, device=input_ids.device).expand(b, s)
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    x = p.word_embeddings[input_ids]
    x = x + p.position_embeddings[position_ids]
    x = x + spatial_position_embeddings(p, bbox)
    x = x + p.token_type_embeddings[token_type_ids.long()]
    x = p.LayerNorm(x)
    return dropout(x, cfg.hidden_dropout_prob, deterministic, rngs.next() if rngs else None)


def embed_vision_v2(
    p: LayoutLMv2Model,
    cfg: LayoutLMv2Config,
    pixel_values: torch.Tensor,
    deterministic: bool = True,
    rngs: Optional[RngStream] = None,
) -> torch.Tensor:
    """The tower's pooled features -> ``visual_proj`` + position + the
    grid boxes' spatial embedding (+ the visual segment embedding), then
    the visual LayerNorm and dropout (parity:
    LayoutLMv2Model._calc_img_embeddings)."""
    with span("v2.tower"):
        feats = visual_backbone_apply(p.visual_backbone, cfg, pixel_values)
    x = p.visual_proj(feats)
    b, n = x.shape[0], x.shape[1]
    x = x + p.embeddings.position_embeddings[:n][None]
    vb = visual_grid_bbox(cfg, x.device)[None].expand(b, n, 4)
    x = x + spatial_position_embeddings(p.embeddings, vb)
    if p.visual_segment_embedding is not None:
        x = x + p.visual_segment_embedding[None, None, :]
    x = p.visual_LayerNorm(x)
    return dropout(x, cfg.hidden_dropout_prob, deterministic, rngs.next() if rngs else None)


# ---------------------------------------------------------------------------
# the full model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LayoutLMv2Output:
    logits: torch.Tensor                     # (B, K)
    last_hidden_state: torch.Tensor          # (B, S', H), S' = S_text + S_vis or padded
    initial_visual_embeddings: torch.Tensor  # (B, S_vis, H)


def sequence_layout(
    cfg: LayoutLMv2Config, bbox: torch.Tensor, attention_mask: torch.Tensor, s_v: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Boxes, position ids and mask of the text + visual sequence: the
    visual tokens take the grid's boxes and position ids restarting at 0."""
    b, s_t = attention_mask.shape
    dev = attention_mask.device
    vis_bb = visual_grid_bbox(cfg, dev)[None].expand(b, s_v, 4)
    full_bbox = torch.cat([bbox.to(torch.int32), vis_bb], dim=1)
    pos = torch.cat([torch.arange(s_t, device=dev).expand(b, s_t),
                     torch.arange(s_v, device=dev).expand(b, s_v)], dim=1).to(torch.int32)
    full_mask = torch.cat([attention_mask.to(torch.int32),
                           torch.ones((b, s_v), dtype=torch.int32, device=dev)], dim=1)
    return full_bbox, pos, full_mask


def forward_sequence_classification(
    p: LayoutLMv2Model,
    cfg: LayoutLMv2Config,
    input_ids: torch.Tensor,
    bbox: torch.Tensor,
    pixel_values: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    rng: Optional[torch.Generator] = None,
    seq_pad_multiple: Optional[int] = None,
) -> LayoutLMv2Output:
    """Text + visual sequence -> the encoder with the unscaled relative bias
    -> concat([CLS], mean initial visual, mean final visual) -> classifier
    (parity: LayoutLMv2ForSequenceClassification.forward).
    ``seq_pad_multiple`` pads the sequence once before the encoder (padded
    positions carry mask 0); the bias is built at a multiple of 128 either
    way. With ``deterministic=False`` the dropout seeds come from ``rng``."""
    rngs = RngStream(None if deterministic else rng, getattr(p, "mesh", None))
    enc_cfg = cfg.encoder_cfg()
    b, s_t = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, s_t), dtype=torch.int32, device=input_ids.device)
    text_emb = embed_text_v2(p.embeddings, cfg, input_ids, bbox,
                             deterministic=deterministic, rngs=rngs)
    vis_emb = embed_vision_v2(p, cfg, pixel_values, deterministic=deterministic, rngs=rngs)
    s_v = vis_emb.shape[1]
    hidden = torch.cat([text_emb, vis_emb], dim=1)
    full_bbox, pos, full_mask = sequence_layout(cfg, bbox, attention_mask, s_v)
    if seq_pad_multiple:
        hidden, full_bbox, pos, full_mask = pad_sequence(
            seq_pad_multiple, hidden, full_bbox, pos, full_mask)
    bias = make_attention_bias(p, enc_cfg, pos, full_bbox, full_mask, dtype=hidden.dtype)
    final, _, _ = encoder_apply(p.encoder, enc_cfg, hidden, bias, collect_cls=False,
                                deterministic=deterministic, rng=rngs)
    head_in = torch.cat([final[:, 0, :], vis_emb.mean(dim=1),
                         final[:, s_t:s_t + s_v, :].mean(dim=1)], dim=-1)
    head_in = dropout(head_in, cfg.hidden_dropout_prob, deterministic, rngs.next())
    return LayoutLMv2Output(logits=p.classifier(head_in), last_hidden_state=final,
                            initial_visual_embeddings=vis_emb)


def sequence_classification_loss(
    model: LayoutLMv2Model,
    cfg: LayoutLMv2Config,
    batch: Dict,
    rng: Optional[torch.Generator] = None,
    exit_weights=None,  # unused: a dense model (``ee_loss_fn``'s signature)
    deterministic: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
):
    """Cross-entropy of the dense classifier, with ``ee_loss_fn``'s
    signature, so that ``EETrainer`` trains v2 (the reference trains dense
    AutoModels through its generic trainer, EE/IC_only.py:176-178).
    ``compute_dtype`` casts the floating parameters and the pixels inside
    the differentiated function, as ``ee_loss_fn`` does. Returns ``(loss,
    {"logits"})``; the sequence is not padded, as in the JAX package."""
    device = resolve_device(device)
    param_device = next(model.parameters()).device
    if param_device.type != device.type or device.index not in (None, param_device.index):
        raise ValueError(f"the model lives on {param_device}, the loss runs on {device}")
    batch = batch_to_device(batch, device)
    args = (cfg, batch["input_ids"], batch["bbox"])
    kwargs = dict(attention_mask=batch.get("attention_mask"), deterministic=deterministic,
                  rng=rng)
    pixel_values = batch["pixel_values"]
    if compute_dtype is not None:
        params = {n: q.to(compute_dtype) if q.is_floating_point() else q
                  for n, q in model.named_parameters()}
        out = functional_call(model, params, (*args, pixel_values.to(compute_dtype)), kwargs)
    else:
        out = forward_sequence_classification(model, *args, pixel_values, **kwargs)
    logits = out.logits.to(torch.float32)
    return cross_entropy(logits, batch["labels"]), {"logits": logits}
