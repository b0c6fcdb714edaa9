"""EE LayoutLMv3 forward in plain PyTorch (float32), after HF
``LayoutLMv3Model`` (text and patch embeddings, post-LN encoder with the 1D
and 2D relative-position biases added to the scores over sqrt(d)) and the
early-exit model the configuration states: embedding exits on the mean of a
modality's embeddings, encoder exits on the [CLS] state after their layer,
heads of dropout, dense, tanh, dropout, projection, and the classifier.

Two switches serve the benchmark's checks. ``drop`` (a ``Dropout``) turns on
the training dropouts with given seeds; its row offset lets a batch run in
blocks of rows with each element's mask unchanged. ``fp8`` rounds every
operand of every matrix product to float8 e4m3 with a per-tensor scale (the
precision control); the gradient passes the rounding straight through.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

from h100bench.reference.hashing import keep_scale

NEG = torch.finfo(torch.float32).min
EMB_EXITS = ("vision_avg", "text_avg", "text_visual_concat")


@contextlib.contextmanager
def full_f32():
    """TF32 off for matmuls and convolutions, restored afterwards."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (amax to 448),
    back in f32; straight through for the gradient."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    y = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (y - x).detach()


class Dropout:
    """The training dropouts of one forward: ``seeds`` in the order the
    model draws them (text embeddings, the concatenated sequence, then per
    layer attention probabilities, attention output and MLP output, then
    each exit head's two and the classifier's two), the rate, the batch row
    of this block's first row, and the encoder's padded width, which lays
    out the rows of its hidden-state masks."""

    def __init__(self, seeds, cfg: dict, row0: int, enc_width: int):
        self.seeds, self.row0, self.enc_width = list(seeds), row0, enc_width
        self.rate = cfg["hidden_dropout_prob"]
        self.attn_rate = cfg["attention_probs_dropout_prob"]
        head = cfg.get("classifier_dropout")
        self.head_rate = self.rate if head is None else head
        self.at = 0

    def seed(self) -> int:
        s = self.seeds[self.at]
        self.at += 1
        return s

    def hidden(self, x: torch.Tensor, seed: int, width: Optional[int] = None,
               rate: Optional[float] = None) -> torch.Tensor:
        """x (B, S, H) or (B, H): element (b, s, c) hashes row
        (row0 + b) * width + s, column c, plane 0."""
        dev = x.device
        b = torch.arange(x.shape[0], device=dev) + self.row0
        if x.ndim == 2:
            rows = b[:, None]
        else:
            rows = (b[:, None] * (width or x.shape[1]) + torch.arange(x.shape[1], device=dev))[..., None]
        cols = torch.arange(x.shape[-1], device=dev)
        return x * keep_scale(seed, self.rate if rate is None else rate, 0, rows, cols)

    def probs(self, p: torch.Tensor, seed: int) -> torch.Tensor:
        """p (B, H, S, S): plane (row0 + b) * H + h, row i, column j."""
        dev = p.device
        b, h, s, _ = p.shape
        plane = ((torch.arange(b, device=dev) + self.row0)[:, None] * h
                 + torch.arange(h, device=dev))[:, :, None, None]
        idx = torch.arange(s, device=dev)
        return p * keep_scale(seed, self.attn_rate, plane, idx[:, None], idx[None, :])


def bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """Bidirectional T5 bucketing (HF ``relative_position_bucket``)."""
    half = num_buckets // 2
    ret = (rel > 0).long() * half
    n = rel.abs()
    max_exact = half // 2
    large = max_exact + (torch.log(n.float() / max_exact) / math.log(max_distance / max_exact)
                         * (half - max_exact)).long()
    large = torch.clamp(large, max=half - 1)
    return ret + torch.where(n < max_exact, n, large)


def visual_boxes(side: int, device, max_len: int = 1000) -> torch.Tensor:
    """(side^2 + 1, 4) boxes of the [CLS] patch and the patch grid."""
    edges = torch.div(torch.arange(0, max_len * (side + 1), max_len, device=device), side,
                      rounding_mode="trunc")
    x0, x1 = edges[:-1].repeat(side, 1), edges[1:].repeat(side, 1)
    grid = torch.stack([x0, x0.T, x1, x1.T], dim=-1).view(-1, 4)
    cls = torch.tensor([[1, 1, max_len - 1, max_len - 1]], device=device)
    return torch.cat([cls, grid])


class Model:
    """The reference over a weight dict (the harness's names), in f32."""

    def __init__(self, w: dict, cfg: dict, fp8_products: bool = False):
        self.w, self.cfg, self.q = w, cfg, fp8_products

    def lin(self, x, name):
        wt, b = self.w[f"{name}.weight"], self.w[f"{name}.bias"]
        if self.q:
            x, wt = fp8(x), fp8(wt)
        return x @ wt.T + b

    def mm(self, a, b):
        return (fp8(a) @ fp8(b)) if self.q else a @ b

    def ln(self, x, name, eps):
        return F.layer_norm(x, (x.shape[-1],), self.w[f"{name}.weight"], self.w[f"{name}.bias"], eps)

    def head(self, x, name, drop):
        if f"{name}.dense.weight" in self.w:
            if drop:
                x = drop.hidden(x, drop.seed(), rate=drop.head_rate)
            x = torch.tanh(self.lin(x, f"{name}.dense"))
        if drop:
            x = drop.hidden(x, drop.seed(), rate=drop.head_rate)
        return self.lin(x, f"{name}.out_proj")

    def spatial(self, e: str, bbox: torch.Tensor) -> torch.Tensor:
        """The six-way layout embedding of (B, S, 4) boxes: left, upper,
        right, lower, height, width."""
        w = self.w
        return torch.cat([
            w[f"{e}.x_position_embeddings"][bbox[..., 0]], w[f"{e}.y_position_embeddings"][bbox[..., 1]],
            w[f"{e}.x_position_embeddings"][bbox[..., 2]], w[f"{e}.y_position_embeddings"][bbox[..., 3]],
            w[f"{e}.h_position_embeddings"][torch.clamp(bbox[..., 3] - bbox[..., 1], 0, 1023)],
            w[f"{e}.w_position_embeddings"][torch.clamp(bbox[..., 2] - bbox[..., 0], 0, 1023)],
        ], dim=-1)

    def relative_bias(self, pos, boxes, mask, scale: float, enc: str = "backbone.encoder"):
        """(B, H, S, S): the 1D bias of the position ids ``pos`` (S,), the 2D
        bias of the boxes' x0 and y1, times ``scale``, and the key mask."""
        cfg, w = self.cfg, self.w
        b1 = w[f"{enc}.rel_pos_bias"][bucket(pos[None, :] - pos[:, None], cfg["rel_pos_bins"],
                                             cfg["max_rel_pos"])]          # (S, S, H)
        cx, cy = boxes[..., 0], boxes[..., 3]
        bins2, max2 = cfg["rel_2d_pos_bins"], cfg["max_rel_2d_pos"]
        b2 = (w[f"{enc}.rel_pos_x_bias"][bucket(cx[:, None, :] - cx[:, :, None], bins2, max2)]
              + w[f"{enc}.rel_pos_y_bias"][bucket(cy[:, None, :] - cy[:, :, None], bins2, max2)])
        bias = ((b1[None] + b2) * scale).permute(0, 3, 1, 2)
        return bias + ((1 - mask.long()) * NEG).to(torch.float32)[:, None, None, :]

    def encoder(self, x, bias, drop: Optional[Dropout] = None, enc: str = "backbone.encoder"):
        """The post-LN layers over (B, S, H): (the output, the [CLS] state
        after each layer)."""
        cfg = self.cfg
        b, s, hid = x.shape
        heads = cfg["num_attention_heads"]
        d = hid // heads
        eps = cfg["layer_norm_eps"]
        taps = []
        for i in range(cfg["num_hidden_layers"]):
            lp = f"{enc}.layers.{i}"
            seeds = (drop.seed(), drop.seed(), drop.seed()) if drop else None

            def split(y):
                return y.view(b, s, heads, d).transpose(1, 2)

            q = split(self.lin(x, f"{lp}.attention.query"))
            k = split(self.lin(x, f"{lp}.attention.key"))
            val = split(self.lin(x, f"{lp}.attention.value"))
            scores = self.mm(q / math.sqrt(d), k.transpose(-1, -2)) + bias
            probs = torch.softmax(scores, dim=-1)
            if drop:
                probs = drop.probs(probs, seeds[0])
            ctx = self.mm(probs, val).transpose(1, 2).reshape(b, s, hid)
            a = self.lin(ctx, f"{lp}.attention.output")
            if drop:
                a = drop.hidden(a, seeds[1], drop.enc_width)
            a = self.ln(a + x, f"{lp}.attention.output_LayerNorm", eps)
            y = self.lin(F.gelu(self.lin(a, f"{lp}.intermediate")), f"{lp}.output")
            if drop:
                y = drop.hidden(y, seeds[2], drop.enc_width)
            x = self.ln(y + a, f"{lp}.output_LayerNorm", eps)
            taps.append(x[:, 0])
        return x, taps

    def forward(self, ids, bbox, pixels, mask, drop: Optional[Dropout] = None):
        """{'exit_inputs': [(B, H)] per exit then the final [CLS] state,
        'logits': (E + 1, B, K): each exit's head, then the classifier}."""
        cfg, w = self.cfg, self.w
        dev = ids.device
        b, t = ids.shape
        hid, heads = cfg["hidden_size"], cfg["num_attention_heads"]
        d = hid // heads
        e = "backbone.embeddings"
        ids = ids.long()
        bbox = bbox.long()
        not_pad = (ids != cfg["pad_token_id"]).long()
        pos_abs = torch.cumsum(not_pad, 1) * not_pad + cfg["pad_token_id"]
        spatial = self.spatial(e, bbox)
        text = (w[f"{e}.word_embeddings"][ids] + w[f"{e}.token_type_embeddings"][0]
                + w[f"{e}.position_embeddings"][pos_abs] + spatial)
        text = self.ln(text, f"{e}.LayerNorm", cfg["layer_norm_eps"])
        if drop:
            text = drop.hidden(text, drop.seed())

        v = "backbone.visual"
        p = cfg["patch_size"]
        kernel = w[f"{v}.patch_embed.weight"].view(hid, cfg["num_channels"], p, p)
        px = pixels.float()
        if self.q:
            px, kernel = fp8(px), fp8(kernel)
        patches = F.conv2d(px, kernel, w[f"{v}.patch_embed.bias"], stride=p)
        patches = patches.flatten(2).transpose(1, 2)
        vis = torch.cat([w[f"{v}.cls_token"].expand(b, 1, hid), patches], 1) + w[f"{v}.pos_embed"]
        vis = self.ln(vis, f"{v}.norm", 1e-6)

        x = self.ln(torch.cat([text, vis], 1), "backbone.LayerNorm", cfg["layer_norm_eps"])
        if drop:
            x = drop.hidden(x, drop.seed())
        emb_sources = {"vision_avg": vis, "text_avg": text, "text_visual_concat": x}

        # the relative-position bias, (B, H, S, S), shared by every layer
        n_vis = vis.shape[1]
        pos = torch.cat([torch.arange(t, device=dev), torch.arange(n_vis, device=dev)])
        side = cfg["input_size"] // p
        boxes = torch.cat([bbox, visual_boxes(side, dev)[None].expand(b, n_vis, 4)], 1)
        full_mask = torch.cat([mask.long(), torch.ones((b, n_vis), dtype=torch.long, device=dev)], 1)
        bias = self.relative_bias(pos, boxes, full_mask, 1.0 / math.sqrt(d))
        x, taps = self.encoder(x, bias, drop)

        exit_inputs, logits = [], []
        for name in (n for n in EMB_EXITS if n in cfg["exits"]):
            exit_inputs.append(emb_sources[name].mean(1))
            logits.append(self.head(exit_inputs[-1], f"embedding_exits.{name}", drop))
        for j, layer in enumerate(sorted(x for x in cfg["exits"] if isinstance(x, int))):
            exit_inputs.append(taps[layer - 1])
            logits.append(self.head(exit_inputs[-1], f"encoder_exits.{j}", drop))
        exit_inputs.append(x[:, 0])
        logits.append(self.head(exit_inputs[-1], "backbone.classifier", drop))
        return {"exit_inputs": exit_inputs, "logits": torch.stack(logits)}


def max_confidence(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=-1).amax(dim=-1)


@torch.no_grad()
def infer(w: dict, cfg: dict, batch: dict, block: int, fp8_products: bool = False) -> dict:
    """``Model.forward`` over a batch in blocks of ``block`` rows, no
    gradient: {'exit_inputs': [(N, H)], 'logits': (E + 1, N, K)}."""
    model = Model(w, cfg, fp8_products)
    n = batch["input_ids"].shape[0]
    outs = []
    with full_f32():
        for a in range(0, n, block):
            sl = slice(a, a + block)
            outs.append(model.forward(batch["input_ids"][sl], batch["bbox"][sl],
                                      batch["pixel_values"][sl], batch["attention_mask"][sl]))
    return {"exit_inputs": [torch.cat([o["exit_inputs"][j] for o in outs])
                            for j in range(len(outs[0]["exit_inputs"]))],
            "logits": torch.cat([o["logits"] for o in outs], dim=1)}
