"""Early-exit Kimi-VL-A3B-Instruct in plain PyTorch (float32), after the
public MoonViT and Kimi-VL modeling code at the configuration's keys: the
vision tower one page at a time, then Moonlight's decoder
(``reference/moonlight.py``) on each row's tokens with the page spliced in.

A page (its h x w real patch rows, each 3 x 14 x 14 values):

- the patch embedding as the published 14 x 14 convolution at stride 14,
  with its bias, over each patch;
- the position table added as it is at its own 64 x 64 grid, otherwise
  interpolated bicubically to h x w (``align_corners`` False), in f64
  (``F.interpolate``'s f32 kernels round its weights to about 3e-5 of the
  table's scale);
- per layer LayerNorm, q/k/v from one product with its bias, the 2D rotary
  embedding in the published complex form (each adjacent pair of a head's
  72 dims one complex number, times exp(i col theta^(-4j/72)) at pair 2j
  and exp(i row theta^(-4j/72)) at pair 2j + 1), attention over the page's
  own patches at scale 72^-0.5, dense, computed in blocks of ``block``
  query rows so that 4,096 patches fit, the output product with its bias,
  the residual; LayerNorm, fc0, tanh-approximated GELU, fc1, the residual;
  a final LayerNorm;
- the projector: LayerNorm on each patch, each 2 x 2 block of patches
  concatenated (its rows in order) into one 4,608-value token, Linear,
  exact GELU, Linear to the decoder's 2,048.

The row's token embeddings (its ids looked up in the table) have their
placeholder positions replaced, in order, by the page's tokens; the decoder
then runs on those embeddings as ``reference/moonlight.py`` runs on a
document's, with plain 1D positions (its forward looks each row up in a
table of the spliced embeddings). ``routes`` forces the program's expert
choices, as there.

Departures from the published description: none in the arithmetic; the
language model's head is dropped for the early-exit heads, as Moonlight's
reference does, and the weights are cast to f32 from the served bf16 copy
a layer at a time. ``fp8`` rounds every operand of every matrix product
(the patch embedding, the attention's two products and the projector's
among them) to float8 e4m3 with a per-tensor scale (the precision
control). TF32 is off for matrix products and convolutions throughout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from h100bench.reference import moonlight as moon
from h100bench.reference.v3 import fp8, full_f32

TOWER, PROJ = "backbone.vision_tower.", "backbone.multi_modal_projector."


class Vision:
    """MoonViT and the projector over a weight dict (the harness's names)."""

    def __init__(self, w: dict, cfg: dict, fp8_products: bool = False, block: int = 1024):
        self.w, self.cfg, self.v, self.q, self.block = (w, cfg, cfg["vision_config"],
                                                        fp8_products, block)

    def p(self, name):
        return self.w[name].float()

    def mm(self, a, b):
        return (fp8(a) @ fp8(b)) if self.q else a @ b

    def lin(self, x, name):
        return self.mm(x, self.p(f"{name}.weight").T) + self.p(f"{name}.bias")

    def ln(self, x, name, eps):
        return F.layer_norm(x, (x.shape[-1],), self.p(f"{name}.weight"), self.p(f"{name}.bias"),
                            eps)

    def positions(self, h, w):
        table = self.p(TOWER + "patch_embed.pos_emb.weight")
        if (h, w) != tuple(table.shape[:2]):
            table = F.interpolate(table.double().permute(2, 0, 1)[None], size=(h, w),
                                  mode="bicubic", align_corners=False)[0].permute(1, 2, 0)
        return table.reshape(h * w, -1).float()

    def freqs_cis(self, h, w, device):
        """(h w, d/2) complex: pair 2j at the column, 2j + 1 at the row."""
        d = self.v["hidden_size"] // self.v["num_attention_heads"]
        freqs = 1.0 / self.v["rope_theta"] ** (torch.arange(0, d, 4, device=device)[:d // 4]
                                               .float() / d)
        rows, cols = torch.meshgrid(torch.arange(h, device=device).float(),
                                    torch.arange(w, device=device).float(), indexing="ij")
        x_cis = torch.polar(torch.ones(h * w, d // 4, device=device),
                            torch.outer(cols.reshape(-1), freqs))
        y_cis = torch.polar(torch.ones(h * w, d // 4, device=device),
                            torch.outer(rows.reshape(-1), freqs))
        return torch.stack([x_cis, y_cis], dim=-1).reshape(h * w, d // 2)

    @staticmethod
    def rotate(x, cis):
        """x (N, heads, d) as d/2 complex numbers a head, times cis (N, d/2)."""
        xc = torch.view_as_complex(x.reshape(*x.shape[:-1], -1, 2).contiguous())
        return torch.view_as_real(xc * cis[:, None, :]).flatten(-2)

    def attention(self, q, k, v):
        """(N, heads, d) each: every patch attends the page's, in blocks of
        query rows."""
        scale = q.shape[-1] ** -0.5
        q, k, v = (t.transpose(0, 1) for t in (q, k, v))
        out = []
        for a in range(0, q.shape[1], self.block):
            scores = self.mm(q[:, a:a + self.block], k.transpose(-1, -2)) * scale
            out.append(self.mm(torch.softmax(scores, dim=-1), v))
        return torch.cat(out, dim=1).transpose(0, 1)

    def page(self, rows: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """(h w / 4, text hidden) f32: one page's tokens from its h w patch
        rows."""
        v = self.v
        d, heads, eps, ps = (v["hidden_size"], v["num_attention_heads"], v["layer_norm_eps"],
                             v["patch_size"])
        n = h * w
        pixels = rows.float().reshape(n, v["num_channels"], ps, ps)
        weight, bias = self.p(TOWER + "patch_embed.proj.weight"), self.p(
            TOWER + "patch_embed.proj.bias")
        if self.q:
            pixels, weight = fp8(pixels), fp8(weight)
        x = F.conv2d(pixels, weight, bias, stride=ps).reshape(n, d)
        x = x + self.positions(h, w)
        cis = self.freqs_cis(h, w, x.device)
        for i in range(v["num_hidden_layers"]):
            b = f"{TOWER}encoder.blocks.{i}"
            qkv = self.lin(self.ln(x, f"{b}.norm0", eps), f"{b}.wqkv")
            qkv = qkv.view(n, 3, heads, d // heads)
            q, k = self.rotate(qkv[:, 0], cis), self.rotate(qkv[:, 1], cis)
            x = x + self.lin(self.attention(q, k, qkv[:, 2]).reshape(n, d), f"{b}.wo")
            hid = F.gelu(self.lin(self.ln(x, f"{b}.norm1", eps), f"{b}.mlp.fc0"),
                         approximate="tanh")
            x = x + self.lin(hid, f"{b}.mlp.fc1")
        x = self.ln(x, TOWER + "encoder.final_layernorm", eps)
        x = self.ln(x, PROJ + "pre_norm", self.cfg["projector_ln_eps"])
        kh, kw = v["merge_kernel_size"]
        x = x.view(h // kh, kh, w // kw, kw, d).permute(0, 2, 1, 3, 4).reshape(-1, kh * kw * d)
        return self.lin(F.gelu(self.lin(x, PROJ + "linear_1")), PROJ + "linear_2")


@torch.no_grad()
def infer(w: dict, cfg: dict, batch: dict, block: int, fp8_products: bool = False,
          routes=None) -> dict:
    """The model over a batch (``input_ids``, ``attention_mask`` right-padded;
    ``pixel_values`` (B, P, patch values), ``image_grid_hws`` (B, 2)), in
    blocks of ``block`` rows. {'vision': [(h w / 4, H)] each page's tokens,
    and ``reference/moonlight.py``'s 'exit_inputs', 'logits', 'chosen',
    'routes' over every row's real tokens with the page spliced in}."""
    vision = Vision(w, cfg, fp8_products)
    ids, mask = batch["input_ids"], batch["attention_mask"]
    grid = [tuple(g) for g in batch["image_grid_hws"].tolist()]
    lengths = mask.sum(dim=1).tolist()
    starts = [0]
    for n in lengths:
        starts.append(starts[-1] + n)
    table = w["backbone.embed_tokens.weight"]
    pages, outs = [], []
    with full_f32():
        for a in range(0, ids.shape[0], block):
            b = min(a + block, ids.shape[0])
            rows = []
            for r in range(a, b):
                h, wd = grid[r]
                pages.append(vision.page(batch["pixel_values"][r, :h * wd], h, wd))
                tok = ids[r, :lengths[r]].long()
                x = table[tok].float()
                slots = tok == cfg["media_placeholder_token_id"]
                if int(slots.sum()) != pages[-1].shape[0]:
                    raise ValueError(f"row {r} has {int(slots.sum())} placeholders for its "
                                     f"page's {pages[-1].shape[0]} tokens")
                x[slots] = pages[-1]
                rows.append(x)
            spliced = dict(w)
            spliced["backbone.embed_tokens.weight"] = torch.cat(rows)
            docs = [torch.arange(starts[r] - starts[a], starts[r + 1] - starts[a],
                                 device=ids.device) for r in range(a, b)]
            forced = None if routes is None else [t[starts[a]:starts[b]] for t in routes]
            outs.append(moon.Model(spliced, cfg, fp8_products).forward(docs, forced))
    return {"vision": pages,
            "exit_inputs": [torch.cat([o["exit_inputs"][j] for o in outs])
                            for j in range(len(outs[0]["exit_inputs"]))],
            "logits": torch.cat([o["logits"] for o in outs], dim=1),
            "chosen": [torch.cat([o["chosen"][j] for o in outs])
                       for j in range(len(outs[0]["chosen"]))],
            "routes": {"margin": max(o["routes"]["margin"] for o in outs),
                       "unlike": sum(o["routes"]["unlike"] for o in outs),
                       "pairs": sum(o["routes"]["pairs"] for o in outs)}}
