"""LayoutLMv2-base in plain PyTorch (float32), after HF
``LayoutLMv2ForSequenceClassification``: the ResNeXt-FPN visual tower of
detectron2 (frozen-BN affines, grouped 3x3 convolutions, lateral 1x1 and
top-down nearest FPN, the p2 3x3 output average-pooled to the 7x7 grid),
visual tokens of the projected grid features with their position and
layout embeddings, text embeddings with plain position ids, the encoder
with the relative 1D and 2D biases added unscaled, and the classifier on
[CLS], the mean initial visual embedding and the mean final visual state.
The encoder is v3's (``v3.Model.encoder``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from h100bench.reference.v3 import Model, fp8, full_f32

T = "visual_backbone"


def grid_boxes(ph: int, pw: int, device, max_len: int = 1000) -> torch.Tensor:
    """(ph * pw, 4) boxes of the pooled grid on the 0-1000 page."""
    ex = torch.div(torch.arange(0, max_len * (pw + 1), max_len, device=device), pw, rounding_mode="trunc")
    ey = torch.div(torch.arange(0, max_len * (ph + 1), max_len, device=device), ph, rounding_mode="trunc")
    x0, x1 = ex[:-1].repeat(ph, 1), ex[1:].repeat(ph, 1)
    y0, y1 = ey[:-1].repeat(pw, 1).T, ey[1:].repeat(pw, 1).T
    return torch.stack([x0, y0, x1, y1], dim=-1).reshape(-1, 4)


class Model2(Model):
    def conv(self, x, name, stride=1, padding=0, groups=1, bias=None):
        wt = self.w[name]
        if self.q:
            x, wt = fp8(x), fp8(wt)
        return F.conv2d(x, wt, bias, stride=stride, padding=padding, groups=groups)

    def affine(self, x, name):
        return x * self.w[f"{name}.weight"][None, :, None, None] + self.w[f"{name}.bias"][None, :, None, None]

    def tower(self, pixels) -> torch.Tensor:
        """(B, 3, H, W) pixels -> (B, ph * pw, fpn channels)."""
        cfg, w = self.cfg, self.w
        x = (pixels.float() - w[f"{T}.pixel_mean"]) / w[f"{T}.pixel_std"]
        x = F.relu(self.affine(self.conv(x, f"{T}.stem_conv", 2, 3), f"{T}.stem_bn"))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        levels = []
        for s, depth in enumerate(cfg["backbone_depths"]):
            for i in range(depth):
                p = f"{T}.stages.{s}.{i}"
                stride = 2 if (i == 0 and s > 0) else 1
                y = F.relu(self.affine(self.conv(x, f"{p}.conv1"), f"{p}.bn1"))
                y = F.relu(self.affine(self.conv(y, f"{p}.conv2", stride, 1, cfg["backbone_groups"]),
                                       f"{p}.bn2"))
                y = self.affine(self.conv(y, f"{p}.conv3"), f"{p}.bn3")
                if f"{p}.shortcut" in w:
                    x = self.affine(self.conv(x, f"{p}.shortcut", stride), f"{p}.shortcut_bn")
                x = F.relu(y + x)
            levels.append(x)
        lat = [self.conv(f, f"{T}.fpn_lateral.{s}.conv", bias=w[f"{T}.fpn_lateral.{s}.bias"])
               for s, f in enumerate(levels)]
        top = lat[-1]
        for s in range(len(lat) - 2, -1, -1):
            top = lat[s] + F.interpolate(top, size=lat[s].shape[2:], mode="nearest")
        p2 = self.conv(top, f"{T}.fpn_output_p2.conv", padding=1, bias=w[f"{T}.fpn_output_p2.bias"])
        ph, pw, _ = cfg["image_feature_pool_shape"]
        pooled = F.adaptive_avg_pool2d(p2, (ph, pw))
        return pooled.flatten(2).transpose(1, 2)

    def forward(self, ids, bbox, pixels, mask, drop=None):
        """{'logits': (1, B, K)}: the dense classifier's, as a one-row store."""
        cfg, w = self.cfg, self.w
        dev = ids.device
        b, t = ids.shape
        eps = cfg["layer_norm_eps"]
        ids, bbox = ids.long(), bbox.long()
        text = (w["embeddings.word_embeddings"][ids] + w["embeddings.position_embeddings"][:t]
                + self.spatial("embeddings", bbox) + w["embeddings.token_type_embeddings"][0])
        text = self.ln(text, "embeddings.LayerNorm", eps)
        feats = self.tower(pixels)
        n = feats.shape[1]
        ph, pw, _ = cfg["image_feature_pool_shape"]
        grid = grid_boxes(ph, pw, dev)[None].expand(b, n, 4)
        vis = (self.lin(feats, "visual_proj") + w["embeddings.position_embeddings"][:n]
               + self.spatial("embeddings", grid))
        vis = self.ln(vis, "visual_LayerNorm", eps)
        x = torch.cat([text, vis], 1)
        pos = torch.cat([torch.arange(t, device=dev), torch.arange(n, device=dev)])
        full_mask = torch.cat([mask.long(), torch.ones((b, n), dtype=torch.long, device=dev)], 1)
        bias = self.relative_bias(pos, torch.cat([bbox, grid], 1), full_mask, 1.0, enc="encoder")
        x, _ = self.encoder(x, bias, enc="encoder")
        head = torch.cat([x[:, 0], vis.mean(1), x[:, t:t + n].mean(1)], dim=-1)
        return {"logits": self.lin(head, "classifier")[None]}


@torch.no_grad()
def infer(w: dict, cfg: dict, batch: dict, block: int, fp8_products: bool = False) -> torch.Tensor:
    """The (1, N, K) logit store of a batch, in blocks of ``block`` rows."""
    model = Model2(w, cfg, fp8_products)
    n = batch["input_ids"].shape[0]
    out = []
    with full_f32():
        for a in range(0, n, block):
            sl = slice(a, a + block)
            out.append(model.forward(batch["input_ids"][sl], batch["bbox"][sl],
                                     batch["pixel_values"][sl], batch["attention_mask"][sl])["logits"])
    return torch.cat(out, dim=1)
