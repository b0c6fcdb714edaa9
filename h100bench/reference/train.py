"""Three training steps of the reference: the one_stage_subgraphs_weighted
loss (the final cross-entropy plus each exit's cross-entropy weighted by the
inverse parameter count of its compute subgraph, normalised; gamma 0),
its gradient by autograd in f32, and AdamW (b1 0.9, b2 0.999, eps 1e-8,
no weight decay) at a learning rate that falls linearly to 0 over the run's
total steps. The batch runs in blocks of rows; each block's share of the
mean loss is differentiated and the gradients summed."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from h100bench.reference.v3 import Dropout, Model, full_f32

BIAS_TABLES = ("rel_pos_bias", "rel_pos_x_bias", "rel_pos_y_bias")


def subgraph_counts(w: dict, cfg: dict) -> list:
    """Parameters of each exit's compute subgraph, canonical exit order:
    a modality exit counts its tower and its head; an encoder exit counts
    both towers, the concatenated LayerNorm, the bias tables, its layers,
    every earlier exit's head and its own."""
    def count(prefixes):
        return sum(t.numel() for n, t in w.items() if n.startswith(prefixes))

    vision, text = count("backbone.visual."), count("backbone.embeddings.")
    concat = count("backbone.LayerNorm.")
    tables = sum(w[f"backbone.encoder.{t}"].numel() for t in BIAS_TABLES)
    out, prior = [], 0
    emb = [e for e in ("vision_avg", "text_avg", "text_visual_concat") if e in cfg["exits"]]
    for name in emb:
        head = count(f"embedding_exits.{name}.")
        base = {"vision_avg": vision, "text_avg": text,
                "text_visual_concat": vision + text + concat}[name]
        out.append(base + head)
        prior += head
    for j, layer in enumerate(sorted(e for e in cfg["exits"] if isinstance(e, int))):
        head = count(f"encoder_exits.{j}.")
        layers = count(tuple(f"backbone.encoder.layers.{i}." for i in range(layer)))
        out.append(vision + text + concat + tables + layers + prior + head)
        prior += head
    return out


def exit_weights(w: dict, cfg: dict) -> torch.Tensor:
    inv = torch.tensor([1.0 / c for c in subgraph_counts(w, cfg)], dtype=torch.float64)
    return (inv / inv.sum()).float()


def loss_and_grads(w: dict, cfg: dict, batch: dict, seeds, enc_width: int, block: int,
                   fp8_products: bool = False, rows=None):
    """(loss, {name: gradient}) of one step over ``batch``; ``rows``
    restricts the mean to those rows (a fault the checks are shown to
    catch)."""
    leaves = {n: t.detach().clone().requires_grad_() for n, t in w.items()}
    model = Model(leaves, cfg, fp8_products)
    weights = exit_weights(w, cfg).to(next(iter(w.values())).device)
    n = batch["input_ids"].shape[0]
    use = torch.ones(n, dtype=torch.bool) if rows is None else rows
    total = 0.0
    with full_f32():
        for a in range(0, n, block):
            sl = slice(a, a + block)
            drop = Dropout(seeds, cfg, a, enc_width)
            out = model.forward(batch["input_ids"][sl], batch["bbox"][sl],
                                batch["pixel_values"][sl], batch["attention_mask"][sl], drop)
            if drop.at != len(drop.seeds):
                raise ValueError(f"the forward drew {drop.at} of {len(drop.seeds)} dropout seeds")
            keep = use[sl].to(out["logits"].device)
            labels = batch["labels"][sl].long()
            ce = [F.cross_entropy(lg, labels, reduction="none")[keep].sum() for lg in out["logits"]]
            loss = ce[-1] + sum(wj * c for wj, c in zip(weights, ce[:-1]))
            loss = loss / int(use.sum())
            loss.backward()
            total += float(loss.detach())
    return total, {n: t.grad for n, t in leaves.items()}


class AdamW:
    """torch.optim.AdamW's arithmetic, written out, no weight decay."""

    def __init__(self, w: dict, b1=0.9, b2=0.999, eps=1e-8):
        self.m = {n: torch.zeros_like(t) for n, t in w.items()}
        self.v = {n: torch.zeros_like(t) for n, t in w.items()}
        self.b1, self.b2, self.eps, self.t = b1, b2, eps, 0

    @torch.no_grad()
    def step(self, w: dict, grads: dict, lr: float) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for n, p in w.items():
            g = grads[n]
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[n].sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[n], denom, value=-lr / c1)


def run_steps(w: dict, cfg: dict, batches, seeds, lr: float, total_steps: int, enc_width: int,
              block: int, fp8_products: bool = False, rows=None):
    """Train ``w`` in place over ``batches`` (one per step): (the losses,
    the first step's gradients, the optimizer)."""
    opt = AdamW(w)
    losses, first = [], None
    for k, (batch, step_seeds) in enumerate(zip(batches, seeds)):
        loss, grads = loss_and_grads(w, cfg, batch, step_seeds, enc_width, block, fp8_products, rows)
        losses.append(loss)
        if first is None:
            first = grads
        opt.step(w, grads, lr * (1.0 - min(k, total_steps) / total_steps))
    return losses, first, opt
