"""Early-exit Moonlight-16B-A3B in plain PyTorch (float32), after the public
DeepSeek-V3 modeling code at the configuration's keys, one document at a
time through attention and every real token through the rest:

- the token embedding; per layer RMSNorm (f32), multi-head latent attention
  (q from the hidden state; a 512-wide latent, RMSNormed, to each head's key
  part and value; one 64-wide rotary key shared by the heads; HF's
  interleaved rotary form: each head's rotary dims de-interleaved, then
  rotate-half at pos * theta^(-2i/64)), causal softmax over the document's
  own tokens at scale (nope + rope)^-0.5, the residual;
- RMSNorm, then the first ``first_k_dense_replace`` layers' SwiGLU, the
  others' experts: f32 router, sigmoid scores, ``torch.topk`` of the scores
  plus ``e_score_correction_bias``, weights the chosen uncorrected scores
  over their sum times ``routed_scaling_factor``; each routed expert run in a
  plain loop over the tokens that chose it; the shared experts added;
- the early-exit heads the configuration states: after layer l, the last
  token's state through the head's own RMSNorm, dense, tanh, out_proj; the
  classifier on the last token after the final norm.

The weights stay in the type they are given (the served bf16 copy, shared
with the program while both are alive); each layer's are cast to f32 when
the layer runs. ``fp8`` rounds every operand of every matrix product to
float8 e4m3 with a per-tensor scale (the precision control).

``routes`` forces a program's expert choices (the check's comparison): with
random weights a token's sixth and seventh best experts often score within
rounding of each other, so any two precisions choose differently there
(about 15 % of the pairs over 26 layers, bf16 against f32) and the states
drift apart whatever the arithmetic's quality. Forced, the reference runs
the program's experts with its own f32 weights and states, and reports how
far each forced choice lies below its own k-th best score.
"""

from __future__ import annotations

import torch

from h100bench.reference.v3 import fp8, full_f32


class Model:
    """The reference over a weight dict (the harness's names)."""

    def __init__(self, w: dict, cfg: dict, fp8_products: bool = False):
        self.w, self.cfg, self.q = w, cfg, fp8_products

    def mm(self, a, b):
        return (fp8(a) @ fp8(b)) if self.q else a @ b

    def lin(self, x, weight, bias=None):
        y = self.mm(x, weight.T)
        return y if bias is None else y + bias

    def rms(self, x, weight):
        eps = self.cfg["rms_norm_eps"]
        return weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))

    def swiglu(self, x, gate_up, down):
        f = gate_up.shape[0] // 2
        gate, up = self.lin(x, gate_up[:f]), self.lin(x, gate_up[f:])
        return self.lin(torch.nn.functional.silu(gate) * up, down)

    def rope(self, x, pos):
        """x (L, heads, d): de-interleave each head's dims (2i, 2i + 1) ->
        (i, d/2 + i), then x cos + rotate_half(x) sin."""
        length, heads, d = x.shape
        x = x.view(length, heads, d // 2, 2).transpose(-1, -2).reshape(length, heads, d)
        inv = self.cfg["rope_theta"] ** (-torch.arange(0, d, 2, device=x.device).float() / d)
        ang = pos.float()[:, None] * inv
        cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None]
        sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None]
        rotated = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
        return x * cos + rotated * sin

    def attention(self, x, lw, p):
        """One document's tokens x (L, H)."""
        cfg = self.cfg
        length = x.shape[0]
        heads, nope, rd, vd = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                               cfg["qk_rope_head_dim"], cfg["v_head_dim"])
        r = cfg["kv_lora_rank"]
        pos = torch.arange(length, device=x.device)
        q = self.lin(x, lw[f"{p}.q_proj.weight"]).view(length, heads, nope + rd)
        ckv = self.lin(x, lw[f"{p}.kv_a_proj_with_mqa.weight"])
        latent = self.rms(ckv[:, :r], lw[f"{p}.kv_a_layernorm.weight"])
        kv = self.lin(latent, lw[f"{p}.kv_b_proj.weight"]).view(length, heads, nope + vd)
        k_pe = self.rope(ckv[:, r:].reshape(length, 1, rd), pos).expand(length, heads, rd)
        q = torch.cat([q[..., :nope], self.rope(q[..., nope:], pos)], -1).transpose(0, 1)
        k = torch.cat([kv[..., :nope], k_pe], -1).transpose(0, 1)
        v = kv[..., nope:].transpose(0, 1)
        scores = self.mm(q, k.transpose(-1, -2)) * (nope + rd) ** -0.5
        causal = torch.ones((length, length), dtype=torch.bool, device=x.device).tril()
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        out = self.mm(probs, v).transpose(0, 1).reshape(length, heads * vd)
        return self.lin(out, lw[f"{p}.o_proj.weight"])

    def experts(self, x, lw, p, forced=None):
        """(output (T, H), chosen experts (T, k), the route statistics) of
        the expert layer. ``forced`` (T, k), where given, holds the experts a
        program chose for each token (rows of -1: none); the layer then runs
        those experts, weighted by this reference's own f32 scores, and the
        statistics say how far they are from its own choice: the largest
        amount by which a forced expert's corrected score falls below its
        k-th best (``margin``, 0 when every forced set is its own top k), and
        how many forced token-expert pairs it would not have chosen."""
        cfg = self.cfg
        k = cfg["num_experts_per_tok"]
        scores = torch.sigmoid(self.lin(x, lw[f"{p}.gate.weight"]))
        corrected = scores + lw[f"{p}.gate.e_score_correction_bias"]
        chosen = torch.topk(corrected, k, dim=-1, sorted=False).indices
        stats = {"margin": 0.0, "unlike": 0, "pairs": 0}
        if forced is not None:
            use = forced[:, 0] >= 0
            if use.any():
                kth = torch.topk(corrected[use], k, dim=-1).values[:, -1]
                worst = corrected[use].gather(1, forced[use]).amin(dim=-1)
                stats["margin"] = float((kth - worst).clamp(min=0).max())
                own = chosen[use]
                stats["unlike"] = int((forced[use][:, :, None] != own[:, None, :]).all(-1).sum())
                stats["pairs"] = int(use.sum()) * k
            chosen = torch.where(use[:, None], forced, chosen)
        weights = scores.gather(1, chosen)
        if cfg["norm_topk_prob"]:
            weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
        weights = weights * cfg["routed_scaling_factor"]
        out = torch.zeros_like(x)
        gate_up, down = lw[f"{p}.experts.gate_up_proj"], lw[f"{p}.experts.down_proj"]
        for e in range(cfg["n_routed_experts"]):
            rows, slot = (chosen == e).nonzero(as_tuple=True)
            if rows.numel():
                y = self.swiglu(x[rows], gate_up[e], down[e])
                out.index_add_(0, rows, y * weights[rows, slot, None])
        shared = self.swiglu(x, lw[f"{p}.shared_experts.gate_up_proj.weight"],
                             lw[f"{p}.shared_experts.down_proj.weight"])
        return out + shared, chosen, stats

    def features(self, x, name):
        """A head's hidden layer: its own norm (an exit head's), dense, tanh."""
        w = self.w
        if f"{name}.norm.weight" in w:
            x = self.rms(x, w[f"{name}.norm.weight"].float())
        return torch.tanh(self.lin(x, w[f"{name}.dense.weight"].float(),
                                   w[f"{name}.dense.bias"].float()))

    def head(self, x, name):
        return self.lin(self.features(x, name), self.w[f"{name}.out_proj.weight"].float(),
                        self.w[f"{name}.out_proj.bias"].float())

    def forward(self, docs: list, routes=None) -> dict:
        """``docs``: one (L_i,) tensor of token ids each, real tokens only;
        ``routes``: None, or per expert layer the (sum L_i, k) experts to
        force (``experts``). {'exit_inputs': [(N, H)] the last token's state
        after each exit's layer, then after the final norm (the classifier's
        input), 'logits': (E + 1, N, K), 'chosen': [(sum L_i, k)] per expert
        layer, 'routes': the statistics of the forced routes}."""
        cfg, w = self.cfg, self.w
        lengths = [int(d.shape[0]) for d in docs]
        ends = torch.tensor(lengths, device=docs[0].device).cumsum(0) - 1
        x = w["backbone.embed_tokens.weight"][torch.cat(docs).long()].float()
        taps, chosen = [], []
        stats = {"margin": 0.0, "unlike": 0, "pairs": 0}
        for i in range(cfg["num_hidden_layers"]):
            p = f"backbone.layers.{i}"
            lw = {k: v.float() for k, v in w.items() if k.startswith(p + ".")}
            h = self.rms(x, lw[f"{p}.input_layernorm.weight"])
            x = x + torch.cat([self.attention(d, lw, f"{p}.self_attn")
                               for d in torch.split(h, lengths)])
            h = self.rms(x, lw[f"{p}.post_attention_layernorm.weight"])
            if i < cfg["first_k_dense_replace"]:
                x = x + self.swiglu(h, lw[f"{p}.mlp.gate_up_proj.weight"],
                                    lw[f"{p}.mlp.down_proj.weight"])
            else:
                forced = None if routes is None else routes[len(chosen)].to(x.device)
                y, c, st = self.experts(h, lw, f"{p}.mlp", forced)
                x = x + y
                chosen.append(c)
                stats = {"margin": max(stats["margin"], st["margin"]),
                         "unlike": stats["unlike"] + st["unlike"],
                         "pairs": stats["pairs"] + st["pairs"]}
            taps.append(x[ends])
            del lw
        exits = sorted(e for e in cfg["exits"] if isinstance(e, int))
        exit_inputs = [taps[layer - 1] for layer in exits]
        exit_inputs.append(self.rms(taps[-1], w["backbone.norm.weight"].float()))
        logits = [self.head(t, f"encoder_exits.{j}") for j, t in enumerate(exit_inputs[:-1])]
        logits.append(self.head(exit_inputs[-1], "backbone.classifier"))
        return {"exit_inputs": exit_inputs, "logits": torch.stack(logits), "chosen": chosen,
                "routes": stats}


def max_confidence(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=-1).amax(dim=-1)


@torch.no_grad()
def infer(w: dict, cfg: dict, batch: dict, block: int, fp8_products: bool = False,
          routes=None) -> dict:
    """``Model.forward`` over a batch (``input_ids`` and ``attention_mask``,
    right-padded), each row cut to its real tokens, in blocks of ``block``
    rows; ``routes`` as ``forward``'s over the whole batch's tokens in row
    order. {'exit_inputs': [(N, H)], 'logits': (E + 1, N, K), 'chosen':
    [(tokens, k)] per expert layer, the tokens in row order, 'routes': the
    forced routes' statistics over every block}."""
    model = Model(w, cfg, fp8_products)
    ids, mask = batch["input_ids"], batch["attention_mask"]
    lengths = mask.sum(dim=1).tolist()
    starts = [0]
    for n in lengths:
        starts.append(starts[-1] + n)
    outs = []
    with full_f32():
        for a in range(0, ids.shape[0], block):
            b = min(a + block, ids.shape[0])
            docs = [ids[r, :lengths[r]] for r in range(a, b)]
            forced = None if routes is None else [r[starts[a]:starts[b]] for r in routes]
            outs.append(model.forward(docs, forced))
    return {"exit_inputs": [torch.cat([o["exit_inputs"][j] for o in outs])
                            for j in range(len(outs[0]["exit_inputs"]))],
            "logits": torch.cat([o["logits"] for o in outs], dim=1),
            "chosen": [torch.cat([o["chosen"][j] for o in outs])
                       for j in range(len(outs[0]["chosen"]))],
            "routes": {"margin": max(o["routes"]["margin"] for o in outs),
                       "unlike": sum(o["routes"]["unlike"] for o in outs),
                       "pairs": sum(o["routes"]["pairs"] for o in outs)}}
