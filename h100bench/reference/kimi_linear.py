"""Early-exit Kimi-Linear-48B-A3B in plain PyTorch (float32, TF32 off), after
the public Kimi-Linear modeling code at the configuration's keys, one
document at a time through the token mixers and every real token through
the rest. Moonlight's reference (``reference/moonlight.py``) gives the
pieces the two blocks share: RMSNorm, the SwiGLU and the heads. MLA runs
here without its rotary step (``mla_use_nope``) and in blocks of
``query_block`` queries (a 16,384-token document's scores would not fit
whole); the expert layer is Moonlight's router over all
``published_num_experts`` experts, with its forced routes, over the experts
held (``num_experts`` of them from ``expert_offset``, 0 unless given: the
card's share; an absent expert's pairs add nothing, as on the card that
holds them).

A KDA layer, over x = RMSNorm(h) of one document (L tokens), h heads of d:
q, k, v = SiLU(causal depthwise convolution of width 4 (no bias) of W x);
q and k divided per head by sqrt(sum x^2 + 1e-6), q times d^-1/2; g =
-exp(A_log) softplus(W_fb W_fa x + dt_bias) per channel; beta =
sigmoid(W_b x) per head; the core ``kda_core``; out = W_o[RMSNorm_d(o)
w_o_norm sigmoid(W_gb W_ga x)]. ``kda_core`` is the chunked form of the
gated delta rule from a zero state, computed directly from per-channel
differences of the running sums of g within each chunk, in a loop over the
chunks:

    A_ri  = sum_c k_rc k_ic e^{G_rc - G_ic} (i < r),  Qt_ri the same with q (i <= r)
    T     = (I + diag(beta) A)^{-1} diag(beta)
    Delta = T (V - (K e^G) S);  O = (Q e^G) S + Qt Delta
    S    <- e^{G_C} S + (K e^{G_C - G})^T Delta

``fp8`` rounds every operand of every matrix product to float8 e4m3 (the
precision control), the core's among them; the control's KDA numbers
compare each of its cores with the f32 core on the same inputs
(``kda_err``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from h100bench.reference import moonlight as moon_ref
from h100bench.reference.v3 import fp8, full_f32

L2_EPS = 1e-6


def moonlight_keys(cfg: dict) -> dict:
    """The configuration under the keys Moonlight's reference reads."""
    return dict(cfg, n_routed_experts=cfg["published_num_experts"],
                num_experts_per_tok=cfg["num_experts_per_token"],
                norm_topk_prob=cfg["moe_renormalize"],
                n_shared_experts=cfg["num_shared_experts"])


def kda_core(q, k, v, g, beta, chunk: int, q8: bool = False) -> torch.Tensor:
    """One document's core: q, k, v, g (L, h, d) and beta (L, h), f32; (L,
    h, d). ``q8`` rounds each product's operands to float8."""
    rnd = fp8 if q8 else (lambda t: t)
    length, heads, d = k.shape
    state = k.new_zeros((heads, d, v.shape[-1]))
    incl = torch.ones(chunk, chunk, dtype=torch.bool, device=k.device).tril()
    out = []
    for a in range(0, length, chunk):
        b = min(a + chunk, length)
        qc, kc, vc, gc = (t[a:b].transpose(0, 1) for t in (q, k, v, g))  # (h, n, d)
        bc = beta[a:b].T  # (h, n)
        n = b - a
        gam = gc.cumsum(dim=1)
        diff = gam[:, :, None, :] - gam[:, None, :, :]  # (h, r, i, c)
        keep = incl[:n, :n]
        decay = torch.where(keep[:, :, None], diff, float("-inf")).exp()
        kdec = rnd(kc[:, None, :, :] * decay)  # k_i e^{G_r - G_i}
        a_mat = (rnd(kc)[:, :, None, :] * kdec).sum(-1) * keep.tril(-1)
        qt = (rnd(qc)[:, :, None, :] * kdec).sum(-1)
        lower = torch.eye(n, device=k.device) + bc[:, :, None] * a_mat
        t = torch.linalg.solve_triangular(lower, torch.diag_embed(bc), upper=False)
        delta = rnd(t) @ rnd(vc - rnd(kc * gam.exp()) @ rnd(state))
        out.append(rnd(qc * gam.exp()) @ rnd(state) + rnd(qt) @ rnd(delta))
        last = gam[:, -1:, :]
        state = last.exp().transpose(1, 2) * state \
            + rnd((kc * (last - gam).exp()).transpose(1, 2)) @ rnd(delta)
    return torch.cat(out, dim=1).transpose(0, 1)


def core_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error over the largest value of ``want``."""
    scale = want.abs().max().clamp(min=1e-30)
    return float((got.float() - want).abs().max() / scale)


class Model(moon_ref.Model):
    """The reference over a weight dict (the harness's names)."""

    def __init__(self, w: dict, cfg: dict, fp8_products: bool = False,
                 query_block: int = 1024):
        super().__init__(w, moonlight_keys(cfg), fp8_products)
        self.query_block = query_block
        self.kda_err = 0.0  # with fp8: the cores' largest error against f32

    def attention(self, x, lw, p):
        """One document's MLA over its tokens x (L, H), without rotary
        embeddings, causal, in blocks of ``query_block`` queries."""
        cfg = self.cfg
        length = x.shape[0]
        heads, nope, rd, vd = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                               cfg["qk_rope_head_dim"], cfg["v_head_dim"])
        r = cfg["kv_lora_rank"]
        q = self.lin(x, lw[f"{p}.q_proj.weight"]).view(length, heads, nope + rd).transpose(0, 1)
        ckv = self.lin(x, lw[f"{p}.kv_a_proj_with_mqa.weight"])
        latent = self.rms(ckv[:, :r], lw[f"{p}.kv_a_layernorm.weight"])
        kv = self.lin(latent, lw[f"{p}.kv_b_proj.weight"]).view(length, heads, nope + vd)
        k_pe = ckv[:, r:].reshape(length, 1, rd).expand(length, heads, rd)
        k = torch.cat([kv[..., :nope], k_pe], -1).transpose(0, 1)
        v = kv[..., nope:].transpose(0, 1)
        out = []
        for a in range(0, length, self.query_block):
            b = min(a + self.query_block, length)
            scores = self.mm(q[:, a:b], k[:, :b].transpose(-1, -2)) * (nope + rd) ** -0.5
            causal = torch.ones((b - a, b), dtype=torch.bool, device=x.device).tril(a)
            probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
            out.append(self.mm(probs, v[:, :b]))
        out = torch.cat(out, dim=1).transpose(0, 1).reshape(length, heads * vd)
        return self.lin(out, lw[f"{p}.o_proj.weight"])

    def experts(self, x, lw, p, forced=None):
        """(output (T, H), chosen experts (T, k), the route statistics), as
        Moonlight's reference's, with the routed experts those held here:
        the stacked weights are the router's experts ``expert_offset``
        onward, and a pair whose expert is absent adds nothing."""
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
        offset = cfg.get("expert_offset", 0)
        for e in range(gate_up.shape[0]):
            rows, slot = (chosen == offset + e).nonzero(as_tuple=True)
            if rows.numel():
                y = self.swiglu(x[rows], gate_up[e], down[e])
                out.index_add_(0, rows, y * weights[rows, slot, None])
        shared = self.swiglu(x, lw[f"{p}.shared_experts.gate_up_proj.weight"],
                             lw[f"{p}.shared_experts.down_proj.weight"])
        return out + shared, chosen, stats

    def conv(self, x, weight):
        """SiLU of the causal depthwise convolution of x (L, C), weight (C,
        1, width)."""
        width = weight.shape[-1]
        y = F.conv1d(x.T[None], weight, padding=width - 1, groups=x.shape[-1])[0, :, :x.shape[0]]
        return F.silu(y.T)

    def kda(self, x, lw, p):
        """One document's KDA sub-layer over x (L, H), the normed state."""
        cfg = self.cfg
        length = x.shape[0]
        heads, d = cfg["linear_attn_config"]["num_heads"], cfg["linear_attn_config"]["head_dim"]

        def proj(name):
            return self.lin(x, lw[f"{p}.{name}.weight"])

        def l2(t):
            return t * torch.rsqrt(t.pow(2).sum(-1, keepdim=True) + L2_EPS)

        q = l2(self.conv(proj("q_proj"), lw[f"{p}.q_conv1d.weight"]).view(length, heads, d))
        k = l2(self.conv(proj("k_proj"), lw[f"{p}.k_conv1d.weight"]).view(length, heads, d))
        v = self.conv(proj("v_proj"), lw[f"{p}.v_conv1d.weight"]).view(length, heads, d)
        q = q * d ** -0.5
        raw = self.lin(self.lin(x, lw[f"{p}.f_a_proj.weight"]), lw[f"{p}.f_b_proj.weight"])
        g = -lw[f"{p}.A_log"].exp()[:, None] * F.softplus(
            (raw + lw[f"{p}.dt_bias"]).view(length, heads, d))
        beta = torch.sigmoid(proj("b_proj"))
        o = kda_core(q, k, v, g, beta, cfg["kda_chunk_size"], self.q)
        if self.q:
            self.kda_err = max(self.kda_err, core_err(o, kda_core(q, k, v, g, beta,
                                                                   cfg["kda_chunk_size"])))
        gate = self.lin(self.lin(x, lw[f"{p}.g_a_proj.weight"]), lw[f"{p}.g_b_proj.weight"])
        o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + cfg["rms_norm_eps"])
        o = o * lw[f"{p}.o_norm.weight"] * torch.sigmoid(gate.view(length, heads, d))
        return self.lin(o.reshape(length, heads * d), lw[f"{p}.o_proj.weight"])

    def forward(self, docs: list, routes=None) -> dict:
        """``docs``: one (L_i,) tensor of token ids each, real tokens only;
        ``routes`` as Moonlight's reference's. Its keys and the KDA
        control's ``kda_err``."""
        cfg, w = self.cfg, self.w
        kda_layers = set(cfg["linear_attn_config"]["kda_layers"])
        lengths = [int(d.shape[0]) for d in docs]
        ends = torch.tensor(lengths, device=docs[0].device).cumsum(0) - 1
        x = w["backbone.embed_tokens.weight"][torch.cat(docs).long()].float()
        taps, chosen = [], []
        stats = {"margin": 0.0, "unlike": 0, "pairs": 0}
        for i in range(cfg["num_hidden_layers"]):
            p = f"backbone.layers.{i}"
            lw = {k: v.float() for k, v in w.items() if k.startswith(p + ".")}
            h = self.rms(x, lw[f"{p}.input_layernorm.weight"])
            mixer = self.kda if i + 1 in kda_layers else self.attention
            x = x + torch.cat([mixer(d, lw, f"{p}.self_attn") for d in torch.split(h, lengths)])
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
                "routes": stats, "kda_err": self.kda_err}


max_confidence = moon_ref.max_confidence


@torch.no_grad()
def infer(w: dict, cfg: dict, batch: dict, block: int, fp8_products: bool = False,
          routes=None) -> dict:
    """``Model.forward`` over a right-padded batch in blocks of ``block``
    rows, as ``reference/moonlight.py::infer``; with ``fp8_products`` also
    ``kda_err``, the float8 cores' largest error against the f32 core."""
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
                       "pairs": sum(o["routes"]["pairs"] for o in outs)},
            "kda_err": model.kda_err}
