"""Early-exit Moonlight-16B-A3B in the benchmark: its weights, the program
built from them, its FLOPs and the bounds of its two costly kernels, and
what its readers find in a traced slice.

Weights: the names are the keys of the port's ``EEModel.state_dict()``;
each tensor is drawn in the serving type on the device from one generator
seeded by the run's seed (no f32 copy of the 15.6 B parameters is ever
made): matrices, stacked experts and the embedding normal(0,
initializer_range), biases and the router's correction bias 0, RMSNorm
scales 1. The program's parameters are these tensors (built on ``meta``,
then assigned), so the reference reads the same copy.

FLOPs are those of the published model on each document's own tokens:
projections and MLPs 2 m k n on the real tokens, 6 routed and the shared
experts a token, the router, and causal attention over the document's own
length, L (L + 1) / 2 query-key pairs a head, 2 (d_qk + d_v) operations a
pair; each exit head evaluated on the way.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from h100bench import flops, spans
from h100bench.tracing import GEMM


def layout(cfg: dict) -> list:
    """[(name, shape, kind)], kind 'w' (normal), 'b' (0) or 'one' (1)."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rd, vd, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                       cfg["kv_lora_rank"])
    e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    out = [("backbone.embed_tokens.weight", (cfg["vocab_size"], h), "w")]
    for i in range(cfg["num_hidden_layers"]):
        p = f"backbone.layers.{i}"
        out += [(f"{p}.input_layernorm.weight", (h,), "one"),
                (f"{p}.self_attn.q_proj.weight", (heads * (nope + rd), h), "w"),
                (f"{p}.self_attn.kv_a_proj_with_mqa.weight", (r + rd, h), "w"),
                (f"{p}.self_attn.kv_a_layernorm.weight", (r,), "one"),
                (f"{p}.self_attn.kv_b_proj.weight", (heads * (nope + vd), r), "w"),
                (f"{p}.self_attn.o_proj.weight", (h, heads * vd), "w"),
                (f"{p}.post_attention_layernorm.weight", (h,), "one")]
        if i < cfg["first_k_dense_replace"]:
            width = cfg["intermediate_size"]
            out += [(f"{p}.mlp.gate_up_proj.weight", (2 * width, h), "w"),
                    (f"{p}.mlp.down_proj.weight", (h, width), "w")]
        else:
            shared = f * cfg["n_shared_experts"]
            out += [(f"{p}.mlp.gate.weight", (e, h), "w"),
                    (f"{p}.mlp.gate.e_score_correction_bias", (e,), "b"),
                    (f"{p}.mlp.experts.gate_up_proj", (e, 2 * f, h), "w"),
                    (f"{p}.mlp.experts.down_proj", (e, h, f), "w"),
                    (f"{p}.mlp.shared_experts.gate_up_proj.weight", (2 * shared, h), "w"),
                    (f"{p}.mlp.shared_experts.down_proj.weight", (h, shared), "w")]
    out.append(("backbone.norm.weight", (h,), "one"))

    def head(name, norm):
        if norm:
            out.append((f"{name}.norm.weight", (h,), "one"))
        out.extend([(f"{name}.dense.weight", (h, h), "w"), (f"{name}.dense.bias", (h,), "b"),
                    (f"{name}.out_proj.weight", (cfg["num_labels"], h), "w"),
                    (f"{name}.out_proj.bias", (cfg["num_labels"],), "b")])

    head("backbone.classifier", False)
    for j, _ in enumerate(encoder_exits(cfg)):
        head(f"encoder_exits.{j}", True)
    return out


def make(cfg: dict, seed: int, device, dtype) -> dict:
    """{name: tensor} drawn tensor by tensor in ``dtype`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape, kind in layout(cfg):
        if kind == "w":
            t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
            t.mul_(cfg["initializer_range"])
        else:
            t = torch.full(shape, 1.0 if kind == "one" else 0.0, device=device, dtype=dtype)
        out[name] = t
    return out


def head_names(cfg: dict) -> list:
    """The heads, canonical order: each encoder exit's, then the classifier."""
    exits = [f"encoder_exits.{j}" for j, _ in enumerate(encoder_exits(cfg))]
    return exits + ["backbone.classifier"]


def encoder_exits(cfg: dict) -> list:
    return sorted(e for e in cfg["exits"] if isinstance(e, int))


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


def port_config(cfg: dict):
    """The port's ``EEModelConfig`` for a configuration file."""
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import EEModelConfig
    from multi_modal_early_exit_tpu_torch.models.moonlight.config import (
        MoonlightConfig,
        MoonlightExitConfig,
    )

    fields = {f.name for f in dataclasses.fields(MoonlightConfig)}
    backbone = MoonlightConfig(**{k: v for k, v in cfg.items() if k in fields})
    exit_cfg = MoonlightExitConfig(
        exits=tuple(cfg["exits"]), inference_strategy=cfg["inference_strategy"],
        exit_head_num_layers=cfg["exit_head_num_layers"],
    )
    return EEModelConfig(backbone=backbone, exit=exit_cfg)


def port_model(cfg: dict, w: dict, device):
    """An ``EEModel`` whose parameters are the tensors of ``w`` (no copy)."""
    from multi_modal_early_exit_tpu_torch.models.ee.model import EEModel

    with torch.device("meta"):
        model = EEModel(port_config(cfg), device="meta")
    model.load_state_dict(w, strict=True, assign=True)
    return model.to(device)


# ---------------------------------------------------------------------------
# FLOPs and bounds
# ---------------------------------------------------------------------------


def token_flops(cfg: dict, layer: int) -> float:
    """Layer ``layer``'s (0-based) operations a token, besides the
    attention core: the four attention projections and the MLP (dense, or
    the router, 6 routed and the shared experts)."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rd, vd, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                       cfg["kv_lora_rank"])
    attn = 2.0 * h * (heads * (nope + rd) + r + rd) + 2.0 * r * heads * (nope + vd) \
        + 2.0 * heads * vd * h
    if layer < cfg["first_k_dense_replace"]:
        return attn + 6.0 * h * cfg["intermediate_size"]
    f = cfg["moe_intermediate_size"]
    routed = cfg["num_experts_per_tok"] * 6.0 * h * f
    return attn + 2.0 * h * cfg["n_routed_experts"] + routed + 6.0 * h * f * cfg["n_shared_experts"]


def attn_core_flops(cfg: dict, length: int) -> float:
    """One layer's causal attention over a document of ``length`` tokens."""
    pairs = length * (length + 1) / 2
    d = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"]
    return 2.0 * cfg["num_attention_heads"] * pairs * d


def head_flops(cfg: dict) -> float:
    h = cfg["hidden_size"]
    return 2.0 * h * h + 2.0 * h * cfg["num_labels"]


def doc_flops_to_exit(cfg: dict, exit_index: int, length: int) -> float:
    """Forward FLOPs of a document of ``length`` tokens that left at
    ``exit_index`` (len(exits) is the classifier), every head it passed
    included."""
    ends = encoder_exits(cfg) + [cfg["num_hidden_layers"]]
    layers = ends[exit_index]
    body = sum(token_flops(cfg, i) for i in range(layers)) * length
    return body + layers * attn_core_flops(cfg, length) + (exit_index + 1) * head_flops(cfg)


def attn_cost(cfg: dict, rows: int, s: int, esize: int = 2):
    """(bytes, operations) of one causal attention call over ``rows`` rows
    of ``s`` positions, as the kernel gets them: q and k (d_qk a head) and
    v read, the output (d_v) written; s (s + 1) / 2 pairs a row and head."""
    heads = cfg["num_attention_heads"]
    dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    dv = cfg["v_head_dim"]
    n_bytes = rows * s * heads * (2 * dqk + 2 * dv) * esize
    return n_bytes, 2.0 * rows * heads * s * (s + 1) / 2 * (dqk + dv)


def expert_gemm_cost(cfg: dict, pairs: float, esize: int = 2):
    """(bytes, operations) of one expert layer's two grouped products over
    ``pairs`` token-expert pairs: every expert's gate-up and down matrices
    read once; the gathered tokens read, the (pairs, 2 F) result written
    and its (pairs, F) product read, the (pairs, H) result written."""
    h, f, e = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    n_bytes = (3 * e * h * f + pairs * (2 * h + 3 * f)) * esize
    return n_bytes, 6.0 * pairs * h * f


def moe_layers(cfg: dict) -> int:
    return cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]


# ---------------------------------------------------------------------------
# what the readers find in a traced slice
# ---------------------------------------------------------------------------


def gemm_s_launched_in(trace, span_pattern: str):
    """Device seconds of the GEMM kernels (``tracing.GEMM``) launched inside
    the spans matching ``span_pattern`` (``spans.device_s_launched_in`` over
    the trace's GEMMs alone); None without such spans."""
    gemms = copy.copy(trace)
    gemms.device = [d for d in trace.device if d[3] == "kernel" and GEMM.search(d[0])]
    return spans.device_s_launched_in(gemms, span_pattern)


def pairs_per_batch(run):
    """Token-expert pairs a batch, from the program's counters over the
    whole run (warm-up, window, slice, the check's routing call: the
    traffic is stationary); None without them."""
    counts = spans.counters()
    if not counts or not counts.get("moe.routed_pairs") or not counts.get("serving.documents"):
        return None
    return counts["moe.routed_pairs"] / (counts["serving.documents"] / run.mix["batch"])


def expert_gemm_roofline_pct(run):
    """The grouped expert products' bound over their device time: the GEMM
    kernels launched inside ``moe.experts``."""
    pairs = pairs_per_batch(run)
    if run.trace is None or not run.units or pairs is None:
        return None
    spent = gemm_s_launched_in(run.trace, r"^moe\.experts$")
    if not spent:
        return None
    layers = moe_layers(run.cfg)
    per_layer = flops.bound_s(*expert_gemm_cost(run.cfg, pairs / layers))
    return 100.0 * per_layer * layers * run.units / spent


def attn_roofline_pct(run):
    """The causal attention calls' bound (``attn_cost`` of each call the
    slice makes, ``run.attention_calls``) over the device time of what was
    launched inside ``mla.attention`` (the attention kernel and its
    workspace's memset)."""
    if run.trace is None or not run.attention_calls:
        return None
    spent = spans.device_s_launched_in(run.trace, r"^mla\.attention$")
    if not spent:
        return None
    need = sum(flops.bound_s(*attn_cost(run.cfg, rows, s)) for rows, s in run.attention_calls)
    return 100.0 * need / spent
