"""Early-exit Kimi-Linear-48B-A3B in the benchmark: its weights (the card's
share of the experts), the program built from them, its FLOPs, the bound
of the KDA core, and what its readers find in a traced slice.

Weights: the keys of the port's ``EEModel.state_dict()``, each drawn in the
serving type on the device from one generator seeded by the run's seed:
matrices, stacked experts and the embedding normal(0, initializer_range),
the router's correction bias 0, norm scales 1, the short convolutions
uniform on +-1/sqrt(width), ``A_log`` log U(1, 16), ``dt_bias`` the
inverse softplus of a dt log-uniform on [1e-3, 1e-1]. The stacked experts
are the ``num_experts`` this card holds (of ``published_num_experts``, the
router's width). The program's parameters are these tensors, so the
reference reads the same copy.

FLOPs are those of the published model on each document's own tokens, with
the experts at the held share (k x held / published pairs a token: 4 of
8): the projections and MLPs 2 m k n on the real tokens, the router, the
KDA core's chunked form (``kda_core_ops``) on each token and MLA's causal
attention over the document's own length, each exit head evaluated on the
way.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from h100bench import flops, moonlight, spans


def lin(cfg: dict) -> dict:
    return cfg["linear_attn_config"]


def kda_layer(cfg: dict, i: int) -> bool:
    """Layer ``i`` (0-based) is a KDA layer."""
    return i + 1 in lin(cfg)["kda_layers"]


def layout(cfg: dict) -> list:
    """[(name, shape, kind)], kind 'w' (normal), 'b' (0), 'one' (1), 'conv'
    (uniform), 'a_log' or 'dt_bias'."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rd, vd, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                       cfg["kv_lora_rank"])
    kh, kd = lin(cfg)["num_heads"], lin(cfg)["head_dim"]
    width, conv = kh * kd, lin(cfg)["short_conv_kernel_size"]
    e, f = cfg["num_experts"], cfg["moe_intermediate_size"]
    out = [("backbone.embed_tokens.weight", (cfg["vocab_size"], h), "w")]
    for i in range(cfg["num_hidden_layers"]):
        p = f"backbone.layers.{i}"
        a = f"{p}.self_attn"
        out.append((f"{p}.input_layernorm.weight", (h,), "one"))
        if kda_layer(cfg, i):
            out += [(f"{a}.{n}_proj.weight", (width, h), "w") for n in "qkv"]
            out += [(f"{a}.{n}_conv1d.weight", (width, 1, conv), "conv") for n in "qkv"]
            out += [(f"{a}.A_log", (kh,), "a_log"), (f"{a}.dt_bias", (width,), "dt_bias"),
                    (f"{a}.f_a_proj.weight", (kd, h), "w"),
                    (f"{a}.f_b_proj.weight", (width, kd), "w"),
                    (f"{a}.b_proj.weight", (kh, h), "w"),
                    (f"{a}.g_a_proj.weight", (kd, h), "w"),
                    (f"{a}.g_b_proj.weight", (width, kd), "w"),
                    (f"{a}.o_norm.weight", (kd,), "one"),
                    (f"{a}.o_proj.weight", (h, width), "w")]
        else:
            out += [(f"{a}.q_proj.weight", (heads * (nope + rd), h), "w"),
                    (f"{a}.kv_a_proj_with_mqa.weight", (r + rd, h), "w"),
                    (f"{a}.kv_a_layernorm.weight", (r,), "one"),
                    (f"{a}.kv_b_proj.weight", (heads * (nope + vd), r), "w"),
                    (f"{a}.o_proj.weight", (h, heads * vd), "w")]
        out.append((f"{p}.post_attention_layernorm.weight", (h,), "one"))
        if i < cfg["first_k_dense_replace"]:
            width_d = cfg["intermediate_size"]
            out += [(f"{p}.mlp.gate_up_proj.weight", (2 * width_d, h), "w"),
                    (f"{p}.mlp.down_proj.weight", (h, width_d), "w")]
        else:
            shared = f * cfg["num_shared_experts"]
            n = cfg["published_num_experts"]
            out += [(f"{p}.mlp.gate.weight", (n, h), "w"),
                    (f"{p}.mlp.gate.e_score_correction_bias", (n,), "b"),
                    (f"{p}.mlp.experts.gate_up_proj", (e, 2 * f, h), "w"),
                    (f"{p}.mlp.experts.down_proj", (e, h, f), "w"),
                    (f"{p}.mlp.shared_experts.gate_up_proj.weight", (2 * shared, h), "w"),
                    (f"{p}.mlp.shared_experts.down_proj.weight", (h, shared), "w")]
    out.append(("backbone.norm.weight", (h,), "one"))
    for name in moonlight.head_names(cfg):
        if name != "backbone.classifier":
            out.append((f"{name}.norm.weight", (h,), "one"))
        out.extend([(f"{name}.dense.weight", (h, h), "w"), (f"{name}.dense.bias", (h,), "b"),
                    (f"{name}.out_proj.weight", (cfg["num_labels"], h), "w"),
                    (f"{name}.out_proj.bias", (cfg["num_labels"],), "b")])
    return out


def make(cfg: dict, seed: int, device, dtype) -> dict:
    """{name: tensor} drawn tensor by tensor in ``dtype`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape, kind in layout(cfg):
        if kind == "w":
            t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
            t.mul_(cfg["initializer_range"])
        elif kind == "conv":
            bound = 1.0 / math.sqrt(shape[-1])
            t = torch.empty(shape, device=device, dtype=dtype)
            t.uniform_(-bound, bound, generator=gen)
        elif kind == "a_log":
            t = torch.empty(shape, device=device).uniform_(1.0, 16.0, generator=gen).log_()
        elif kind == "dt_bias":
            dt = torch.empty(shape, device=device).uniform_(
                math.log(1e-3), math.log(1e-1), generator=gen).exp_()
            t = dt + torch.log(-torch.expm1(-dt))
        else:
            t = torch.full(shape, 1.0 if kind == "one" else 0.0, device=device, dtype=dtype)
        out[name] = t.to(dtype)
    return out


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


def port_config(cfg: dict):
    """The port's ``EEModelConfig`` for a configuration file: the published
    keys, ``num_experts`` the router's (``published_num_experts``) and
    ``experts_held`` the file's ``num_experts``."""
    from multi_modal_early_exit_tpu_torch.models.kimi_linear.config import KimiLinearConfig
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import EEModelConfig
    from multi_modal_early_exit_tpu_torch.models.moonlight.config import MoonlightExitConfig

    fields = {f.name for f in dataclasses.fields(KimiLinearConfig)}
    keys = {k: v for k, v in cfg.items() if k in fields}
    keys.update(num_experts=cfg["published_num_experts"], experts_held=cfg["num_experts"],
                kda_layers=lin(cfg)["kda_layers"], full_attn_layers=lin(cfg)["full_attn_layers"],
                kda_num_heads=lin(cfg)["num_heads"], kda_head_dim=lin(cfg)["head_dim"],
                short_conv_kernel_size=lin(cfg)["short_conv_kernel_size"],
                chunk_size=cfg["kda_chunk_size"])
    exit_cfg = MoonlightExitConfig(
        exits=tuple(cfg["exits"]), inference_strategy=cfg["inference_strategy"],
        exit_head_num_layers=cfg["exit_head_num_layers"],
    )
    return EEModelConfig(backbone=KimiLinearConfig(**keys), exit=exit_cfg)


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


def kda_core_ops(cfg: dict) -> float:
    """Operations of the KDA core's chunked form a chunk and head: A and Qt
    (2 d a pair, i <= r, each), T's forward substitution (C^3 / 3), the
    three products with the state (K e^G S, Q e^G S, the update: 2 C d d_v
    each), T X and Qt Delta (C^2 d_v each)."""
    c, d = cfg["kda_chunk_size"], lin(cfg)["head_dim"]
    return 2.0 * c * (c + 1) * d + c ** 3 / 3.0 + 6.0 * c * d * d + 2.0 * c * c * d


def kda_cost(cfg: dict, tokens: float, esize: int = 2):
    """(bytes, operations) of the KDA core over ``tokens`` real tokens (each
    layer counted): q, k, v and o in the serving type and g in f32 read or
    written once; the chunked form's operations, a chunk a 64 tokens."""
    heads, d = lin(cfg)["num_heads"], lin(cfg)["head_dim"]
    n_bytes = tokens * heads * d * (4 * esize + 4)
    return n_bytes, tokens / cfg["kda_chunk_size"] * heads * kda_core_ops(cfg)


def token_flops(cfg: dict, layer: int) -> float:
    """Layer ``layer``'s (0-based) operations a token besides MLA's
    attention core: the mixer's projections (and the KDA core), then the
    MLP (dense, or the router, the held share of the routed pairs and the
    shared expert)."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    if kda_layer(cfg, layer):
        kh, kd = lin(cfg)["num_heads"], lin(cfg)["head_dim"]
        width = kh * kd
        mixer = 2.0 * h * 4 * width + 2.0 * 2 * (h * kd + kd * width) + 2.0 * h * kh \
            + 2.0 * 3 * width * lin(cfg)["short_conv_kernel_size"] \
            + kh * kda_core_ops(cfg) / cfg["kda_chunk_size"]
    else:
        nope, rd, vd, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                           cfg["kv_lora_rank"])
        mixer = 2.0 * h * (heads * (nope + rd) + r + rd) + 2.0 * r * heads * (nope + vd) \
            + 2.0 * heads * vd * h
    if layer < cfg["first_k_dense_replace"]:
        return mixer + 6.0 * h * cfg["intermediate_size"]
    f = cfg["moe_intermediate_size"]
    held_pairs = cfg["num_experts_per_token"] * cfg["num_experts"] / cfg["published_num_experts"]
    return mixer + 2.0 * h * cfg["published_num_experts"] + held_pairs * 6.0 * h * f \
        + 6.0 * h * f * cfg["num_shared_experts"]


def doc_flops_to_exit(cfg: dict, exit_index: int, length: int) -> float:
    """Forward FLOPs of a document of ``length`` tokens that left at
    ``exit_index`` (len(exits) is the classifier), every head it passed
    included."""
    ends = moonlight.encoder_exits(cfg) + [cfg["num_hidden_layers"]]
    layers = ends[exit_index]
    body = sum(token_flops(cfg, i) for i in range(layers)) * length
    mla = sum(1 for i in range(layers) if not kda_layer(cfg, i))
    return body + mla * moonlight.attn_core_flops(cfg, length) \
        + (exit_index + 1) * moonlight.head_flops(cfg)


# ---------------------------------------------------------------------------
# what the readers find in a traced slice
# ---------------------------------------------------------------------------


def kda_ms_per_batch(run):
    """Device ms a batch of everything launched inside ``kda.mixer``; None
    without the span."""
    if run.trace is None or not run.units:
        return None
    spent = spans.device_s_launched_in(run.trace, r"^kda\.mixer$")
    return None if spent is None else 1e3 * spent / run.units


def kda_roofline_pct(run):
    """The KDA core's bound over the slice's real tokens (``kda_cost`` of
    the ``kda.tokens`` the program counted while the slice ran,
    ``run.attention_calls``) over the device time of what was launched
    inside ``kda.core``; None without the counter or the span."""
    if run.trace is None or not run.attention_calls:
        return None
    spent = spans.device_s_launched_in(run.trace, r"^kda\.core$")
    if not spent:
        return None
    need = sum(flops.bound_s(*kda_cost(run.cfg, tokens)) for tokens in run.attention_calls)
    return 100.0 * need / spent
