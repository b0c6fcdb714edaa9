"""Early-exit Kimi-VL-A3B-Instruct in the benchmark: its weights, the program
built from them, its FLOPs, the bound of the vision tower's attention, and
what its readers find in a traced slice.

Weights: Moonlight's (``h100bench.moonlight.layout``) and the vision
tower's and projector's, the keys of the port's ``EEModel.state_dict()``,
each drawn in the serving type on the device from one generator seeded by
the run's seed: matrices, the patch convolution and the position table
normal(0, initializer_range), biases 0, LayerNorm scales 1. The program's
parameters are these tensors, so the reference reads the same copy.

FLOPs are the published model's on each page: the vision tower on its N
patches (the patch embedding, per layer q/k/v, output and MLP products, and
attention over the page's own patches, N^2 query-key pairs a head, 4 d
operations a pair), the projector on its N / 4 merged tokens, and the
decoder on the row's real tokens up to its exit
(``moonlight.doc_flops_to_exit``).
"""

from __future__ import annotations

import dataclasses

import torch

from h100bench import flops, moonlight, spans


def vision(cfg: dict) -> dict:
    return cfg["vision_config"]


def vision_layout(cfg: dict) -> list:
    """[(name, shape, kind)] of the vision tower and the projector."""
    v = vision(cfg)
    d, f, p = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    kh, kw = v["merge_kernel_size"]
    t = "backbone.vision_tower"
    out = [(f"{t}.patch_embed.proj.weight", (d, v["num_channels"], p, p), "w"),
           (f"{t}.patch_embed.proj.bias", (d,), "b"),
           (f"{t}.patch_embed.pos_emb.weight",
            (v["init_pos_emb_height"], v["init_pos_emb_width"], d), "w")]

    def norm(name, width):
        out.extend([(f"{name}.weight", (width,), "one"), (f"{name}.bias", (width,), "b")])

    def linear(name, d_in, d_out):
        out.extend([(f"{name}.weight", (d_out, d_in), "w"), (f"{name}.bias", (d_out,), "b")])

    for i in range(v["num_hidden_layers"]):
        b = f"{t}.encoder.blocks.{i}"
        norm(f"{b}.norm0", d)
        norm(f"{b}.norm1", d)
        linear(f"{b}.wqkv", d, 3 * d)
        linear(f"{b}.wo", d, d)
        linear(f"{b}.mlp.fc0", d, f)
        linear(f"{b}.mlp.fc1", f, d)
    norm(f"{t}.encoder.final_layernorm", d)
    norm("backbone.multi_modal_projector.pre_norm", d)
    linear("backbone.multi_modal_projector.linear_1", kh * kw * d, kh * kw * d)
    linear("backbone.multi_modal_projector.linear_2", kh * kw * d, cfg["hidden_size"])
    return out


def make(cfg: dict, seed: int, device, dtype) -> dict:
    """{name: tensor} drawn tensor by tensor in ``dtype`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape, kind in moonlight.layout(cfg) + vision_layout(cfg):
        if kind == "w":
            t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
            t.mul_(cfg["initializer_range"])
        else:
            t = torch.full(shape, 1.0 if kind == "one" else 0.0, device=device, dtype=dtype)
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


def port_config(cfg: dict):
    """The port's ``EEModelConfig`` for a configuration file."""
    from multi_modal_early_exit_tpu_torch.models.kimi_vl.config import (
        KimiVLConfig,
        MoonViTConfig,
    )

    moon = moonlight.port_config(cfg)
    fields = {f.name for f in dataclasses.fields(MoonViTConfig)}
    backbone = KimiVLConfig(
        text=moon.backbone,
        vision=MoonViTConfig(**{k: v for k, v in vision(cfg).items() if k in fields}),
        media_placeholder_token_id=cfg["media_placeholder_token_id"],
        projector_ln_eps=cfg["projector_ln_eps"])
    return moon.replace(backbone=backbone)


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


def vision_flops(cfg: dict, patches: int) -> float:
    """The vision tower and the projector on one page of ``patches``
    patches."""
    v = vision(cfg)
    d, f, n = v["hidden_size"], v["intermediate_size"], patches
    merged = v["merge_kernel_size"][0] * v["merge_kernel_size"][1]
    embed = 2.0 * n * v["num_channels"] * v["patch_size"] ** 2 * d
    layer = 2.0 * n * d * (3 * d + d + 2 * f) + 4.0 * n * n * d
    width = merged * d
    projector = 2.0 * (n / merged) * width * (width + cfg["hidden_size"])
    return embed + v["num_hidden_layers"] * layer + projector


def doc_flops_to_exit(cfg: dict, exit_index: int, patches: int, length: int) -> float:
    """A page of ``patches`` patches whose row of ``length`` real tokens left
    at ``exit_index``: the vision tower's, the projector's and the
    decoder's FLOPs."""
    return vision_flops(cfg, patches) + moonlight.doc_flops_to_exit(cfg, exit_index, length)


def vit_attn_cost(cfg: dict, patches: int, patch_pairs: int, esize: int = 2):
    """(bytes, operations) of the vision tower's attention over pages of
    ``patches`` patches and ``patch_pairs`` query-key pairs in all, every
    layer, at the true head dim: q, k and v read and the output written
    once a layer; 4 d operations a pair and head (q k^T, then p v)."""
    v = vision(cfg)
    d = v["hidden_size"]  # heads x head dim
    layers = v["num_hidden_layers"]
    return layers * 4 * patches * d * esize, layers * 4.0 * patch_pairs * d


# ---------------------------------------------------------------------------
# what the readers find in a traced slice
# ---------------------------------------------------------------------------


def vision_ms_per_batch(run):
    """Device ms a batch of every kernel, copy and set launched inside
    ``vit.tower``; None without the span."""
    if run.trace is None or not run.units:
        return None
    spent = spans.device_s_launched_in(run.trace, r"^vit\.tower$")
    return None if spent is None else 1e3 * spent / run.units


def vit_attn_roofline_pct(run):
    """The bound of the slice's vision attention (``vit_attn_cost`` of the
    ``vit.patches`` and ``vit.patch_pairs`` the program counted while the
    slice ran, ``run.attention_calls``) over the device time of what was
    launched inside ``vit.attention``; None without the counters or the
    span."""
    if run.trace is None or not run.attention_calls:
        return None
    spent = spans.device_s_launched_in(run.trace, r"^vit\.attention$")
    if not spent:
        return None
    need = sum(flops.bound_s(*vit_attn_cost(run.cfg, patches, pairs))
               for patches, pairs in run.attention_calls)
    return 100.0 * need / spent
