"""PyTorch port, early-exit Kimi-Linear (``models/kimi_linear``) at a tiny size
on the CPU in f32, against the benchmark's plain reference
(``h100bench/reference/kimi_linear.py``): every exit's logits over rows whose
lengths are no multiple of the KDA chunk, right-padded; both chunked KDA
cores (the port's plain version and the reference's) against a token by
token recurrence in f64, at forget gates from -1e-4 to -20 a token; the
expert layer's two held shares summing to the whole layer; the cascade
against the batched forward; ``Pipeline``; the spans and counters; the
registry. This file imports no JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from h100bench.reference import kimi_linear as ref
from multi_modal_early_exit_tpu_torch.models.ee.cascade import make_cascade_forward
from multi_modal_early_exit_tpu_torch.models.ee.model import (
    decide_exits,
    ee_forward,
    init_ee_params,
)
from multi_modal_early_exit_tpu_torch.models.kimi_linear import modeling
from multi_modal_early_exit_tpu_torch.models.kimi_linear.config import KimiLinearConfig
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import EEModelConfig
from multi_modal_early_exit_tpu_torch.models.moonlight import modeling as moon
from multi_modal_early_exit_tpu_torch.models.moonlight.config import MoonlightExitConfig
from multi_modal_early_exit_tpu_torch.ops.kda import kda_chunked_plain
from multi_modal_early_exit_tpu_torch.utils import profiling

torch.set_num_threads(2)

B, S = 4, 50
# chunks of 16: rows ending inside a chunk, at its end, and one short of it
LENGTHS = {"mixed": [50, 23, 32, 7], "full": [S] * B}


@pytest.fixture(autouse=True)
def _inference():
    with torch.no_grad():
        yield


def tiny_model(seed=0, exits=(2, 4)):
    cfg = EEModelConfig(backbone=KimiLinearConfig.tiny(), exit=MoonlightExitConfig(exits=exits))
    model = init_ee_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    # heads of unit-scale logits, so the criteria spread
    for head in list(model.encoder_exits) + [model.backbone.classifier]:
        head.out_proj.weight.mul_(50.0)
    return cfg, model


def batch(seed, lengths):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 512, (len(lengths), S), generator=g)
    mask = (torch.arange(S)[None, :] < torch.tensor(lengths)[:, None]).to(torch.int32)
    return torch.where(mask.bool(), ids, 0).to(torch.int32), mask


def ref_cfg(cfg) -> dict:
    """The configuration file's keys for the port's tiny config."""
    bb = cfg.backbone
    d = {f.name: getattr(bb, f.name) for f in dataclasses.fields(bb)}
    d.update(published_num_experts=bb.num_experts, num_experts=bb.experts_held,
             linear_attn_config={"kda_layers": list(bb.kda_layers),
                                 "full_attn_layers": list(bb.full_attn_layers),
                                 "num_heads": bb.kda_num_heads, "head_dim": bb.kda_head_dim,
                                 "short_conv_kernel_size": bb.short_conv_kernel_size},
             kda_chunk_size=bb.chunk_size, exits=list(cfg.exit.exits))
    return d


def reference(cfg, model, ids, mask, block=2):
    return ref.infer(dict(model.state_dict()), ref_cfg(cfg),
                     {"input_ids": ids, "attention_mask": mask}, block)


@pytest.mark.parametrize("lengths", list(LENGTHS), ids=list(LENGTHS))
@pytest.mark.parametrize("seed", [0, 1])
def test_every_exit_matches_the_reference(seed, lengths):
    """Both sides f32; they differ in the order of their sums (the chunked
    core batched over rows against one document at a time), so each exit
    agrees to 1e-5 of its scale."""
    cfg, model = tiny_model(seed)
    ids, mask = batch(seed + 10, LENGTHS[lengths])
    got = ee_forward(model, cfg, ids, None, None, mask).policy_logits()
    want = reference(cfg, model, ids, mask)["logits"]
    assert got.shape == want.shape == (3, B, 4)
    for e in range(3):
        scale = want[e].abs().max()
        assert (got[e] - want[e]).abs().max() <= 1e-5 * scale, e


def recurrence(q, k, v, g, beta):
    """One document's gated delta rule token by token in f64: (L, h, d)."""
    length, heads, d = k.shape
    out = torch.zeros(length, heads, v.shape[-1], dtype=torch.float64)
    for j in range(heads):
        state = torch.zeros(d, v.shape[-1], dtype=torch.float64)
        for t in range(length):
            kt, vt, qt = (x[t, j].double() for x in (k, v, q))
            state = torch.exp(g[t, j].double())[:, None] * state
            state = state + beta[t, j].double() * torch.outer(kt, vt - state.T @ kt)
            out[t, j] = state.T @ qt
    return out


@pytest.mark.parametrize("gate", [(-20.0, -5.0), (-1e-4, -1e-5), (-1.6, -1e-3)],
                         ids=["strong", "slow", "served"])
def test_both_chunked_cores_are_the_token_recurrence(gate):
    """Decays of -20 a token pass f32's range inside one chunk of 16; the
    cores form every exponent from differences, so they stay finite and
    within 1e-5 of the f64 recurrence's scale."""
    gen = torch.Generator().manual_seed(7)
    lengths = [45, 16, 9]
    q = torch.nn.functional.normalize(torch.randn(3, 45, 2, 16, generator=gen), dim=-1) / 4
    k = torch.nn.functional.normalize(torch.randn(3, 45, 2, 16, generator=gen), dim=-1)
    v = torch.randn(3, 45, 2, 16, generator=gen)
    lo, hi = gate
    g = lo + (hi - lo) * torch.rand(3, 45, 2, 16, generator=gen)
    beta = torch.rand(3, 45, 2, generator=gen)
    plain = kda_chunked_plain(q, k, v, g, beta, torch.tensor(lengths), 16)
    for r, n in enumerate(lengths):
        want = recurrence(q[r, :n], k[r, :n], v[r, :n], g[r, :n], beta[r, :n])
        scale = want.abs().max()
        core = ref.kda_core(q[r, :n], k[r, :n], v[r, :n], g[r, :n], beta[r, :n], 16)
        for got in (plain[r, :n], core):
            assert torch.isfinite(got).all()
            assert (got.double() - want).abs().max() <= 1e-5 * scale
        assert not plain[r, n:].any()


def test_two_held_shares_sum_to_the_whole_expert_layer():
    """The layer's 8 experts held whole, and as two shares of 4 (experts 0-3
    and 4-7, the same weights): the shares' outputs, with the shared expert
    counted once, sum to the whole layer's, in the port and in the
    reference."""
    whole_cfg = KimiLinearConfig.tiny().replace(experts_held=8)
    g = torch.Generator().manual_seed(5)
    whole = moon.MoE(whole_cfg)
    for p in whole.parameters():
        p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    whole.gate.weight.mul_(5.0)
    x = torch.randn(40, whole_cfg.hidden_size, generator=g)
    want = moon.moe_apply(whole, whole_cfg, x)
    shared = moon.mlp_apply(whole.shared_experts, x)
    ref_whole = ref.Model({}, ref_cfg(EEModelConfig(whole_cfg, MoonlightExitConfig(exits=()))))
    lw = {f"m.{k}": v for k, v in whole.named_parameters()}
    ref_want, _, _ = ref_whole.experts(x, lw, "m")
    parts, ref_parts = [], []
    for off in (0, 4):
        cfg = whole_cfg.replace(experts_held=4, expert_offset=off)
        share = moon.MoE(cfg)
        share.load_state_dict({
            **{k: v for k, v in whole.state_dict().items() if not k.startswith("experts.")},
            "experts.gate_up_proj": whole.experts.gate_up_proj[off:off + 4],
            "experts.down_proj": whole.experts.down_proj[off:off + 4]})
        parts.append(moon.moe_apply(share, cfg, x))
        ref_share = ref.Model({}, ref_cfg(EEModelConfig(cfg, MoonlightExitConfig(exits=()))))
        slw = {f"m.{k}": v for k, v in share.named_parameters()}
        ref_parts.append(ref_share.experts(x, slw, "m")[0])
        assert share.experts.gate_up_proj.shape[0] == 4
    torch.testing.assert_close(parts[0] + parts[1] - shared, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ref_parts[0] + ref_parts[1] - shared, ref_want, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(want, ref_want, atol=1e-5, rtol=1e-5)


def test_padding_does_not_reach_the_answers():
    cfg, model = tiny_model(4)
    ids, mask = batch(14, LENGTHS["mixed"])
    other = torch.randint(0, 512, ids.shape, generator=torch.Generator().manual_seed(9))
    ids2 = torch.where(mask.bool(), ids, other.to(ids.dtype))
    a = ee_forward(model, cfg, ids, None, None, mask).policy_logits()
    b = ee_forward(model, cfg, ids2, None, None, mask).policy_logits()
    assert torch.equal(a, b)


def separating(crit: np.ndarray, q: float) -> float:
    v = np.sort(crit.ravel())
    i = min(max(int(q * len(v)), 1), len(v) - 1)
    return float(v[i - 1] + v[i]) / 2


@pytest.mark.parametrize("q", [0.3, 0.6, 0.9])
def test_cascade_equals_the_batched_forward(q):
    cfg, model = tiny_model(5)
    ids, mask = batch(5, LENGTHS["mixed"])
    out = ee_forward(model, cfg, ids, None, None, mask)
    crit = out.exit_criteria[:-1].numpy()
    thr = [separating(crit[0], q), separating(crit[1], q)]
    expected = decide_exits(out, cfg.exit, thr)
    res = make_cascade_forward(cfg, (B, B, B), thr)(model, ids, None, None, mask)
    assert torch.equal(res.exit_ids, expected)
    store = out.policy_logits()
    torch.testing.assert_close(res.logits, store[expected.long(), torch.arange(B)],
                               atol=1e-6, rtol=1e-5)


def test_pipeline_serves_long_text():
    from multi_modal_early_exit_tpu_torch.serving import Pipeline

    cfg, model = tiny_model(8)
    ids, mask = batch(8, LENGTHS["mixed"])
    pipe = Pipeline(model, cfg, threshold=[0.5, 0.5], batch_size=4, tokenizer=object(),
                    device="cpu")
    answers = pipe.predict_features({"input_ids": ids.numpy(), "attention_mask": mask.numpy()})
    out = ee_forward(model, cfg, ids, None, None, mask)
    exits = decide_exits(out, cfg.exit, [0.5, 0.5])
    assert [a["exit"] for a in answers] == exits.tolist()
    probs = torch.softmax(out.policy_logits()[exits.long(), torch.arange(B)].double(), -1)
    assert [a["label_id"] for a in answers] == probs.argmax(-1).tolist()


def test_spans_and_counters():
    from torch.profiler import ProfilerActivity, profile

    cfg, model = tiny_model(9)
    ids, mask = batch(9, LENGTHS["mixed"])
    cascade = make_cascade_forward(cfg, (B, B, B), [2.0, 2.0])
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cascade(model, ids, None, None, mask)
    after = profiling.counters()
    names = [e.name for e in prof.events()
             if e.name.startswith(("kda.", "mla.", "moe.", "cascade."))]
    bb = cfg.backbone
    n_kda = len(bb.kda_layers)
    assert names.count("kda.mixer") == names.count("kda.core") == n_kda
    assert names.count("mla.attention") == len(bb.full_attn_layers)
    assert names.count("moe.experts") == bb.num_hidden_layers - bb.first_k_dense_replace
    assert names[0] == "cascade.embed"
    real = sum(LENGTHS["mixed"])
    assert after["kda.tokens"] - before.get("kda.tokens", 0) == n_kda * real


def test_registry_builds_eekimilinear_and_refuses_to_train_it():
    from multi_modal_early_exit_tpu_torch.config.experiment import parse_cli
    from multi_modal_early_exit_tpu_torch.models.registry import (
        SERVED_ONLY,
        build_model,
        refuse_ee_trainer,
        trains_through_ee_trainer,
    )

    cfg = parse_cli(["with", "device=cpu", "model=EEkimilinear", "model_size=tiny",
                     "exits=2,4"])
    mcfg, model = build_model(cfg, num_labels=4)
    assert isinstance(mcfg.backbone, KimiLinearConfig) and mcfg.exit.exits == (2, 4)
    assert model.model_name == "EEkimilinear" and len(model.encoder_exits) == 2
    kinds = [type(layer.self_attn) for layer in model.backbone.layers]
    assert kinds == [modeling.KDA] * 3 + [moon.Attention, modeling.KDA]
    assert model.backbone.layers[1].mlp.experts.gate_up_proj.shape[0] == 4
    assert model.backbone.layers[1].mlp.gate.weight.shape[0] == 8
    assert "EEkimilinear" in SERVED_ONLY and not trains_through_ee_trainer("EEkimilinear")
    with pytest.raises(NotImplementedError, match="EEkimilinear"):
        refuse_ee_trainer("EEkimilinear")
    # the published widths, the card's share of the experts
    base = KimiLinearConfig.base()
    assert (base.num_hidden_layers, base.hidden_size, base.num_experts, base.experts_held,
            base.num_experts_per_tok, base.vocab_size) == (27, 2304, 256, 128, 8, 163840)
    assert [i + 1 for i in range(27) if not base.is_kda_layer(i)] == [4, 8, 12, 16, 20, 24, 27]
    with pytest.raises(NotImplementedError, match="mla_use_nope"):
        KimiLinearConfig(mla_use_nope=False)
    with pytest.raises(NotImplementedError, match="experts_held"):
        KimiLinearConfig(experts_held=200, expert_offset=100)


def test_the_mixer_hands_the_kernel_what_it_takes(monkeypatch):
    """At the kernel's head dim and chunk in bf16, every KDA core call's
    arguments pass the kernel's checks but for the device (the card's
    path takes them as they are)."""
    from multi_modal_early_exit_tpu_torch.ops import kda as kd

    bb = KimiLinearConfig.tiny().replace(kda_num_heads=1, kda_head_dim=128, chunk_size=64)
    cfg = EEModelConfig(backbone=bb, exit=MoonlightExitConfig(exits=(2, 4)))
    model = init_ee_params(cfg, torch.Generator().manual_seed(3), device="cpu",
                           dtype=torch.bfloat16)
    ids, mask = batch(3, LENGTHS["mixed"])
    seen = []
    real = modeling.kda

    def checked(q, k, v, g, beta, lengths, lengths_host, chunk):
        why = kd._refusal(q, k, v, g, beta, lengths.int(), lengths_host, chunk)
        seen.append(why)
        return real(q, k, v, g, beta, lengths, lengths_host, chunk)

    monkeypatch.setattr(modeling, "kda", checked)
    ee_forward(model, cfg, ids, None, None, mask)
    assert seen == ["the kernel runs on cuda, not cpu"] * len(bb.kda_layers)
