"""PyTorch port, early-exit Moonlight (``models/moonlight``) at a tiny size on
the CPU in f32, against the benchmark's plain reference
(``h100bench/reference/moonlight.py``): every exit's and the classifier's
logits, the router's choices and weights (correction bias, a forced tie),
padding kept out of the experts and of the answers, the cascade against the
exact threshold policy, ``Pipeline.predict_features`` on text alone, the
spans and counters, and the registry's build."""

import numpy as np
import pytest
import torch

from h100bench.reference import moonlight as ref
from multi_modal_early_exit_tpu_torch.models.ee.cascade import make_cascade_forward
from multi_modal_early_exit_tpu_torch.models.ee.model import (
    decide_exits,
    ee_forward,
    init_ee_params,
)
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import EEModelConfig
from multi_modal_early_exit_tpu_torch.models.moonlight import modeling
from multi_modal_early_exit_tpu_torch.models.moonlight.config import (
    MoonlightConfig,
    MoonlightExitConfig,
)
from multi_modal_early_exit_tpu_torch.ops.grouped_mm import grouped_mm_plain
from multi_modal_early_exit_tpu_torch.utils import profiling

torch.set_num_threads(2)

B, S = 6, 40
LENGTHS = {"mixed": [40, 11, 25, 3, 40, 17], "full": [S] * B, "short": [1, 2, 3, 4, 5, 6]}


@pytest.fixture(autouse=True)
def _inference():
    with torch.no_grad():
        yield


def tiny_model(seed=0, exits=(1, 2), **over):
    cfg = EEModelConfig(backbone=MoonlightConfig.tiny().replace(**over),
                        exit=MoonlightExitConfig(exits=exits))
    model = init_ee_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    # heads of unit-scale logits, so the criteria spread
    for head in list(model.encoder_exits) + [model.backbone.classifier]:
        head.out_proj.weight.mul_(50.0)
    return cfg, model


def batch(seed, lengths, vocab=512, pad_id=0):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, vocab, (len(lengths), S), generator=g)
    mask = (torch.arange(S)[None, :] < torch.tensor(lengths)[:, None]).to(torch.int32)
    return torch.where(mask.bool(), ids, pad_id).to(torch.int32), mask


def ref_cfg(cfg) -> dict:
    bb = cfg.backbone
    d = {k: getattr(bb, k) for k in bb.__dataclass_fields__}
    d["exits"] = list(cfg.exit.exits)
    return d


def reference(cfg, model, ids, mask, block=4):
    return ref.infer(dict(model.state_dict()), ref_cfg(cfg),
                     {"input_ids": ids, "attention_mask": mask}, block)


@pytest.mark.parametrize("lengths", list(LENGTHS), ids=list(LENGTHS))
@pytest.mark.parametrize("seed", [0, 1])
def test_exit_and_classifier_logits_match_the_reference(seed, lengths):
    cfg, model = tiny_model(seed)
    ids, mask = batch(seed + 10, LENGTHS[lengths])
    got = ee_forward(model, cfg, ids, None, None, mask).policy_logits()
    want = reference(cfg, model, ids, mask)["logits"]
    assert got.shape == want.shape == (3, B, 4)
    for e in range(3):
        scale = want[e].abs().max()
        assert (got[e] - want[e]).abs().max() <= 1e-5 * scale, e


@pytest.mark.parametrize("case", ["plain", "bias", "tie"])
def test_router_choice_and_weights(case):
    cfg = MoonlightConfig.tiny()
    g = torch.Generator().manual_seed(3)
    moe = modeling.MoE(cfg)
    params = dict(moe.named_parameters())
    for p in params.values():
        p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    router = moe.gate
    router.weight.mul_(10.0)
    router.e_score_correction_bias.zero_()
    x = torch.randn(50, cfg.hidden_size, generator=g)
    if case == "bias":
        # a bias that moves expert 5 into every token's choice, and expert 0 out
        router.e_score_correction_bias[5] = 2.0
        router.e_score_correction_bias[0] = -2.0
    if case == "tie":
        # experts 1 and 2 score alike on every token; both sides take torch.topk's pick
        router.weight[2] = router.weight[1]
    chosen, weights = modeling.route(router, cfg, x)
    scores = torch.sigmoid(x @ router.weight.T)
    want = torch.topk(scores + router.e_score_correction_bias, cfg.num_experts_per_tok,
                      sorted=False).indices
    assert torch.equal(chosen, want)
    w = scores.gather(1, chosen)
    torch.testing.assert_close(weights, w / w.sum(-1, keepdim=True) * cfg.routed_scaling_factor)
    if case == "bias":
        assert (chosen == 5).any(dim=1).all() and not (chosen == 0).any()
    if case == "tie":
        assert ((chosen == 1) | (chosen == 2)).any()
    # the reference's expert layer makes the same choices and gives the same output
    ref_model = ref.Model({}, ref_cfg(EEModelConfig(cfg, MoonlightExitConfig(exits=()))))
    lw = {f"m.{k}": v for k, v in params.items()}
    out_ref, chosen_ref, _ = ref_model.experts(x, lw, "m")
    assert torch.equal(chosen_ref.sort(dim=1).values, chosen.sort(dim=1).values)
    torch.testing.assert_close(modeling.moe_apply(moe, cfg, x), out_ref, atol=1e-5, rtol=1e-5)
    # forced to the program's own choices: the same output, nothing unlike, margin 0
    out_forced, _, stats = ref_model.experts(x, lw, "m", chosen)
    torch.testing.assert_close(out_forced, out_ref)
    assert stats == {"margin": 0.0, "unlike": 0, "pairs": chosen.numel()}
    # forced to a worse expert: the margin is its corrected score's shortfall
    worse = chosen.clone()
    corrected = scores + router.e_score_correction_bias
    last = corrected.argmin(dim=1)
    worse[:, 0] = last
    _, _, stats = ref_model.experts(x, lw, "m", worse)
    kth = torch.topk(corrected, cfg.num_experts_per_tok).values[:, -1]
    shortfall = kth - corrected.gather(1, worse).amin(dim=1)
    assert stats["margin"] == pytest.approx(float(shortfall.max()))
    assert stats["unlike"] == int((worse[:, 0] != chosen[:, 0]).sum())


@pytest.mark.parametrize("pad", ["zeros", "random", "max_id"])
def test_padding_is_not_routed_and_does_not_reach_the_answers(pad):
    cfg, model = tiny_model(4)
    lengths = LENGTHS["mixed"]
    ids, mask = batch(14, lengths)
    if pad == "random":
        other = torch.randint(0, 512, ids.shape, generator=torch.Generator().manual_seed(9))
    else:
        other = torch.full_like(ids, 0 if pad == "zeros" else 511)
    ids2 = torch.where(mask.bool(), ids, other.to(ids.dtype))
    seen = []
    route = modeling.route

    def recording(p, c, x):
        seen.append(x.shape[0])
        return route(p, c, x)

    modeling.route = recording
    try:
        before = profiling.counters()
        a = ee_forward(model, cfg, ids, None, None, mask).policy_logits()
        after = profiling.counters()
    finally:
        modeling.route = route
    b = ee_forward(model, cfg, ids2, None, None, mask).policy_logits()
    n_moe = cfg.backbone.num_hidden_layers - cfg.backbone.first_k_dense_replace
    assert seen == [sum(lengths)] * n_moe
    assert after["moe.tokens"] - before.get("moe.tokens", 0) == sum(lengths) * n_moe
    assert (after["moe.routed_pairs"] - before.get("moe.routed_pairs", 0)
            == sum(lengths) * n_moe * cfg.backbone.num_experts_per_tok)
    assert torch.equal(a, b)


@pytest.mark.parametrize("tokens", [7, 64])
def test_mlp_passes_leave_the_logits_unchanged(monkeypatch, tokens):
    """The MLP sub-layer's tokens in passes of ``MLP_TOKENS``: the same logits
    as in one pass, every real token routed once a layer."""
    cfg, model = tiny_model(12)
    ids, mask = batch(12, LENGTHS["mixed"])
    whole = ee_forward(model, cfg, ids, None, None, mask).policy_logits()
    monkeypatch.setattr(modeling, "MLP_TOKENS", tokens)
    before = profiling.counters().get("moe.tokens", 0)
    parts = ee_forward(model, cfg, ids, None, None, mask).policy_logits()
    n_moe = cfg.backbone.num_hidden_layers - cfg.backbone.first_k_dense_replace
    assert profiling.counters()["moe.tokens"] - before == sum(LENGTHS["mixed"]) * n_moe
    torch.testing.assert_close(parts, whole, atol=1e-6, rtol=1e-6)


def separating(crit: np.ndarray, q: float) -> float:
    """A threshold between two neighbouring criteria near quantile q."""
    v = np.sort(crit.ravel())
    i = min(max(int(q * len(v)), 1), len(v) - 1)
    return float(v[i - 1] + v[i]) / 2


@pytest.mark.parametrize("q", [0.3, 0.6, 0.9])
@pytest.mark.parametrize("seed", [5, 6])
def test_cascade_equals_the_exact_threshold_policy(seed, q):
    cfg, model = tiny_model(seed)
    ids, mask = batch(seed, LENGTHS["mixed"])
    out = ee_forward(model, cfg, ids, None, None, mask)
    crit = out.exit_criteria[:-1].numpy()
    thr = [separating(crit[0], q), separating(crit[1], q)]
    expected = decide_exits(out, cfg.exit, thr)
    res = make_cascade_forward(cfg, (B, B, B), thr)(model, ids, None, None, mask)
    assert torch.equal(res.exit_ids, expected)
    assert not res.capacity_exited.any()
    store = out.policy_logits()
    torch.testing.assert_close(res.logits, store[expected.long(), torch.arange(B)],
                               atol=1e-6, rtol=1e-5)


def test_tight_capacities_force_exits_at_the_last_exit():
    cfg, model = tiny_model(7)
    ids, mask = batch(7, LENGTHS["mixed"])
    res = make_cascade_forward(cfg, (B, 2, 2), [2.0, 2.0])(model, ids, None, None, mask)
    # nobody clears a threshold above 1: stage 1 keeps 2 rows, stage 2 two of them
    assert int(res.capacity_exited.sum()) == B - 2
    assert sorted(res.exit_ids.tolist()) == [0] * (B - 2) + [2, 2]


def test_pipeline_serves_text_alone(monkeypatch):
    from multi_modal_early_exit_tpu_torch.serving import Pipeline

    cfg, model = tiny_model(8)
    ids, mask = batch(8, LENGTHS["mixed"])
    pipe = Pipeline(model, cfg, threshold=[0.5, 0.5], batch_size=4,
                    tokenizer=object(), device="cpu")
    answers = pipe.predict_features({"input_ids": ids.numpy(), "attention_mask": mask.numpy()})
    out = ee_forward(model, cfg, ids, None, None, mask)
    exits = decide_exits(out, cfg.exit, [0.5, 0.5])
    assert [a["exit"] for a in answers] == exits.tolist()
    probs = torch.softmax(out.policy_logits()[exits.long(), torch.arange(B)].double(), -1)
    assert [a["label_id"] for a in answers] == probs.argmax(-1).tolist()


def test_spans_sit_at_sub_layer_edges():
    from torch.profiler import ProfilerActivity, profile

    cfg, model = tiny_model(9)
    ids, mask = batch(9, LENGTHS["mixed"])
    cascade = make_cascade_forward(cfg, (B, B, B), [2.0, 2.0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cascade(model, ids, None, None, mask)
    names = [e.name for e in prof.events() if e.name.startswith(("moe.", "mla.", "cascade."))]
    n_layers, n_moe = cfg.backbone.num_hidden_layers, cfg.backbone.num_hidden_layers - 1
    assert names.count("mla.attention") == n_layers
    for span in ("moe.router", "moe.experts", "moe.shared"):
        assert names.count(span) == n_moe
    assert names[0] == "cascade.embed"


@pytest.mark.parametrize("empty", [False, True], ids=["all", "some_empty"])
def test_grouped_product_matches_the_loop(empty):
    g = torch.Generator().manual_seed(11)
    x = torch.randn(30, 16, generator=g).to(torch.bfloat16)
    w = torch.randn(5, 8, 16, generator=g).to(torch.bfloat16)
    counts = [0, 12, 0, 10, 8] if empty else [6, 6, 6, 6, 6]
    offs = torch.tensor(np.cumsum(counts), dtype=torch.int32)
    # the card's call (PyTorch's grouped product on the weights' transpose)
    got = torch._grouped_mm(x, w.transpose(-2, -1), offs=offs)
    torch.testing.assert_close(got.float(), grouped_mm_plain(x.float(), w.float(), offs),
                               atol=2e-2, rtol=2e-2)


def test_registry_builds_eemoonlight():
    from multi_modal_early_exit_tpu_torch.config.experiment import parse_cli
    from multi_modal_early_exit_tpu_torch.models.registry import (
        build_model,
        splits_over_model_axis,
        trains_through_ee_trainer,
    )

    cfg = parse_cli(["with", "device=cpu", "model=EEmoonlight", "model_size=tiny", "exits=1,2"])
    mcfg, model = build_model(cfg, num_labels=4)
    assert isinstance(mcfg.backbone, MoonlightConfig) and mcfg.exit.exits == (1, 2)
    assert model.model_name == "EEmoonlight" and len(model.encoder_exits) == 2
    assert not trains_through_ee_trainer("EEmoonlight")
    assert not splits_over_model_axis("EEmoonlight")
    with pytest.raises(ValueError, match="embedding"):
        build_model(cfg.replace(exits="text_avg,1"), num_labels=4)
    # the published widths
    assert MoonlightExitConfig(exits=(9, 18)).exits == (9, 18)
    base = MoonlightConfig.base()
    assert (base.num_hidden_layers, base.n_routed_experts, base.num_experts_per_tok,
            base.vocab_size, base.q_head_dim) == (27, 64, 6, 163840, 192)
