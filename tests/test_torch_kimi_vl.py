"""PyTorch port, early-exit Kimi-VL (``models/kimi_vl``) at a tiny size on
the CPU in f32, against the benchmark's plain reference
(``h100bench/reference/kimi_vl.py``): the vision tower's features and every
exit's logits over a batch of pages of different grids, the cascade against
the batched forward, no attention across pages and no padding patch in a
page's features, the 2D rotary embedding against its complex form, the
position table as it is and interpolated, ``Pipeline.predict_features``
over pages, the spans and counters, and the registry."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from h100bench.reference import kimi_vl as ref
from multi_modal_early_exit_tpu_torch.models.ee.cascade import make_cascade_forward
from multi_modal_early_exit_tpu_torch.models.ee.model import (
    decide_exits,
    ee_forward,
    init_ee_params,
)
from multi_modal_early_exit_tpu_torch.models.kimi_vl import modeling
from multi_modal_early_exit_tpu_torch.models.kimi_vl.config import KimiVLConfig, MoonViTConfig
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import EEModelConfig
from multi_modal_early_exit_tpu_torch.models.moonlight.config import MoonlightExitConfig
from multi_modal_early_exit_tpu_torch.utils import profiling

torch.set_num_threads(2)

# 4 x 4 is the position table's own grid; the others interpolate it
GRIDS = [(4, 4), (4, 6), (6, 4), (2, 8), (6, 6)]
P, S, PROMPT = 36, 16, 6
B = len(GRIDS)


@pytest.fixture(autouse=True)
def _inference():
    with torch.no_grad():
        yield


def tiny_model(seed=0):
    cfg = EEModelConfig(backbone=KimiVLConfig.tiny(), exit=MoonlightExitConfig(exits=(1, 2)))
    model = init_ee_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    # heads of unit-scale logits, so the criteria spread
    for head in list(model.encoder_exits) + [model.backbone.classifier]:
        head.out_proj.weight.mul_(50.0)
    return cfg, model


def pages(seed, grids=GRIDS, prompt=PROMPT):
    """A request: each row its page's placeholder ids, then ``prompt`` ids,
    right-padded; its page's patch rows padded with noise to P rows."""
    bb = KimiVLConfig.tiny()
    g = torch.Generator().manual_seed(seed)
    n = len(grids)
    pix = torch.randn(n, P, bb.vision.patch_dim, generator=g)
    ids = torch.zeros(n, S, dtype=torch.int32)
    mask = torch.zeros(n, S, dtype=torch.int32)
    for i, (h, w) in enumerate(grids):
        t = h * w // bb.vision.merged
        ids[i, :t] = bb.media_placeholder_token_id
        ids[i, t:t + prompt] = torch.randint(0, 400, (prompt,), generator=g)
        mask[i, :t + prompt] = 1
    return {"input_ids": ids, "attention_mask": mask, "pixel_values": pix,
            "image_grid_hws": torch.tensor(grids)}


def ref_cfg(cfg) -> dict:
    bb = cfg.backbone
    d = {f.name: getattr(bb.text, f.name) for f in dataclasses.fields(bb.text)}
    d.update(vision_config=dataclasses.asdict(bb.vision), exits=list(cfg.exit.exits),
             media_placeholder_token_id=bb.media_placeholder_token_id,
             projector_ln_eps=bb.projector_ln_eps)
    return d


def reference(cfg, model, req, block=2):
    return ref.infer(dict(model.state_dict()), ref_cfg(cfg), req, block)


def forward(cfg, model, req):
    return ee_forward(model, cfg, req["input_ids"], None, req["pixel_values"],
                      req["attention_mask"], image_grid_hws=req["image_grid_hws"])


def features(cfg, model, req):
    return modeling.vision_apply(model.backbone, cfg.backbone, req["pixel_values"],
                                 [tuple(g) for g in req["image_grid_hws"].tolist()])


@pytest.mark.parametrize("seed", [0, 1])
def test_vision_features_and_every_exit_match_the_reference(seed):
    """Both sides f32; they differ in the order of their sums (a product
    against a convolution, real pairs against complex numbers), so each
    output agrees to 1e-5 of its scale."""
    cfg, model = tiny_model(seed)
    req = pages(seed + 10)
    want = reference(cfg, model, req)
    got = features(cfg, model, req)
    assert got.shape == (sum(h * w for h, w in GRIDS) // 4, cfg.backbone.hidden_size)
    for mine, theirs in zip(got.split([h * w // 4 for h, w in GRIDS]), want["vision"]):
        assert (mine - theirs).abs().max() <= 1e-5 * theirs.abs().max()
    logits = forward(cfg, model, req).policy_logits()
    assert logits.shape == want["logits"].shape == (3, B, 4)
    for e in range(3):
        scale = want["logits"][e].abs().max()
        assert (logits[e] - want["logits"][e]).abs().max() <= 1e-5 * scale, e


def separating(crit: np.ndarray, q: float) -> float:
    v = np.sort(crit.ravel())
    i = min(max(int(q * len(v)), 1), len(v) - 1)
    return float(v[i - 1] + v[i]) / 2


@pytest.mark.parametrize("q", [0.3, 0.6, 0.9])
def test_cascade_equals_the_batched_forward(q):
    """The exit decisions bit-equal to the exact threshold policy on the
    batched forward's criteria; the logits the same computation's."""
    cfg, model = tiny_model(5)
    req = pages(5)
    out = forward(cfg, model, req)
    crit = out.exit_criteria[:-1].numpy()
    thr = [separating(crit[0], q), separating(crit[1], q)]
    expected = decide_exits(out, cfg.exit, thr)
    res = make_cascade_forward(cfg, (B, B, B), thr)(
        model, req["input_ids"], None, req["pixel_values"], req["attention_mask"],
        req["image_grid_hws"])
    assert torch.equal(res.exit_ids, expected)
    assert not res.capacity_exited.any()
    store = out.policy_logits()
    torch.testing.assert_close(res.logits, store[expected.long(), torch.arange(B)],
                               atol=1e-6, rtol=1e-5)


def test_no_attention_crosses_pages_and_padding_stays_out():
    """One page's pixels changed, or every page's padding rows: every other
    page's features bit for bit the same."""
    cfg, model = tiny_model(3)
    req = pages(3)
    base = features(cfg, model, req)
    sizes = [h * w // 4 for h, w in GRIDS]
    other = dict(req, pixel_values=req["pixel_values"].clone())
    other["pixel_values"][2, :24] += 1.0
    moved = features(cfg, model, other)
    for i, (a, b) in enumerate(zip(base.split(sizes), moved.split(sizes))):
        assert torch.equal(a, b) != (i == 2), i
    padded = dict(req, pixel_values=req["pixel_values"].clone())
    for i, (h, w) in enumerate(GRIDS):
        padded["pixel_values"][i, h * w:] = 1e4
    assert torch.equal(features(cfg, model, padded), base)


@pytest.mark.parametrize("grid", [(4, 6), (8, 2)])
def test_rope2d_matches_the_complex_form(grid):
    h, w = grid
    v = MoonViTConfig(hidden_size=32, num_attention_heads=2)  # head dim 16
    pages_ = modeling.pages_of([grid], h * w, v, "cpu")
    turns = modeling.rope2d(v, pages_.rows, pages_.cols)
    x = torch.randn(h * w, 2, 16, generator=torch.Generator().manual_seed(4))
    got = modeling.apply_rope2d(x, turns)
    vision = ref.Vision({}, {"vision_config": dataclasses.asdict(v)})
    want = vision.rotate(x, vision.freqs_cis(h, w, "cpu"))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    # pair 0 turns with the column alone, pair 1 with the row alone; the
    # turn at a pair is the same in q and k, so a score reads offsets only
    cols, rows = pages_.cols.float(), pages_.rows.float()
    torch.testing.assert_close(turns[:, 0].real, cols.cos())
    torch.testing.assert_close(turns[:, 1].real, rows.cos())
    q, k = got[:, 0], got[:, 1]
    rolled = modeling.apply_rope2d(x, turns * turns[w + 1][None])  # one patch down and right
    torch.testing.assert_close(rolled[:, 0] @ rolled[:, 1].T, q @ k.T, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("grids", [[(4, 4), (6, 2)], [(8, 8), (2, 4), (4, 4)]],
                         ids=["up", "down"])
def test_the_position_table_as_it_is_and_interpolated(grids):
    """At its own grid the table is added bit for bit; elsewhere its two
    products with the resampling matrices are ``F.interpolate``'s bicubic
    resampling (in f64, as the reference computes it) to f32 rounding."""
    v = MoonViTConfig(hidden_size=8, num_attention_heads=2, init_pos_emb_height=4,
                      init_pos_emb_width=4)
    table = modeling.PositionTable(v)
    table.weight.copy_(torch.randn(4, 4, 8, generator=torch.Generator().manual_seed(6)))
    pages_ = modeling.pages_of(grids, 64, v, "cpu")
    got = modeling.positions(table, pages_, torch.float32).split([h * w for h, w in grids])
    vision = ref.Vision({"backbone.vision_tower.patch_embed.pos_emb.weight": table.weight}, {
        "vision_config": {}})
    for (h, w), mine in zip(grids, got):
        if (h, w) == (4, 4):
            assert pages_.resample[grids.index((4, 4))] is None
            assert torch.equal(mine, table.weight.reshape(16, 8))
            continue
        want = F.interpolate(table.weight.double().permute(2, 0, 1)[None], size=(h, w),
                             mode="bicubic", align_corners=False)[0].permute(1, 2, 0)
        want = want.reshape(h * w, 8).float()
        torch.testing.assert_close(mine, want, atol=1e-6, rtol=1e-6)
        assert torch.equal(vision.positions(h, w), want)
        assert not torch.allclose(want[:4], table.weight[0])


def test_pipeline_serves_pages():
    """Requests of 5 pages at batch 2: chunked and padded by repeating rows,
    each answer the exact policy's on the batched forward."""
    from multi_modal_early_exit_tpu_torch.serving import Pipeline

    cfg, model = tiny_model(8)
    req = pages(8)
    out = forward(cfg, model, req)
    thr = [separating(out.exit_criteria[j].numpy(), 0.5) for j in range(2)]
    pipe = Pipeline(model, cfg, threshold=thr, batch_size=2, tokenizer=object(), device="cpu")
    answers = pipe.predict_features({k: v.numpy() for k, v in req.items()})
    exits = decide_exits(out, cfg.exit, thr)
    assert [a["exit"] for a in answers] == exits.tolist()
    probs = torch.softmax(out.policy_logits()[exits.long(), torch.arange(B)].double(), -1)
    assert [a["label_id"] for a in answers] == probs.argmax(-1).tolist()
    with pytest.raises(ValueError, match="image_grid_hws"):
        pipe.predict_features({k: v.numpy() for k, v in req.items() if k != "image_grid_hws"})


def test_spans_and_counters():
    from torch.profiler import ProfilerActivity, profile

    cfg, model = tiny_model(9)
    req = pages(9)
    cascade = make_cascade_forward(cfg, (B, B, B), [2.0, 2.0])
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cascade(model, req["input_ids"], None, req["pixel_values"], req["attention_mask"],
                req["image_grid_hws"])
    after = profiling.counters()
    names = [e.name for e in prof.events() if e.name.startswith(("vit.", "cascade.", "mla."))]
    layers = cfg.backbone.vision.num_hidden_layers
    # the host's packing of the pages, then the tower
    assert names[:3] == ["cascade.embed", "vit.pack", "vit.tower"]
    assert names.count("vit.attention") == layers and names.count("vit.merge") == 1
    assert names.count("mla.attention") == cfg.backbone.num_hidden_layers
    sizes = np.array([h * w for h, w in GRIDS])
    for name, want in (("vit.pages", B), ("vit.patches", sizes.sum()),
                       ("vit.patch_pairs", (sizes ** 2).sum())):
        assert after[name] - before.get(name, 0) == want, name


def test_the_config_refuses_what_it_does_not_compute():
    with pytest.raises(NotImplementedError, match="hidden_act"):
        MoonViTConfig(hidden_act="gelu")
    with pytest.raises(NotImplementedError, match="heads"):
        MoonViTConfig(hidden_size=1152, num_attention_heads=64)  # head dim 18
    with pytest.raises(ValueError, match="placeholder"):
        KimiVLConfig.tiny().replace(media_placeholder_token_id=512)
    base = KimiVLConfig.base()
    assert (base.rope_theta, base.num_hidden_layers, base.hidden_size, base.vision.head_dim,
            base.vision.patch_dim) == (800000.0, 27, 2048, 72, 588)
    with pytest.raises(ValueError, match="tile"):
        modeling.pages_of([(5, 4)], 36, MoonViTConfig(), "cpu")


def test_registry_builds_eekimivl_and_refuses_to_train_it():
    from multi_modal_early_exit_tpu_torch.config.experiment import parse_cli
    from multi_modal_early_exit_tpu_torch.models.registry import (
        build_model,
        refuse_ee_trainer,
        splits_over_model_axis,
        trains_through_ee_trainer,
    )

    cfg = parse_cli(["with", "device=cpu", "model=EEkimivl", "model_size=tiny", "exits=1,2"])
    mcfg, model = build_model(cfg, num_labels=4)
    assert isinstance(mcfg.backbone, KimiVLConfig) and mcfg.exit.exits == (1, 2)
    assert model.model_name == "EEkimivl" and len(model.encoder_exits) == 2
    assert isinstance(model.backbone, modeling.KimiVLModel)
    assert not trains_through_ee_trainer("EEkimivl")
    assert not splits_over_model_axis("EEkimivl")
    with pytest.raises(NotImplementedError, match="EEkimivl"):
        refuse_ee_trainer("EEkimivl")
    with pytest.raises(ValueError, match="embedding"):
        build_model(cfg.replace(exits="text_avg,1"), num_labels=4)
    _, cut = build_model(cfg, num_labels=4, num_hidden_layers=2)
    assert len(cut.backbone.layers) == 2
