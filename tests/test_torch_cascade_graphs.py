"""PyTorch port, the cascade's CUDA graphs: which calls replay graphs, the
tallies a capture records and each replay adds again, and on the card the
replayed calls against the same calls run op by op.

The tests marked ``cuda`` need an sm_90 card and skip elsewhere: on the
card, ``python -m pytest tests/test_torch_cascade_graphs.py -q
--noconftest``. This file imports no JAX.
"""

import pytest
import torch

from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig
from multi_modal_early_exit_tpu_torch.models.ee.cascade import (
    make_cascade_forward,
    uses_cuda_graphs,
)
from multi_modal_early_exit_tpu_torch.models.ee.model import (
    backbone_stages,
    decide_exits,
    ee_forward,
    init_ee_params,
)
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import (
    EEModelConfig,
    LayoutLMv3Config,
)
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import LayoutLMv3Stages
from multi_modal_early_exit_tpu_torch.models.moonlight.config import (
    MoonlightConfig,
    MoonlightExitConfig,
)
from multi_modal_early_exit_tpu_torch.serving import Pipeline
from multi_modal_early_exit_tpu_torch.utils import profiling

torch.set_num_threads(2)

CFG = EEModelConfig(backbone=LayoutLMv3Config.tiny(), exit=ExitConfig(exits=("text_avg", 1)))
MOON = EEModelConfig(backbone=MoonlightConfig.tiny(), exit=MoonlightExitConfig(exits=(1, 2)))
REPLAYS, EAGER = "cascade.graph_replays", "cascade.eager_calls"


@pytest.fixture(autouse=True)
def _inference():
    with torch.no_grad():
        yield


def features(n, seed=0, seq=32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(3, CFG.backbone.vocab_size, (n, seq), generator=g),
            torch.sort(torch.randint(0, 1000, (n, seq, 4), generator=g), -1).values,
            torch.randn((n, 3, 32, 32), generator=g),
            torch.ones((n, seq), dtype=torch.int64))


def tiny_model(device="cpu", dtype=torch.float32, seed=4):
    model = init_ee_params(CFG, torch.Generator().manual_seed(seed), device="cpu")
    # heads of unit-scale logits, so the criteria spread over the batch
    for head in (*model.embedding_exits.values(), *model.encoder_exits,
                 model.backbone.classifier):
        head.out_proj.weight.mul_(40.0)
    return model.to(device, dtype)


def delta(before, *names):
    now = profiling.counters()
    return [now.get(n, 0) - before.get(n, 0) for n in names]


def same(a, b) -> bool:
    return (torch.equal(a.logits, b.logits) and torch.equal(a.exit_ids, b.exit_ids)
            and torch.equal(a.capacity_exited, b.capacity_exited))


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stages, device, graphed", [
    (LayoutLMv3Stages(CFG.backbone), "cpu", False),
    (backbone_stages(MOON.backbone), "cpu", False),
    (backbone_stages(CFG.backbone), "meta", False),
])
def test_graphs_only_for_static_stages_on_cuda(stages, device, graphed):
    """LayoutLMv3's stages declare static shapes and Moonlight's do not;
    inputs off CUDA never replay a graph."""
    x = torch.zeros((2, 3), device=device)
    assert uses_cuda_graphs(stages, x) is graphed
    assert stages.static_shapes is isinstance(stages, LayoutLMv3Stages)


def test_recorded_tallies_are_taken_out_and_added_per_replay():
    """What a captured block tallied (named counters and kernel launches,
    ``add_layer_norm``'s among them, alike) is taken out at the block's
    end and added again once per ``add_tallies``."""
    profiling.count("kept", 2)
    before = profiling.counters()
    launches = profiling.launch_counts()
    with profiling.recorded_tallies() as tallies:
        profiling.count("kept", 3)
        profiling.count("new.rows", 16)
        profiling.count("launches.add_layer_norm", 5)
        profiling.count("launches.flash_attention_packed", 2)
    assert profiling.counters() == before  # "new.rows" did not exist before
    assert profiling.launch_counts() == launches
    for n in range(1, 4):
        profiling.add_tallies(tallies)
        assert delta(before, "kept", "new.rows") == [3 * n, 16 * n]
        now = profiling.launch_counts()
        assert now["add_layer_norm"] == launches.get("add_layer_norm", 0) + 5 * n
        assert (now["flash_attention_packed"]
                == launches.get("flash_attention_packed", 0) + 2 * n)


def test_recorded_tallies_of_a_block_that_tallied_nothing():
    before = profiling.counters()
    with profiling.recorded_tallies() as tallies:
        pass
    assert tallies == {}
    profiling.add_tallies(tallies)
    assert profiling.counters() == before


@pytest.mark.parametrize("caps", [(6, 6), (2, 1)])
def test_cpu_cascade_runs_op_by_op_and_keeps_its_results(caps):
    """On the CPU every call runs op by op: at full capacity its decisions
    are the exact policy's, and an earlier call's result is its own."""
    model = tiny_model()
    first, second = features(6, seed=1), features(6, seed=2)
    crit = ee_forward(model, CFG, *first).exit_criteria
    thr = [float(crit[j].median()) for j in range(crit.shape[0] - 1)]
    fn = make_cascade_forward(CFG, caps, thr)
    before = profiling.counters()
    got = fn(model, *first)
    kept = [t.clone() for t in (got.logits, got.exit_ids, got.capacity_exited)]
    fn(model, *second)
    assert delta(before, REPLAYS, EAGER) == [0, 2]
    assert all(torch.equal(a, b) for a, b in
               zip(kept, (got.logits, got.exit_ids, got.capacity_exited)))
    if caps == (6, 6):
        out = ee_forward(model, CFG, *first)
        want_ids = decide_exits(out, CFG.exit, thr).long()
        want_logits = out.policy_logits()[want_ids, torch.arange(6)].float()
        assert torch.equal(got.exit_ids.long(), want_ids)
        torch.testing.assert_close(got.logits, want_logits, atol=1e-5, rtol=1e-5)
        assert not got.capacity_exited.any()
    else:
        assert got.capacity_exited.any()


def test_uncounted_takes_out_launches_and_counts():
    """``uncounted`` is ``recorded_tallies`` with the record dropped:
    every kernel's launches (``add_layer_norm``'s among them) and the
    named counters read after the block as before it."""
    profiling.count("launches.add_layer_norm")
    launches = profiling.launch_counts()
    assert launches["add_layer_norm"] == profiling.counters()["launches.add_layer_norm"]
    before = profiling.counters()
    with profiling.uncounted():
        profiling.count("layer_norm.fused_rows", 32)
        profiling.count("launches.add_layer_norm", 4)
        profiling.count("launches.split_bf16x3")
    assert profiling.counters() == before
    assert profiling.launch_counts() == launches


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) CUDA device")
    return torch.device("cuda")


def on_card(batch, cuda, dtype=torch.bfloat16):
    ids, bbox, pages, mask = batch
    return ids.to(cuda), bbox.to(cuda), pages.to(cuda, dtype), mask.to(cuda)


def op_by_op(monkeypatch, fn, *args):
    """``fn(*args)`` with LayoutLMv3's stages taken as dynamic: op by op."""
    with monkeypatch.context() as m:
        m.setattr(LayoutLMv3Stages, "static_shapes", False)
        return fn(*args)


def thresholds(model, batch):
    crit = ee_forward(model, CFG, *batch).exit_criteria.float()
    return [float(crit[j].median()) for j in range(crit.shape[0] - 1)]


@pytest.mark.cuda
def test_replays_equal_the_calls_op_by_op(cuda, monkeypatch):
    """Five batches of 16 at capacities (6, 3): the first captures, the
    next four replay; every result is bit-equal to the same call run op
    by op, with rows that exit early and rows forced out by capacity."""
    model = tiny_model(cuda, torch.bfloat16)
    batches = [on_card(features(16, seed=s), cuda) for s in range(5)]
    thr = thresholds(model, batches[0])
    graphed = make_cascade_forward(CFG, (6, 3), thr)
    eager = make_cascade_forward(CFG, (6, 3), thr)
    before = profiling.counters()
    exits, forced = set(), 0
    for batch in batches:
        got = graphed(model, *batch)
        want = op_by_op(monkeypatch, eager, model, *batch)
        assert same(got, want)
        exits |= set(got.exit_ids.tolist())
        forced += int(got.capacity_exited.sum())
    assert delta(before, REPLAYS, EAGER) == [4, 1 + 5]
    assert {0, 1} & exits and forced > 0, (exits, forced)


@pytest.mark.cuda
def test_the_stages_never_wait_on_the_card(cuda):
    """Run op by op with PyTorch's synchronisation check raising: nothing
    between the embedding and the last stage's scatter waits on the card
    (a wait could not be captured, and stalls the host's launches)."""
    model = tiny_model(cuda, torch.bfloat16)
    batch = on_card(features(16, seed=5), cuda)
    fn = make_cascade_forward(CFG, (6, 3), thresholds(model, batch))
    fn(model, *batch)  # builds the kernels and captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.MonkeyPatch.context() as m:
            m.setattr(LayoutLMv3Stages, "static_shapes", False)
            fn(model, *batch)
        fn(model, *batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_a_result_outlives_the_next_call(cuda):
    model = tiny_model(cuda, torch.bfloat16)
    a, b = (on_card(features(16, seed=s), cuda) for s in (7, 8))
    fn = make_cascade_forward(CFG, (8, 4), thresholds(model, a))
    fn(model, *a)  # captures
    first = fn(model, *a)
    kept = [t.clone() for t in (first.logits, first.exit_ids, first.capacity_exited)]
    second = fn(model, *b)
    assert first.logits.data_ptr() != second.logits.data_ptr()
    assert all(torch.equal(x, y) for x, y in
               zip(kept, (first.logits, first.exit_ids, first.capacity_exited)))
    assert not torch.equal(first.logits, second.logits)


@pytest.mark.cuda
def test_each_input_shape_gets_its_own_capture(cuda, monkeypatch):
    model = tiny_model(cuda, torch.bfloat16)
    big, small = on_card(features(16, seed=3), cuda), on_card(features(8, seed=4), cuda)
    fn = make_cascade_forward(CFG, (8, 4), thresholds(model, big))
    before = profiling.counters()
    results = [fn(model, *x) for x in (big, big, small, small, big, small)]
    assert delta(before, REPLAYS, EAGER) == [4, 2]
    for got, x in zip(results, (big, big, small, small, big, small)):
        assert same(got, op_by_op(monkeypatch, fn, model, *x))


@pytest.mark.cuda
def test_moved_parameters_get_a_new_capture(cuda, monkeypatch):
    """A ``.to()`` that moves the parameters after a key's first call
    takes a new capture: no replay reads the memory they left."""
    model = tiny_model(cuda, torch.bfloat16)
    batch = on_card(features(16, seed=6), cuda)
    fn = make_cascade_forward(CFG, (8, 4), thresholds(model, batch))
    fn(model, *batch)
    fn(model, *batch)
    held = [p.data for p in model.parameters()]  # no new tensor takes their place
    model.to(torch.float32).to(torch.bfloat16)
    del held
    before = profiling.counters()
    got = [fn(model, *batch) for _ in range(2)]
    assert delta(before, REPLAYS, EAGER) == [1, 1]
    want = op_by_op(monkeypatch, fn, model, *batch)
    assert all(same(g, want) for g in got)


@pytest.mark.cuda
def test_a_moonlight_cascade_replays_nothing(cuda):
    cfg = MOON
    model = init_ee_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    model = model.to(cuda, torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(1, cfg.backbone.vocab_size, (4, 64), generator=g).to(cuda)
    mask = (torch.arange(64)[None] < torch.tensor([64, 20, 33, 7])[:, None]).to(cuda, torch.int32)
    fn = make_cascade_forward(cfg, (4, 2, 2), 0.9)
    before = profiling.counters()
    for _ in range(3):
        fn(model, ids, None, None, mask)
    assert delta(before, REPLAYS, EAGER) == [0, 3]


@pytest.mark.cuda
def test_pipeline_replays_with_the_same_answers_and_tallies(cuda, monkeypatch):
    """Three chunks of 16 through ``Pipeline``: the answers and every
    chunk's LayerNorm rows and launches equal those of the same pipeline
    run op by op."""
    model = tiny_model(cuda, torch.bfloat16)
    batch = [x.numpy() for x in features(48, seed=9)]
    feats = dict(zip(("input_ids", "bbox", "pixel_values", "attention_mask"), batch))
    thr = thresholds(model, on_card(features(16, seed=9), cuda))
    pipe = Pipeline(model, CFG, id2label={i: str(i) for i in range(4)}, threshold=thr,
                    tokenizer=object(), batch_size=16, exit_distribution={0: 0.3, 1: 0.3, 2: 0.4}, device=cuda)
    pipe.predict_features({k: v[:16] for k, v in feats.items()})  # captures
    rows = ("layer_norm.fused_rows", REPLAYS)

    def served(run):
        before = profiling.counters()
        answers = run()
        return answers, *delta(before, *rows, "launches.add_layer_norm")

    got, *got_rows, got_launches = served(lambda: pipe.predict_features(feats))
    want, *want_rows, want_launches = served(
        lambda: op_by_op(monkeypatch, pipe.predict_features, feats))
    assert got == want
    assert got_rows == [want_rows[0], 3] and want_rows[1] == 0
    assert got_launches == want_launches > 0
