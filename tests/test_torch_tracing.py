"""PyTorch port, tracing: the spans at the port's layer boundaries appear
in a profiler's trace in the order the work runs and cost nothing without
one, and the serving counters count what the cascade ran and wanted."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig
from multi_modal_early_exit_tpu_torch.data import datasets as tds
from multi_modal_early_exit_tpu_torch.evaluation import pipeline as tpipe
from multi_modal_early_exit_tpu_torch.models.ee.model import ee_forward, init_ee_params
from multi_modal_early_exit_tpu_torch.models.layoutlmv2 import modeling as v2
from multi_modal_early_exit_tpu_torch.models.layoutlmv2.config import LayoutLMv2Config
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import (
    EEModelConfig,
    LayoutLMv3Config,
)
from multi_modal_early_exit_tpu_torch.serving import Pipeline
from multi_modal_early_exit_tpu_torch.utils import profiling

torch.set_num_threads(2)

CFG = EEModelConfig(backbone=LayoutLMv3Config.tiny(), exit=ExitConfig(exits=("text_avg", 1)))
N_EMB = 1  # text_avg; the encoder stages are layers [0, 1) and [1, 2)
NEVER = 2.0  # above every max-softmax criterion: no exit fires
VOCAB = 50265  # load_tokenizer()'s vocabulary, which the tiny split's ids span


def features(n, seed=0, seq=32):
    rng = np.random.default_rng(seed)
    return {
        "input_ids": rng.integers(3, CFG.backbone.vocab_size, (n, seq)).astype(np.int64),
        "bbox": np.sort(rng.integers(0, 1000, (n, seq, 4)), -1).astype(np.int64),
        "pixel_values": rng.standard_normal((n, 3, 32, 32)).astype(np.float32),
        "attention_mask": np.ones((n, seq), np.int64),
    }


@pytest.fixture(scope="module")
def model():
    return init_ee_params(CFG, torch.Generator().manual_seed(4), device="cpu")


def pipeline(model, **kwargs):
    return Pipeline(model, CFG, id2label={i: str(i) for i in range(4)}, device="cpu", **kwargs)


def spans(prof, tmp_path, names=None):
    """(name, start, end) of the trace's ``user_annotation`` events, in
    start order (``names``: only those whose name passes it)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return sorted((s for s in out if names is None or names(s[0])), key=lambda s: s[1])


def program_span(name):
    return name.split(".")[0] in ("pipeline", "cascade", "get_logits", "v2")


def collapse(names):
    """Runs of one name as one entry."""
    return [n for i, n in enumerate(names) if i == 0 or names[i - 1] != n]


def test_span_enters_no_record_function_without_a_profiler(model, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(profiling, "record_function", refuse)
    with profiling.span("x") as inside:
        assert inside is None
    with profiling.sync("x") as inside:
        assert inside is None
    # one shared no-op, spans and waits alike
    assert profiling.span("a") is profiling.span("b") is profiling.sync("c")
    # the whole serving path runs with every span off, its waits' among them
    assert len(pipeline(model, batch_size=8).predict_features(features(8))) == 8


def test_predict_features_spans_in_order(model, tmp_path):
    pipe = pipeline(model, batch_size=8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.predict_features(features(8))
    found = spans(prof, tmp_path, program_span)
    # the host copy and the chunk's row gather, then each cascade stage
    assert collapse([s[0] for s in found]) == [
        "pipeline.copy_in", "cascade.embed", "cascade.stage0", "cascade.stage1",
        "pipeline.answers"]
    for name, a, b in found:
        if name.startswith("cascade."):
            assert not any(o != (name, a, b) and o[1] <= a and b <= o[2] for o in found), name
    # spans follow one another: none overlaps the next
    assert all(x[2] <= y[1] for x, y in zip(found, found[1:]))


def test_get_logits_and_the_v2_tower_spans(tmp_path):
    cfg = LayoutLMv2Config.tiny().replace(vocab_size=VOCAB)
    net = v2.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    data = tds.build_dataset("synthetic_rvl_cdip_tiny", "test")
    n_batches = -(-len(data) // 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        store, _, _ = tpipe.get_logits(net, cfg, data, {}, batch_size=3, use_cache=False,
                                       device="cpu")
    assert store.shape == (1, len(data), 4)
    found = spans(prof, tmp_path, program_span)
    names = [s[0] for s in found]
    assert names.count("get_logits.forward") == names.count("get_logits.store") == n_batches
    assert names.count("v2.tower") == n_batches
    # one fetch a batch, and the last one finds the end of the split
    assert names.count("get_logits.data") == n_batches + 1
    loop = [n for n in names if n.startswith("get_logits.")]
    assert loop == ["get_logits.data", "get_logits.forward", "get_logits.store"] * n_batches + [
        "get_logits.data"]
    forwards = [s for s in found if s[0] == "get_logits.forward"]
    for _, a, b in (s for s in found if s[0] == "v2.tower"):
        assert any(f[1] <= a and b <= f[2] for f in forwards)


def test_counters_count_and_reset():
    profiling.counters(reset=True)
    profiling.count("x")
    profiling.count("x", 4)
    profiling.count("y", 2)
    assert profiling.counters() == {"x": 5, "y": 2}
    assert profiling.counters(reset=True) == {"x": 5, "y": 2}
    assert profiling.counters() == {}


def stage_counts(counts, n_stages=2):
    return {key: [counts.get(f"cascade.stage{i}.{key}", 0) for i in range(n_stages)]
            for key in ("rows", "rows_wanted", "rows_refused")}


def test_rows_wanted_under_the_exact_policy(model):
    """Capacities equal to the batch: no row is forced, and a stage is
    wanted by the rows whose exit lies at or past its own exit."""
    batch = features(16, seed=1)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        crit = ee_forward(model, CFG, t["input_ids"], t["bbox"], t["pixel_values"],
                          t["attention_mask"]).exit_criteria
    thresholds = [float(crit[j].median()) for j in range(crit.shape[0] - 1)]
    pipe = pipeline(model, batch_size=16, threshold=thresholds)
    assert pipe.capacities == (16, 16)
    profiling.counters(reset=True)
    exits = np.array([a["exit"] for a in pipe.predict_features(batch)])
    assert len(set(exits.tolist())) == 3  # each of the three exits takes rows
    got = stage_counts(profiling.counters())
    assert got["rows_wanted"] == [int((exits >= N_EMB + i).sum()) for i in range(2)]
    assert got["rows_refused"] == [0, 0]
    assert got["rows"] == [16, 16]
    assert profiling.counters()["serving.documents"] == 16
    m = pipe.metrics()
    w = got["rows_wanted"]
    assert m["encoder_fill"] == pytest.approx((1 * w[0] + 1 * w[1]) / (1 * 16 + 1 * 16))


@pytest.mark.parametrize("batch, dist, caps, wanted, refused", [
    # stage 1 holds 8 of the 16 rows that go on
    (16, {0: 0.0, 1: 0.9, 2: 0.1}, (16, 8), [16, 16], [0, 8]),
    # stage 0 refuses 16 rows, stage 1 then 8 of the 16 it ran
    (32, {0: 0.8, 1: 0.15, 2: 0.05}, (16, 8), [32, 16], [16, 8]),
])
def test_forced_rows_count_at_the_stage_that_refused_them(model, batch, dist, caps, wanted,
                                                          refused):
    """No exit fires, so every row wants every stage it reaches; a row a
    stage refuses wanted that stage and no later one."""
    pipe = pipeline(model, batch_size=batch, exit_distribution=dist, threshold=NEVER)
    assert pipe.capacities == caps
    profiling.counters(reset=True)
    answers = pipe.predict_features(features(batch, seed=2))
    forced = [a for a in answers if a["capacity_exited"]]
    assert len(forced) == sum(refused)
    # a row refused by stage s took the exit before it (the embedding exit
    # before stage 0)
    by_exit = {N_EMB - 1: refused[0], N_EMB: refused[1]}
    assert {e: sum(a["exit"] == e for a in forced) for e in by_exit} == by_exit
    counts = profiling.counters()
    got = stage_counts(counts)
    assert got == {"rows": list(caps), "rows_wanted": wanted, "rows_refused": refused}
    assert counts["serving.capacity_exited"] == sum(refused)
    # every row a stage ran was a real row still running
    assert pipe.metrics()["encoder_fill"] == pytest.approx(1.0)


def test_metrics_keeps_its_keys_and_values(model):
    """``metrics()`` keeps its three keys, from the instance's own totals
    (a second pipeline's work does not count), and gains ``encoder_fill``;
    a short request counts its real rows only."""
    pipe = pipeline(model, batch_size=16, exit_distribution={0: 0.0, 1: 0.9, 2: 0.1},
                    threshold=NEVER, capacity_tail=0.99)
    assert pipe.metrics() == {"documents_served": 0.0, "capacity_exit_rate": 0.0,
                              "capacity_tail": 0.99, "encoder_fill": 0.0}
    answers = pipe.predict_features(features(19, seed=3))  # one full chunk, one padded
    pipeline(model, batch_size=8).predict_features(features(8))
    forced = sum(a["capacity_exited"] for a in answers)
    m = pipe.metrics()
    assert list(m) == ["documents_served", "capacity_exit_rate", "capacity_tail", "encoder_fill"]
    assert m["documents_served"] == 19.0
    assert m["capacity_exit_rate"] == forced / 19
    assert m["capacity_tail"] == 0.99
    assert 0.0 < m["encoder_fill"] <= 1.0
