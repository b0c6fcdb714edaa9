"""Early-exit Kimi-Linear's cell at a tiny size on the CPU: the configuration
file against the published keys (the one cut listed in ``reduced``), the
traffic, limits and readers added as files and run through ``run.run_cell``
with no code edited, traced and untraced, the check ``correct`` and
catching an altered answer and a wrong KDA core; ``kda_cost`` and the FLOP
counts; the KDA roofline and mixer readers on a synthetic trace; the
entry's pool at the stated lengths."""

from __future__ import annotations

import shutil

import numpy as np
import pytest

from h100bench import flops, kimi_linear, run
from h100bench.entries import serve_lm
from h100bench.tests import tiny
from h100bench.tests.test_h100bench_moonlight import FakeRun, synthetic_trace

CELL = "kimilinear-serve-b4"
CONFIG = tiny.HERE / "configs" / "kimi-linear-48b-a3b-instruct.json"
KLIN_METRICS = ["klin.mfu_pct", "klin.kda_ms_per_batch", "klin.kda_roofline_pct"]
# the published config.json's keys that say something of the model's shape
PUBLISHED = {
    "first_k_dense_replace": 1, "head_dim": 72, "hidden_act": "silu", "hidden_size": 2304,
    "intermediate_size": 9216, "kv_lora_rank": 512,
    "linear_attn_config": {"full_attn_layers": [4, 8, 12, 16, 20, 24, 27], "head_dim": 128,
                           "kda_layers": [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19,
                                          21, 22, 23, 25, 26],
                           "num_heads": 32, "short_conv_kernel_size": 4},
    "mla_use_nope": True, "model_max_length": 1048576, "model_type": "kimi_linear",
    "moe_intermediate_size": 1024, "moe_layer_freq": 1, "moe_renormalize": True,
    "moe_router_activation_func": "sigmoid", "num_attention_heads": 32, "num_expert_group": 1,
    "num_experts": 256, "num_experts_per_token": 8, "num_hidden_layers": 27,
    "num_key_value_heads": 32, "num_nextn_predict_layers": 0, "num_shared_experts": 1,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-05,
    "rope_scaling": None, "rope_theta": 10000, "routed_scaling_factor": 2.446,
    "tie_word_embeddings": False, "topk_group": 1, "use_grouped_topk": True, "v_head_dim": 128,
    "vocab_size": 163840,
}
TINY_KLIN = dict(name="tiny-klin", vocab_size=512, hidden_size=64, intermediate_size=128,
                 moe_intermediate_size=32, num_hidden_layers=5, num_attention_heads=4,
                 num_key_value_heads=4, num_experts=4, published_num_experts=8,
                 num_experts_per_token=2, kv_lora_rank=32, qk_nope_head_dim=16,
                 qk_rope_head_dim=8, v_head_dim=16, num_labels=4, exits=[2, 4],
                 linear_attn_config={"full_attn_layers": [4], "head_dim": 16,
                                     "kda_layers": [1, 2, 3, 5], "num_heads": 2,
                                     "short_conv_kernel_size": 4},
                 kda_chunk_size=16, serve_dtype="float32")


def tiny_config() -> dict:
    cfg = tiny.read(CONFIG)
    cfg.update(TINY_KLIN)
    return cfg


def make(tmp) -> dict:
    """The tiny cell's files under ``tmp`` and its BENCHMARK object, built
    from the real cell's entries: rows of 20-60 tokens padded to 64, so
    chunks of 16 end inside and at the rows' ends."""
    tiny.write(tmp / "configs" / "tiny-klin.json", tiny_config())
    mix = tiny.read(tiny.HERE / "traffic" / "serve-long-b4.json")
    mix.update(pool=16, lengths=[20, 60], seq_len=64, calibration_docs=16, check_calls=2,
               trace_units=2, warmup_calls=1)
    tiny.write(tmp / "traffic" / "tiny-klin-serve.json", mix)
    (tmp / "limits").mkdir(parents=True, exist_ok=True)
    shutil.copy(tiny.HERE / "limits" / f"{CELL}.json", tmp / "limits" / "tiny-klin-serve.json")
    shutil.copytree(tiny.HERE / "metrics", tmp / "metrics")
    real = tiny.read(tiny.ROOT / "BENCHMARK.json")

    def listed(m):
        return dict(m, workloads=["tiny-klin-serve"]) if CELL in m.get("workloads", [CELL]) \
            else None

    return {"configs": [{"name": "tiny-klin"}],
            "workloads": [dict(name="tiny-klin-serve", config="tiny-klin",
                               traffic="tiny-klin-serve", chips=1, why="a CPU test")],
            "end_to_end": [x for x in map(listed, real["end_to_end"]) if x],
            "per_layer": [x for x in map(listed, real["per_layer"]) if x]}


def test_the_config_file_is_the_published_one_but_the_held_experts():
    cfg = tiny.read(CONFIG)
    assert cfg["reduced"] == ["num_experts"]
    changed = {k for k, v in PUBLISHED.items() if cfg.get(k, object()) != v}
    assert changed == set(cfg["reduced"])
    assert cfg["num_experts"] == 128 and cfg["published_num_experts"] == 256
    assert "2 H100s" in cfg["deployment"] and "0-127" in cfg["deployment"]
    real = tiny.read(tiny.ROOT / "BENCHMARK.json")
    entry = {c["name"]: c for c in real["configs"]}[cfg["name"]]
    assert entry["reduced"] == ["num_experts"] and entry["file"].endswith(CONFIG.name)
    bb = kimi_linear.port_config(cfg).backbone
    assert (bb.num_experts, bb.experts_held, bb.expert_offset) == (256, 128, 0)
    assert bb.kda_layers == tuple(PUBLISHED["linear_attn_config"]["kda_layers"])


def test_the_real_cell_lists_every_klin_metric():
    real = tiny.read(tiny.ROOT / "BENCHMARK.json")
    e2e, per_layer = run.cell_metrics(real, CELL)
    assert {m["name"] for m in per_layer} == set(KLIN_METRICS)
    assert {m["name"] for m in e2e} == {"docs_per_s", "batch_p95_ms", "peak_mem_mib", "setup_s"}
    cell = {w["name"]: w for w in real["workloads"]}[CELL]
    assert cell["chips"] == 1 and cell["traffic"] == "serve-long-b4"
    assert set(tiny.read(tiny.HERE / "limits" / f"{CELL}.json")) == {
        "exit_err", "label_gap", "route_margin", "capacity_mismatch", "kda_err"}


def run_tiny(tmp_path, trace=False):
    return run.run_cell(make(tmp_path), "tiny-klin-serve", 2 ** 31 + 13, 1.0, trace, "cpu", 0.0,
                        tmp_path)


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
def test_an_added_kimi_linear_cell_runs_with_no_code_edited(tmp_path, trace):
    out = run_tiny(tmp_path, trace)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"exit_err", "label_gap", "route_margin", "capacity_mismatch",
                                  "kda_err"}
    # both sides f32 on the CPU: the core's sums in another order
    assert out["checks"]["kda_err"]["value"] < 1e-4
    assert out["attempted"] >= 1 and out["failed"] == 0
    got = {k: v["value"] for k, v in out["metrics"].items()}
    if not trace:
        assert {"docs_per_s", "setup_s"} <= set(got)
        assert ("batch_p95_ms" in got) == (out["attempted"] >= 2)
        return
    # no card: no kernel ran, so the roofline has no time to read
    assert set(got) == set(KLIN_METRICS) - {"klin.kda_roofline_pct"}
    assert got["klin.mfu_pct"] > 0 and got["klin.kda_ms_per_batch"] == 0.0


def test_an_altered_answer_is_caught(tmp_path, monkeypatch):
    from multi_modal_early_exit_tpu_torch.serving import Pipeline

    real = Pipeline.predict_features

    def altered(self, batch):  # every label moved to the next class
        answers = real(self, batch)
        for a in answers:
            a["label_id"] = (a["label_id"] + 1) % 4
        return answers

    monkeypatch.setattr(Pipeline, "predict_features", altered)
    out = run_tiny(tmp_path)
    assert not out["correct"]
    assert out["checks"]["label_gap"]["value"] > out["checks"]["label_gap"]["limit"]


def test_a_wrong_kda_core_is_caught(tmp_path, monkeypatch):
    """A core that drops the last position of every chunk's update reads
    far past ``kda_err``'s limit."""
    from multi_modal_early_exit_tpu_torch.models.kimi_linear import modeling

    real = modeling.kda

    def wrong(q, k, v, g, beta, lengths, lengths_host, chunk):
        out = real(q, k, v, g, beta, lengths, lengths_host, chunk)
        return out * 1.1

    monkeypatch.setattr(modeling, "kda", wrong)
    out = run_tiny(tmp_path)
    assert not out["correct"]
    assert out["checks"]["kda_err"]["value"] > out["checks"]["kda_err"]["limit"]


def test_kda_cost_and_the_flop_counts():
    cfg = tiny.read(CONFIG)
    c, d, heads = 64, 128, 32
    per_chunk = 2 * c * (c + 1) * d + c ** 3 / 3 + 6 * c * d * d + 2 * c * c * d
    assert kimi_linear.kda_core_ops(cfg) == pytest.approx(per_chunk)
    n_bytes, ops = kimi_linear.kda_cost(cfg, 35_000)
    assert n_bytes == 35_000 * heads * d * 12
    assert ops == pytest.approx(35_000 / c * heads * per_chunk)
    # bytes bound it at the served size: about 0.5 ms a layer's 35,000 tokens
    assert flops.bound_s(n_bytes, ops) == pytest.approx(n_bytes / flops.PEAK_BYTES_PER_S)
    # the held share: 4 of 8 routed pairs a token, plus the shared expert and the router
    h, f = 2304, 1024
    moe_gap = kimi_linear.token_flops(cfg, 1) - kimi_linear.token_flops(cfg, 0)
    assert moe_gap == pytest.approx(2 * h * 256 + 4 * 6 * h * f + 6 * h * f - 6 * h * 9216)
    # an MLA layer (index 3) against a KDA layer: projections apart, the same MLP
    mla = 2 * h * (32 * 192 + 512 + 64) + 2 * 512 * 32 * 256 + 2 * 32 * 128 * h
    kda = (2 * h * 4 * 4096 + 4 * (h * 128 + 128 * 4096) + 2 * h * 32 + 2 * 3 * 4096 * 4
           + heads * per_chunk / c)
    assert kimi_linear.token_flops(cfg, 3) - kimi_linear.token_flops(cfg, 2) == \
        pytest.approx(mla - kda)
    # a document leaving at the first exit (layer 9) ran two MLA cores (layers 4, 8)
    one = kimi_linear.doc_flops_to_exit(cfg, 0, 5000)
    body = sum(kimi_linear.token_flops(cfg, i) for i in range(9)) * 5000
    core = 2 * 32 * 5000 * 5001 / 2 * (192 + 128)
    assert one == pytest.approx(body + 2 * core + 2 * h * h + 2 * h * 16)


def test_the_kda_readers_read_the_spans_and_the_counter():
    cfg = tiny.read(CONFIG)
    counted = [20 * 35_000, 20 * 30_000]  # two requests' kda.tokens
    need = sum(flops.bound_s(*kimi_linear.kda_cost(cfg, n)) for n in counted)
    trace = synthetic_trace("kda.core", "kda_state_kernel", 4e6 * need)
    assert kimi_linear.kda_roofline_pct(FakeRun(cfg, trace, units=2, calls=counted)) == \
        pytest.approx(25.0)
    assert kimi_linear.kda_roofline_pct(FakeRun(cfg, trace, units=2)) is None
    other = synthetic_trace("other", "kda_state_kernel", 4e6 * need)
    assert kimi_linear.kda_roofline_pct(FakeRun(cfg, other, units=2, calls=counted)) is None
    mixer = synthetic_trace("kda.mixer", "nvjet_gemm", 3000.0)
    assert kimi_linear.kda_ms_per_batch(FakeRun(cfg, mixer, units=2)) == pytest.approx(1.5)
    assert kimi_linear.kda_ms_per_batch(FakeRun(cfg, other, units=2)) is None


def test_the_pool_draws_the_stated_lengths():
    cfg = tiny.read(CONFIG)
    mix = tiny.read(tiny.HERE / "traffic" / "serve-long-b4.json")
    pool = serve_lm.make_pool(2 ** 31 + 5, cfg, mix)
    lengths = pool["attention_mask"].sum(axis=1)
    assert pool["input_ids"].shape == (128, 16384) and mix["batch"] == 4
    assert lengths.min() >= 4096 and lengths.max() <= 16384
    # log-uniform: the median near the geometric mean 8,192, the mean near 8,860
    assert 6500 < np.median(lengths) < 10000 and 7800 < lengths.mean() < 9900
    # right-padded: each row's mask is a run of ones from its first position
    assert (np.diff(pool["attention_mask"], axis=1) <= 0).all()
