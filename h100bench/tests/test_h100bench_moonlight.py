"""Early-exit Moonlight's cell at a tiny size on the CPU: the configuration,
traffic, limits and readers added as files and run through ``run.run_cell``
with no code edited, the check ``correct``, every ``moon.*`` reader's value,
and the two roofline readers on a synthetic trace."""

from __future__ import annotations

import shutil

import pytest

from h100bench import flops, moonlight, run, spans, tracing
from h100bench.tests import tiny

CELL = "moonlight-serve-b32"
TINY_MOON = dict(name="tiny-moon", vocab_size=512, hidden_size=64, intermediate_size=128,
                 moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
                 num_key_value_heads=4, n_routed_experts=8, n_shared_experts=1,
                 num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                 v_head_dim=16, max_position_embeddings=256, num_labels=4, exits=[1, 2],
                 serve_dtype="float32")
MOON_METRICS = ["moon.mfu_pct", "moon.experts_ms_per_batch", "moon.expert_gemm_roofline_pct",
                "moon.attn_roofline_pct", "moon.launches_per_batch", "moon.device_idle_pct",
                "moon.stage_host_ms_per_batch"]


def tiny_moon_config() -> dict:
    cfg = tiny.read(tiny.HERE / "configs" / "moonlight-16b-a3b.json")
    cfg.update(TINY_MOON)
    return cfg


def make(tmp) -> dict:
    """The tiny cell's files under ``tmp`` and its BENCHMARK object, built
    from the real cell's entries."""
    tiny.write(tmp / "configs" / "tiny-moon.json", tiny_moon_config())
    mix = tiny.read(tiny.HERE / "traffic" / "serve-lm-b32.json")
    mix.update(pool=32, lengths=[8, 48], seq_len=48, batch=8, calibration_docs=32,
               reference_block=8, check_calls=2, trace_units=2, warmup_calls=1)
    tiny.write(tmp / "traffic" / "tiny-moon-serve.json", mix)
    (tmp / "limits").mkdir(parents=True, exist_ok=True)
    shutil.copy(tiny.HERE / "limits" / f"{CELL}.json", tmp / "limits" / "tiny-moon-serve.json")
    shutil.copytree(tiny.HERE / "metrics", tmp / "metrics")
    real = tiny.read(tiny.ROOT / "BENCHMARK.json")

    def listed(m):
        return dict(m, workloads=["tiny-moon-serve"]) if CELL in m.get("workloads", [CELL]) \
            else None

    return {"configs": [{"name": "tiny-moon"}],
            "workloads": [dict(name="tiny-moon-serve", config="tiny-moon",
                               traffic="tiny-moon-serve", chips=1, why="a CPU test")],
            "end_to_end": [x for x in map(listed, real["end_to_end"]) if x],
            "per_layer": [x for x in map(listed, real["per_layer"]) if x]}


def test_the_real_cell_lists_every_moon_metric():
    real = tiny.read(tiny.ROOT / "BENCHMARK.json")
    e2e, per_layer = run.cell_metrics(real, CELL)
    assert {m["name"] for m in per_layer} == set(MOON_METRICS)
    assert {m["name"] for m in e2e} == {"docs_per_s", "batch_p95_ms", "peak_mem_mib", "setup_s"}
    cfg = tiny.read(tiny.HERE / "configs" / "moonlight-16b-a3b.json")
    assert cfg["reduced"] == [] and cfg["vocab_size"] == 163840 and cfg["n_routed_experts"] == 64


@pytest.mark.parametrize("trace,passes", [(False, 1), (True, 1), (False, 3)],
                         ids=["window", "traced", "mlp_passes"])
def test_an_added_moonlight_cell_runs_with_no_code_edited(tmp_path, monkeypatch, trace, passes):
    from multi_modal_early_exit_tpu_torch.models.moonlight import modeling

    if passes > 1:
        # a batch's real tokens (8 rows of 8-48) in several MLP passes: the
        # check's replay gathers each layer's choices from all of them
        monkeypatch.setattr(modeling, "MLP_TOKENS", 50)
    bench = make(tmp_path)
    out = run.run_cell(bench, "tiny-moon-serve", 2 ** 31 + 7, 1.0, trace, "cpu", 0.0, tmp_path)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"exit_err", "label_gap", "route_margin", "capacity_mismatch"}
    assert out["attempted"] >= 1 and out["failed"] == 0
    got = {k: v["value"] for k, v in out["metrics"].items()}
    if not trace:
        # a p95 needs two requests, which a loaded CPU may not serve in 1 s
        assert {"docs_per_s", "setup_s"} <= set(got)
        assert ("batch_p95_ms" in got) == (out["attempted"] >= 2)
        return
    # no card: no kernel ran, so the rooflines have no time to read
    assert set(got) == set(MOON_METRICS) - {"moon.expert_gemm_roofline_pct",
                                            "moon.attn_roofline_pct"}
    assert got["moon.mfu_pct"] > 0 and got["moon.stage_host_ms_per_batch"] > 0
    assert got["moon.launches_per_batch"] == 0 and got["moon.device_idle_pct"] == 100.0
    assert got["moon.experts_ms_per_batch"] == 0.0


def synthetic_trace(span: str, kernel: str, us: float) -> tracing.Trace:
    """A slice with one ``span`` on thread 1 holding one CPU op and one
    launch of ``kernel`` that runs ``us`` microseconds."""
    events = [
        {"ph": "X", "name": tracing.SLICE, "ts": 0, "dur": 10_000, "cat": "user_annotation"},
        {"ph": "X", "name": span, "ts": 100, "dur": 50, "cat": "user_annotation", "tid": 1},
        {"ph": "X", "name": "aten::op", "ts": 110, "dur": 20, "cat": "cpu_op", "tid": 1},
        {"ph": "X", "name": "cudaLaunchKernel", "ts": 115, "dur": 5, "cat": "cuda_runtime",
         "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "name": kernel, "ts": 200, "dur": us, "cat": "kernel",
         "args": {"correlation": 7}},
        {"ph": "X", "name": "other_kernel", "ts": 500, "dur": 300, "cat": "kernel",
         "args": {"correlation": 8}},
    ]
    return tracing.Trace(events)


class FakeRun:
    def __init__(self, cfg, trace, units=1, calls=()):
        self.cfg, self.trace, self.units, self.attention_calls = cfg, trace, units, list(calls)
        self.mix = {"batch": 32}


def test_the_attention_roofline_reads_the_span_s_kernels():
    cfg = tiny.read(tiny.HERE / "configs" / "moonlight-16b-a3b.json")
    calls = [(32, 2048)]
    us = 2e6 * flops.bound_s(*moonlight.attn_cost(cfg, *calls[0]))
    trace = synthetic_trace("mla.attention", "cudnn_sdpa_kernel", us)
    assert moonlight.attn_roofline_pct(FakeRun(cfg, trace, calls=calls)) == pytest.approx(50.0)
    trace = synthetic_trace("other", "cudnn_sdpa_kernel", us)
    assert moonlight.attn_roofline_pct(FakeRun(cfg, trace, calls=calls)) is None


def test_the_expert_gemm_roofline_reads_the_counters(monkeypatch):
    cfg = tiny.read(tiny.HERE / "configs" / "moonlight-16b-a3b.json")
    pairs = 6 * 35_000 * moonlight.moe_layers(cfg)  # a batch's pairs, every expert layer
    monkeypatch.setattr(spans, "counters", lambda: {"moe.routed_pairs": 3 * pairs,
                                                    "serving.documents": 3 * 32})
    bound = moonlight.moe_layers(cfg) * flops.bound_s(*moonlight.expert_gemm_cost(cfg, 6 * 35_000))
    trace = synthetic_trace("moe.experts", "cutlass_grouped_gemm_kernel", 4 * bound * 1e6)
    assert moonlight.expert_gemm_roofline_pct(FakeRun(cfg, trace)) == pytest.approx(25.0)
    trace = synthetic_trace("moe.experts", "elementwise_kernel", 4 * bound * 1e6)
    assert moonlight.expert_gemm_roofline_pct(FakeRun(cfg, trace)) is None
