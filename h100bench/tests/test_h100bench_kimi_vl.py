"""Early-exit Kimi-VL's cell at a tiny size on the CPU: the configuration,
traffic, limits and readers added as files and run through ``run.run_cell``
with no code edited, traced and untraced, the check ``correct``; the check
catching an altered answer and a zeroed image feature; the vision
attention's roofline reader on a synthetic trace."""

from __future__ import annotations

import shutil

import pytest

from h100bench import flops, kimi_vl, run
from h100bench.tests import tiny
from h100bench.tests.test_h100bench_moonlight import TINY_MOON, FakeRun, synthetic_trace

CELL = "kimivl-serve-b16"
TINY_VISION = dict(patch_size=2, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=64, init_pos_emb_height=4, init_pos_emb_width=4)
VL_METRICS = ["vl.mfu_pct", "vl.vision_ms_per_batch", "vl.vit_attn_roofline_pct"]


def tiny_vl_config() -> dict:
    cfg = tiny.read(tiny.HERE / "configs" / "kimi-vl-a3b-instruct.json")
    cfg.update(TINY_MOON, name="tiny-vl", media_placeholder_token_id=500)
    cfg["vision_config"] = dict(cfg["vision_config"], **TINY_VISION)
    return cfg


def make(tmp) -> dict:
    """The tiny cell's files under ``tmp`` and its BENCHMARK object, built
    from the real cell's entries."""
    tiny.write(tmp / "configs" / "tiny-vl.json", tiny_vl_config())
    mix = tiny.read(tiny.HERE / "traffic" / "serve-vlm-b16.json")
    # 4 x 4 to 6 x 6 patch grids: the position table as it is and interpolated
    mix.update(pool=32, patches=[16, 36], max_patches=36, prompt_tokens=6, seq_len=16, batch=8,
               calibration_docs=32, reference_block=8, check_calls=2, trace_units=2,
               warmup_calls=1)
    tiny.write(tmp / "traffic" / "tiny-vl-serve.json", mix)
    (tmp / "limits").mkdir(parents=True, exist_ok=True)
    shutil.copy(tiny.HERE / "limits" / f"{CELL}.json", tmp / "limits" / "tiny-vl-serve.json")
    shutil.copytree(tiny.HERE / "metrics", tmp / "metrics")
    real = tiny.read(tiny.ROOT / "BENCHMARK.json")

    def listed(m):
        return dict(m, workloads=["tiny-vl-serve"]) if CELL in m.get("workloads", [CELL]) \
            else None

    return {"configs": [{"name": "tiny-vl"}],
            "workloads": [dict(name="tiny-vl-serve", config="tiny-vl", traffic="tiny-vl-serve",
                               chips=1, why="a CPU test")],
            "end_to_end": [x for x in map(listed, real["end_to_end"]) if x],
            "per_layer": [x for x in map(listed, real["per_layer"]) if x]}


def test_the_real_cell_lists_every_vl_metric():
    real = tiny.read(tiny.ROOT / "BENCHMARK.json")
    e2e, per_layer = run.cell_metrics(real, CELL)
    assert {m["name"] for m in per_layer} == set(VL_METRICS)
    assert {m["name"] for m in e2e} == {"docs_per_s", "batch_p95_ms", "peak_mem_mib", "setup_s"}
    cell = {w["name"]: w for w in real["workloads"]}[CELL]
    assert cell["chips"] == 1 and cell["traffic"] == "serve-vlm-b16"
    cfg = tiny.read(tiny.HERE / "configs" / "kimi-vl-a3b-instruct.json")
    assert cfg["reduced"] == [] and cfg["rope_theta"] == 800000 and cfg["n_routed_experts"] == 64
    assert cfg["vision_config"]["hidden_size"] == 1152


def run_tiny(tmp_path, trace=False):
    return run.run_cell(make(tmp_path), "tiny-vl-serve", 2 ** 31 + 11, 1.0, trace, "cpu", 0.0,
                        tmp_path)


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
def test_an_added_kimi_vl_cell_runs_with_no_code_edited(tmp_path, trace):
    out = run_tiny(tmp_path, trace)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"exit_err", "label_gap", "route_margin", "capacity_mismatch",
                                  "vision_err"}
    assert out["attempted"] >= 1 and out["failed"] == 0
    got = {k: v["value"] for k, v in out["metrics"].items()}
    if not trace:
        assert {"docs_per_s", "setup_s"} <= set(got)
        assert ("batch_p95_ms" in got) == (out["attempted"] >= 2)
        return
    # no card: no kernel ran, so the roofline has no time to read
    assert set(got) == set(VL_METRICS) - {"vl.vit_attn_roofline_pct"}
    assert got["vl.mfu_pct"] > 0 and got["vl.vision_ms_per_batch"] == 0.0


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


def test_a_zeroed_image_feature_is_caught(tmp_path, monkeypatch):
    from multi_modal_early_exit_tpu_torch.models.kimi_vl import modeling

    real = modeling.vision_apply
    monkeypatch.setattr(modeling, "vision_apply",
                        lambda *args: real(*args) * 0.0)
    out = run_tiny(tmp_path)
    assert not out["correct"]
    assert out["checks"]["vision_err"]["value"] == pytest.approx(1.0)


def test_the_vision_attention_roofline_reads_the_counters():
    cfg = tiny.read(tiny.HERE / "configs" / "kimi-vl-a3b-instruct.json")
    counted = [(35_000, 16 * 2300 ** 2)]  # a batch's patches and patch pairs
    us = 4e6 * flops.bound_s(*kimi_vl.vit_attn_cost(cfg, *counted[0]))
    run_ = FakeRun(cfg, synthetic_trace("vit.attention", "flash_fwd_kernel", us), calls=counted)
    assert kimi_vl.vit_attn_roofline_pct(run_) == pytest.approx(25.0)
    # the bound is the operations' at a page's length: 4 d operations a pair
    assert kimi_vl.vit_attn_cost(cfg, *counted[0])[1] == 27 * 4.0 * 16 * 2300 ** 2 * 1152
    run_ = FakeRun(cfg, synthetic_trace("other", "flash_fwd_kernel", us), calls=counted)
    assert kimi_vl.vit_attn_roofline_pct(run_) is None
    assert kimi_vl.vit_attn_roofline_pct(FakeRun(cfg, run_.trace)) is None
