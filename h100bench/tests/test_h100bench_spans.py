"""The readers of the program's spans and counters on hand-made Chrome
traces: idle time inside a span is the idle gaps' intersection with it,
spans that overlap count once, a kernel counts under a span by its launch
call's time on the span's thread, and a trace or a program without them
reads None, not 0."""

from __future__ import annotations

import sys
import types

import pytest

from h100bench import run as harness
from h100bench import spans, tracing
from h100bench.tests import tiny
from h100bench.tests.test_h100bench_tracing import ev


class Run:
    def __init__(self, events, units=2, cfg=None):
        self.trace = tracing.Trace(events) if events is not None else None
        self.units, self.cfg = units, cfg or {}


SERVE = [
    ev(tracing.SLICE, "user_annotation", 0, 100),
    ev("cascade.embed", "user_annotation", 0, 10),
    ev("cascade.stage0", "user_annotation", 10, 30),
    ev("cascade.stage0", "user_annotation", 35, 10),    # overlaps the one before
    ev("cascade.stage1", "user_annotation", 40, 10),
    ev("pipeline.answers", "user_annotation", 50, 40),
    ev("aten::item", "cpu_op", 55, 30),
    ev("fwd_kernel", "kernel", 5, 25, tid=7, corr=1),   # 5-30
    ev("Memcpy DtoH", "gpu_memcpy", 60, 10, tid=7),     # 60-70
]


def test_host_time_inside_the_cascade_spans_counts_overlaps_once():
    run = Run(SERVE)
    # the union 0-50 over 2 batches, in ms
    assert spans.host_ms_per_unit(run, spans.CASCADE) == pytest.approx(50e-3 / 2)
    assert spans.host_ms_per_unit(run, r"^cascade\.stage0$") == pytest.approx(35e-3 / 2)


def test_idle_time_inside_a_span_is_the_gaps_intersected_with_it():
    run = Run(SERVE)
    # idle 0-5, 30-60, 70-100; answers 50-90 holds 50-60 and 70-90
    assert spans.idle_ms_per_unit(run, r"^pipeline\.answers$") == pytest.approx(30e-3 / 2)
    # the cascade's spans (0-50) hold 0-5 and 30-50
    assert spans.idle_ms_per_unit(run, spans.CASCADE) == pytest.approx(25e-3 / 2)
    assert spans.overlap_s([(0, 4), (2, 6), (10, 12)], [(3, 11)]) == pytest.approx(4)


def test_a_trace_without_the_spans_reads_none():
    run = Run([ev(tracing.SLICE, "user_annotation", 0, 100),
               ev("aten::add", "cpu_op", 10, 5),
               ev("add_kernel", "kernel", 20, 5, tid=7, corr=1)])
    assert spans.host_ms_per_unit(run, spans.CASCADE) is None
    assert spans.idle_ms_per_unit(run, r"^pipeline\.answers$") is None
    assert spans.device_s_launched_in(run.trace, r"^v2\.tower$") is None
    assert spans.idle_ms_per_unit(Run(None), r"^get_logits\.data$") is None
    names = ("serve.stage_host_ms_per_batch", "serve.answers_idle_ms_per_batch",
             "harvest.data_idle_ms_per_batch", "v2.tower_all_ms_per_batch")
    for name in names:
        reader = harness.load_module(tiny.HERE / "metrics" / f"{name}.py")
        assert reader.read(run) is None, name


TOWER = [
    ev(tracing.SLICE, "user_annotation", 0, 100),
    ev("v2.tower", "user_annotation", 10, 20),                      # 10-30, thread 1
    ev("aten::cudnn_convolution", "cpu_op", 11, 18),
    ev("cudaLaunchKernel", "cuda_runtime", 12, 1, corr=1),          # in the span
    ev("cudaMemcpyAsync", "cuda_runtime", 25, 1, corr=4),           # in the span
    ev("cudaLaunchKernel", "cuda_runtime", 20, 1, tid=2, corr=3),   # another thread
    ev("aten::add", "cpu_op", 34, 4),
    ev("cudaLaunchKernel", "cuda_runtime", 35, 1, corr=2),          # after the span
    ev("implicit_convolve_sgemm", "kernel", 40, 20, tid=7, corr=1),  # runs after the span
    ev("Memcpy DtoD", "gpu_memcpy", 62, 3, tid=7, corr=4),
    ev("add_kernel", "kernel", 66, 2, tid=7, corr=2),
    ev("copy_kernel", "kernel", 70, 5, tid=8, corr=3),
]


def test_a_kernel_counts_under_the_tower_by_its_launch_calls_time():
    run = Run(TOWER, units=1)
    # the convolution and the copy, launched inside the span on its thread
    assert spans.device_s_launched_in(run.trace, r"^v2\.tower$") == pytest.approx(23e-6)
    reader = harness.load_module(tiny.HERE / "metrics" / "v2.tower_all_ms_per_batch.py")
    assert reader.read(run) == pytest.approx(23e-3)


def test_encoder_fill_reads_the_programs_counters(monkeypatch):
    cfg = {"exits": ["text_avg", "vision_avg", 7], "num_hidden_layers": 12}
    counts = {"cascade.stage0.rows": 64, "cascade.stage0.rows_wanted": 60,
              "cascade.stage0.rows_refused": 0, "cascade.stage1.rows": 16,
              "cascade.stage1.rows_wanted": 18, "cascade.stage1.rows_refused": 3}
    run = Run(SERVE, cfg=cfg)
    monkeypatch.setitem(sys.modules, spans.PROFILING, types.SimpleNamespace(counters=lambda: counts))
    want = 100.0 * (7 * 60 + 5 * 15) / (7 * 64 + 5 * 16)
    assert spans.encoder_fill_pct(run) == pytest.approx(want)
    # a dense model runs no cascade
    assert spans.encoder_fill_pct(Run(SERVE, cfg={"num_hidden_layers": 12})) is None
    # a program without counters: an older module, or none loaded
    monkeypatch.setitem(sys.modules, spans.PROFILING, types.SimpleNamespace())
    assert spans.encoder_fill_pct(run) is None
    monkeypatch.delitem(sys.modules, spans.PROFILING)
    assert spans.encoder_fill_pct(run) is None
    monkeypatch.setitem(sys.modules, spans.PROFILING, types.SimpleNamespace(counters=dict))
    assert spans.encoder_fill_pct(run) is None
