"""The readers of the program's waits on hand-made Chrome traces: an idle
gap that overlaps a ``sync.*`` span counts whole and once, the stages'
issue time is their host time less the waits nested in it, the packing's
idle time is the gaps intersected with ``vit.pack``, and a trace or a
program without the spans reads None, not 0."""

from __future__ import annotations

import pytest

from h100bench import run as harness
from h100bench import spans, syncs, tracing
from h100bench.tests import tiny
from h100bench.tests.test_h100bench_tracing import ev


class Run:
    def __init__(self, events, units=2):
        self.trace = tracing.Trace(events) if events is not None else None
        self.units, self.cfg = units, {}


def busy(*intervals):
    return [ev("k", "kernel", a, b - a, tid=7, corr=i) for i, (a, b) in enumerate(intervals)]


# busy 0-1, 2.5-4, 9-23, 27-52, 56-72: idle 1-2.5, 4-9, 23-27, 52-56, 72-100
SERVED = [
    ev(tracing.SLICE, "user_annotation", 0, 100),
    ev("cascade.embed", "user_annotation", 0, 20),
    ev("sync.grids", "user_annotation", 1, 1),
    ev("vit.pack", "user_annotation", 2, 8),
    ev("sync.pages", "user_annotation", 5, 1),         # two waits in one gap, 4-9
    ev("sync.pages", "user_annotation", 7, 1),
    ev("cascade.stage0", "user_annotation", 20, 30),
    ev("sync.real_tokens", "user_annotation", 22, 3),  # the gap 23-27 starts inside it
    ev("cascade.stage1", "user_annotation", 50, 20),
    ev("sync.real_tokens", "user_annotation", 52, 2),
    ev("pipeline.answers", "user_annotation", 70, 20),
    ev("sync.answers", "user_annotation", 71, 4),      # two waits in one gap, 72-100
    ev("sync.answers", "user_annotation", 75, 5),
] + busy((0, 1), (2.5, 4), (9, 23), (27, 52), (56, 72))
METRICS = [f"{p}.{m}" for p in ("moon", "vl", "klin")
           for m in ("syncs_per_batch", "sync_idle_ms_per_batch", "stage_issue_ms_per_batch")]
METRICS.append("vl.pack_idle_ms_per_batch")


def read(name, run):
    return harness.load_module(tiny.HERE / "metrics" / f"{name}.py").read(run)


def test_the_waits_count_a_batch():
    run = Run(SERVED)
    assert syncs.syncs_per_unit(run) == 7 / 2
    for p in ("moon", "vl", "klin"):
        assert read(f"{p}.syncs_per_batch", run) == 7 / 2


def test_a_gap_that_a_wait_overlaps_counts_whole_and_once():
    run = Run(SERVED)
    # 1-2.5 whole, 4-9 once for two waits, 23-27 whole though its wait ends
    # at 25, 52-56 whole, 72-100 once for two waits
    want = (1.5 + 5 + 4 + 4 + 28) * 1e-3 / 2
    assert syncs.sync_idle_ms_per_unit(run) == pytest.approx(want)
    # against the intersection, which counts only the waits' own part
    assert spans.idle_ms_per_unit(run, syncs.SYNC) == pytest.approx((1 + 2 + 2 + 2 + 8) * 1e-3 / 2)
    # a gap that only touches a wait's end does not count
    touching = Run([ev(tracing.SLICE, "user_annotation", 0, 10),
                    ev("sync.answers", "user_annotation", 2, 3)] + busy((0, 5), (8, 10)))
    assert syncs.sync_idle_ms_per_unit(touching) == 0.0
    for p in ("moon", "vl", "klin"):
        assert read(f"{p}.sync_idle_ms_per_batch", run) == pytest.approx(want)


def test_the_stages_issue_time_is_their_host_time_less_their_waits():
    run = Run(SERVED)
    host = spans.host_ms_per_unit(run, spans.CASCADE)
    assert host == pytest.approx(70e-3 / 2)
    # the waits inside the stages: 1 + 2 + 3 + 2 us; the answers' lie outside
    inside = spans.overlap_s(spans.spans(run.trace, spans.CASCADE),
                             spans.spans(run.trace, syncs.SYNC))
    assert inside == pytest.approx(8e-6)
    assert syncs.stage_issue_ms_per_unit(run) == pytest.approx((70 - 8) * 1e-3 / 2)
    assert syncs.stage_issue_ms_per_unit(run) + 1e3 * inside / run.units == pytest.approx(host)
    for p in ("moon", "vl", "klin"):
        assert read(f"{p}.stage_issue_ms_per_batch", run) == pytest.approx(31e-3)


def test_the_packings_idle_time_is_the_gaps_inside_it():
    # vit.pack 2-10 holds the idle 2-2.5 and 4-9
    assert read("vl.pack_idle_ms_per_batch", Run(SERVED)) == pytest.approx(5.5e-3 / 2)


def test_a_trace_without_the_spans_reads_none():
    older = [e for e in SERVED if not e["name"].startswith(("sync.", "vit.pack"))]
    assert len(older) == len(SERVED) - 8
    for run in (Run(older), Run(None), Run(SERVED, units=0)):
        assert syncs.waits(run) is None
        for name in METRICS:
            assert read(name, run) is None, name
    # waits but no cascade: no stage to issue
    alone = [e for e in SERVED if not e["name"].startswith("cascade.")]
    assert syncs.stage_issue_ms_per_unit(Run(alone)) is None
    assert syncs.syncs_per_unit(Run(alone)) == 7 / 2
