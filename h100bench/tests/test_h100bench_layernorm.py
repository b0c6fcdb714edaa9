"""The reader of the LayerNorm counters: the share of rows the kernel
normalised, None for a program without the counters or with no call."""

from __future__ import annotations

import sys
import types

import pytest

from h100bench import run as harness
from h100bench import spans
from h100bench.tests import tiny

READER = harness.load_module(tiny.HERE / "metrics" / "serve.layernorm_fused_pct.py")


def _program(monkeypatch, counts):
    monkeypatch.setitem(sys.modules, spans.PROFILING,
                        types.SimpleNamespace(counters=lambda: dict(counts)))


@pytest.mark.parametrize("counts,want", [
    ({"layer_norm.fused_rows": 300, "layer_norm.composed_rows": 100}, 75.0),
    ({"layer_norm.fused_rows": 64, "serving.documents": 8}, 100.0),
    ({"layer_norm.composed_rows": 10}, 0.0),
])
def test_the_fused_share_of_the_rows(monkeypatch, counts, want):
    _program(monkeypatch, counts)
    assert READER.read(None) == pytest.approx(want)


def test_a_program_without_the_counters_reads_none(monkeypatch):
    _program(monkeypatch, {"cascade.stage0.rows": 64})   # counters, but none of these
    assert READER.read(None) is None
    _program(monkeypatch, {})
    assert READER.read(None) is None
    monkeypatch.setitem(sys.modules, spans.PROFILING, types.SimpleNamespace())
    assert READER.read(None) is None
    monkeypatch.delitem(sys.modules, spans.PROFILING)
    assert READER.read(None) is None
