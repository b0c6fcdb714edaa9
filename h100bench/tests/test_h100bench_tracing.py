"""The trace reader on a hand-made Chrome trace: the busy time is the union
of device intervals, the idle gaps are named by the innermost host
operation, and kernels are linked to the operation that launched them."""

from __future__ import annotations

import pytest

from h100bench import tracing


def ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    ev(tracing.SLICE, "user_annotation", 0, 100),
    ev("aten::cudnn_convolution", "cpu_op", 1, 8),
    ev("cudaLaunchKernel", "cuda_runtime", 2, 1, corr=1),
    ev("aten::add", "cpu_op", 30, 5),
    ev("cudaLaunchKernel", "cuda_runtime", 31, 1, corr=2),
    ev("aten::item", "cpu_op", 60, 30),
    ev("cudaStreamSynchronize", "cuda_runtime", 61, 28),
    ev("sm90_xmma_fprop_implicit_gemm", "kernel", 10, 20, tid=7, corr=1),  # 10-30
    ev("void at::native::add_kernel", "kernel", 25, 15, tid=8, corr=2),    # 25-40, overlaps
    ev("Memcpy DtoH", "gpu_memcpy", 80, 10, tid=7),                         # 80-90
    ev("void fwd_kernel<bf16>", "kernel", 200, 10, tid=7, corr=3),          # outside the slice
]


def test_busy_is_the_union_and_gaps_are_named():
    t = tracing.Trace(EVENTS)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)            # 10-40 and 80-90
    assert t.count() == 2 and t.count(r"\bfwd_kernel\b") == 0
    gaps = dict(t.top_gaps())
    assert gaps["aten::item"] == pytest.approx(40e-6)   # 40-80, its middle inside aten::item
    assert gaps["aten::cudnn_convolution"] == pytest.approx(10e-6) and gaps["no host op"] == pytest.approx(10e-6)
    assert sum(gaps.values()) == pytest.approx(60e-6)
    assert t.top_ops()[0] == ["sm90_xmma_fprop_implicit_gemm", pytest.approx(20e-6)]


def test_kinds_and_the_link_to_the_launching_op():
    t = tracing.Trace(EVENTS)
    assert tracing.kind("void fwd_kernel<bf16>") == "port"
    assert tracing.kind("nvjet_tst_192x192") == "gemm"
    assert tracing.kind("void at::native::add_kernel") == "other"
    assert t.kernel_s(kinds={"other"}) == pytest.approx(15e-6)
    assert t.kernel_s_under(r"^aten::cudnn_convolution") == pytest.approx(20e-6)
    assert t.kernel_s_under(r"^aten::add") == pytest.approx(15e-6)
