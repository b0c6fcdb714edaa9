"""A traced slice, read from ``torch.profiler``'s Chrome trace.

Device activity is every kernel, copy and set on the card; the device is
busy where the union of their intervals lies (two streams that overlap
count once). An idle gap is named by the host operation that was running in
its middle, the innermost one, so the breakdown says what the host was
doing while the card waited.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SLICE = "h100bench.slice"

PORT_KERNELS = re.compile(r"\b(materialize_bias_kernel|fwd_kernel|bwd_dq_kernel|bwd_dkv_kernel|"
                          r"split_bf16x3_kernel|table_partials_sum_kernel|table_grads_kernel|"
                          r"table_grads_sum_kernel)\b")
GEMM = re.compile(r"gemm|nvjet|cutlass|xmma|cublas", re.IGNORECASE)
CONV = re.compile(r"cudnn|conv|implicit", re.IGNORECASE)


def kind(name: str) -> str:
    """'port' (the hand-written kernels of csrc/), 'gemm', 'conv' or
    'other' (elementwise, reductions, copies made by kernels)."""
    if PORT_KERNELS.search(name):
        return "port"
    if GEMM.search(name):
        return "gemm"
    if CONV.search(name):
        return "conv"
    return "other"


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The slice's device operations and host operations, times in
    seconds from the trace's clock."""

    def __init__(self, events: list):
        win = [e for e in events if e.get("ph") == "X" and e.get("name") == SLICE]
        if not win:
            raise ValueError(f"the trace holds no {SLICE!r} span")
        w = win[0]
        self.t0, self.t1 = w["ts"] * 1e-6, (w["ts"] + w["dur"]) * 1e-6
        self.device = []   # (name, start, end, cat, correlation id)
        self.host = []     # (name, start, end, cat)
        self.launches = {}  # correlation id -> (thread, time) of the call that launched it
        self.ops = defaultdict(list)  # thread -> [(start, end, name)] of its CPU operations
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a, b = e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6
            if b <= self.t0 or a >= self.t1:
                continue
            cat = e.get("cat", "")
            corr = e.get("args", {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((e["name"], a, b, cat, corr))
            elif cat in HOST_CATS and e["name"] != SLICE:
                self.host.append((e["name"], a, b, cat))
                if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                    self.launches[corr] = (e.get("tid"), a)
                elif cat == "cpu_op":
                    self.ops[e.get("tid")].append((a, b, e["name"]))
        self.kernels = [d for d in self.device if d[3] == "kernel"]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self):
        return union((max(d[1], self.t0), min(d[2], self.t1)) for d in self.device)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def gaps(self):
        """(start, end) of every stretch of the window with no device
        activity."""
        out, at = [], self.t0
        for a, b in self.busy():
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            out.append((at, self.t1))
        return out

    def kernel_s(self, pattern=None, kinds=None) -> float:
        """Device seconds of the kernels whose name matches ``pattern`` (a
        regex) and whose ``kind`` is in ``kinds``."""
        rx = re.compile(pattern) if pattern else None
        return sum(k[2] - k[1] for k in self.kernels
                   if (rx is None or rx.search(k[0])) and (kinds is None or kind(k[0]) in kinds))

    def count(self, pattern=None) -> int:
        rx = re.compile(pattern) if pattern else None
        return sum(1 for k in self.kernels if rx is None or rx.search(k[0]))

    def kernel_s_under(self, op_pattern: str) -> float:
        """Device seconds of the kernels launched inside a CPU operation
        whose name matches ``op_pattern``, by the profiler's correlation of
        each kernel with its launching call."""
        rx = re.compile(op_pattern)
        under = set()
        by_thread = defaultdict(list)
        for corr, (tid, at) in self.launches.items():
            by_thread[tid].append((at, corr))
        for tid, launches in by_thread.items():
            ops = sorted(self.ops.get(tid, []))
            active, i = [], 0
            for at, corr in sorted(launches):
                while i < len(ops) and ops[i][0] <= at:
                    active.append(ops[i])
                    i += 1
                active = [o for o in active if o[1] >= at]
                if any(rx.search(o[2]) for o in active):
                    under.add(corr)
        return sum(k[2] - k[1] for k in self.kernels if k[4] in under)

    def top_ops(self, n: int = 10):
        by = defaultdict(float)
        for d in self.device:
            by[d[0]] += d[2] - d[1]
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10):
        """Idle seconds by the innermost host operation running at each
        gap's middle ('no host op' where none was)."""
        by = defaultdict(float)
        host = sorted(self.host, key=lambda h: h[1])
        active, at = [], 0
        for a, b in self.gaps():  # in time order, so one sweep over the host ops
            mid = (a + b) / 2
            while at < len(host) and host[at][1] <= mid:
                active.append(host[at])
                at += 1
            active = [h for h in active if h[2] >= mid]
            name = min(active, key=lambda h: h[2] - h[1])[0] if active else "no host op"
            by[name] += b - a
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def record(fn):
    """Run ``fn()`` under ``torch.profiler`` (CPU and CUDA activity) inside
    the slice span; returns (fn's result, Trace). The Chrome trace is
    written to a temporary file in TMPDIR, read and deleted."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function(SLICE):
            out = fn()
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, Trace(events)
