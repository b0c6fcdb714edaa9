"""Profiling and tracing utilities.

The counterpart of the JAX package's ``utils/profiling.py``, for the
reference's three mechanisms (SURVEY.md §5): fvcore FLOP analysis ->
``compiled_cost`` (FLOPs counted by ``torch.utils.flop_counter.
FlopCounterMode`` over one call; on the card also its bytes and peak from
``torch.cuda``'s memory statistics); the wall-clock ``runtime_wrapper`` and
``DeviceTimer`` (each call synchronised with the card); per-layer hooks ->
``profile_trace`` (``torch.profiler``, a Chrome trace).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Callable, Dict

import torch


def runtime_wrapper(fn: Callable) -> Callable:
    """Wall-clock decorator (reference: EE/thresh.py:16-22); returns
    (result, seconds)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        return result, time.perf_counter() - t0

    return wrapped


def _on_cuda(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    if hasattr(x, "__dataclass_fields__"):
        return sum(_nbytes(getattr(x, f)) for f in x.__dataclass_fields__)
    return 0


def compiled_cost(fn: Callable, *example_args) -> Dict[str, float]:
    """The cost of one ``fn(*example_args)`` call: ``flops`` (a multiply-add
    is 2: the matmuls, convolutions and attention products that
    ``FlopCounterMode`` sees dispatched; elementwise work is not counted)
    and ``output_size_bytes``; when an argument lies on
    the card, also ``bytes_allocated`` (the bytes the call allocated on
    it) and ``peak_bytes`` (its peak above the memory in use before it),
    from ``torch.cuda.memory_stats``. The counterpart of the JAX package's
    XLA cost analysis of the compiled program (eager PyTorch compiles
    none, so the call runs)."""
    from torch.utils.flop_counter import FlopCounterMode

    cuda = _on_cuda(example_args)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        allocated = torch.cuda.memory_stats().get("allocated_bytes.all.allocated", 0)
    with FlopCounterMode(display=False) as counter:
        out = fn(*example_args)
    cost = {"flops": float(counter.get_total_flops()), "output_size_bytes": float(_nbytes(out))}
    if cuda:
        torch.cuda.synchronize()
        stats = torch.cuda.memory_stats()
        cost["bytes_allocated"] = float(stats.get("allocated_bytes.all.allocated", 0) - allocated)
        cost["peak_bytes"] = float(torch.cuda.max_memory_allocated() - base)
    return cost


@contextlib.contextmanager
def profile_trace(log_dir: str = "torch-trace"):
    """A ``torch.profiler`` trace of the block (the card's kernels too when
    there is one), written as ``trace.json`` under ``log_dir`` (open it in
    Perfetto or chrome://tracing); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class DeviceTimer:
    """Wall-clock timing of work on the card, the counterpart of the JAX
    package's ``TunnelSafeTimer``.

    ``fn_k`` runs ``k`` iterations per call; ``measure`` times ``n_calls``
    calls after ``warmup``, synchronising with the card after each (CUDA
    launches return before the work ends), so the seconds cover the work."""

    def __init__(self, fn_k: Callable, k: int):
        self.fn_k = fn_k
        self.k = k

    def _call(self, args) -> None:
        self.fn_k(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def measure(self, *args, n_calls: int = 3, warmup: int = 1) -> Dict[str, float]:
        for _ in range(warmup):
            self._call(args)
        t0 = time.perf_counter()
        for _ in range(n_calls):
            self._call(args)
        dt = time.perf_counter() - t0
        iters = self.k * n_calls
        return {"seconds": dt, "iterations": iters, "sec_per_iteration": dt / iters}
