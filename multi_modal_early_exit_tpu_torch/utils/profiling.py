"""Profiling and tracing utilities.

The counterpart of the JAX package's ``utils/profiling.py``, for the
reference's three mechanisms (SURVEY.md §5): fvcore FLOP analysis ->
``compiled_cost`` (FLOPs counted by ``torch.utils.flop_counter.
FlopCounterMode`` over one call; on the card also its bytes and peak from
``torch.cuda``'s memory statistics); the wall-clock ``runtime_wrapper`` and
``DeviceTimer`` (each call synchronised with the card); per-layer hooks ->
``profile_trace`` (``torch.profiler``, a Chrome trace).

``span(name)`` marks a layer boundary: while a profiler records, it is a
``record_function`` range, which the trace holds on the same clock as the
device's kernels; otherwise it costs one flag read. ``sync(site)`` is the
span ``sync.<site>`` around one call that makes the host wait for the card.
``count`` and
``counters`` are the process's named counters: work (rows served, rows a
cascade stage ran and wanted, tokens and token-expert pairs an expert layer
ran, cascade calls replayed from CUDA graphs and run op by op) and each
kernel wrapper's launches, ``launches.<kernel>``. ``launch_counts`` reads
the latter by kernel, and ``write_launch_counts`` writes a process's to
``<dir>/launches-rank<R>.json``, so that a multi-process run's counts can
be summed. A CUDA graph runs none of the host code it was captured
from, so ``recorded_tallies`` takes out what a capture tallied and
``add_tallies`` adds it again at each replay.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from typing import Callable, Dict, Optional

import torch
from torch.profiler import record_function

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_COUNTS: Dict[str, int] = {}
# the prefix of the counters that count a kernel's launches
LAUNCHES = "launches."
# the prefix of the spans that ``sync`` opens
SYNC = "sync."


def span(name: str):
    """A context manager around one layer's work: ``record_function(name)``
    while a profiler records (its range appears in the Chrome trace as a
    ``user_annotation`` event), else a shared no-op. Spans sit at layer
    boundaries, never inside a LayoutLMv3 encoder layer; Moonlight's sit at
    its sub-layer edges (``mla.attention``, ``moe.router``, ``moe.experts``,
    ``moe.shared``), a few a layer against its milliseconds of work."""
    return record_function(name) if _profiler_enabled() else _OFF


def sync(site: str):
    """A context manager around one call that makes the host wait for the
    card (a copy to the host, a ``nonzero``, a pageable copy to the card):
    ``span("sync." + site)`` while a profiler records, else the shared
    no-op after one flag read; the name is joined only under the profiler.
    Every blocking read on the serving path goes through here, so the trace
    names each wait and a test can lift PyTorch's sync check at the sites
    alone."""
    return span(SYNC + site) if _profiler_enabled() else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process-wide counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters(reset: bool = False) -> Dict[str, int]:
    """Every named counter's total in this process so far; ``reset``
    clears them after reading."""
    out = dict(_COUNTS)
    if reset:
        _COUNTS.clear()
    return out


def launch_counts(reset: bool = False) -> Dict[str, int]:
    """Each kernel's launches in this process so far, by kernel name: the
    counters ``launches.<kernel>`` that the kernel wrappers add to. A
    kernel that never launched is absent. ``reset`` clears them after
    reading them."""
    out = {k[len(LAUNCHES):]: v for k, v in _COUNTS.items() if k.startswith(LAUNCHES)}
    if reset:
        for k in out:
            del _COUNTS[LAUNCHES + k]
    return out


def write_launch_counts(directory: str, rank: Optional[int] = None) -> str:
    """This process's ``launch_counts()`` into ``<directory>/launches-rank<R>.json``
    (``R``: ``rank``, else the ``RANK`` variable, else 0); returns the path."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    path = os.path.join(directory, f"launches-rank{rank}.json")
    with open(path, "w") as f:
        json.dump(launch_counts(), f)
    return path


@contextlib.contextmanager
def recorded_tallies():
    """Yields a dict that, on exit, holds what the block added to each
    named counter (kernel launches among them); the block's additions are
    taken out again. For a block captured into a CUDA graph: its host code
    ran once, at capture, and the card ran none of it; ``add_tallies``
    adds the amounts at each replay."""
    before = dict(_COUNTS)
    delta: Dict[str, int] = {}
    try:
        yield delta
    finally:
        delta.update((k, v - before.get(k, 0)) for k, v in _COUNTS.items()
                     if v != before.get(k, 0))
        _COUNTS.clear()
        _COUNTS.update(before)


def add_tallies(delta: Dict[str, int]) -> None:
    """Add a ``recorded_tallies`` dict to the counters."""
    for name, n in delta.items():
        count(name, n)


@contextlib.contextmanager
def uncounted():
    """Launches and named counts inside do not count (for calls that only
    check a kernel against another)."""
    with recorded_tallies():
        yield


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
