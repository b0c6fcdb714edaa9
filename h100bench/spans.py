"""The program's own spans and counters, read from a traced slice.

The port marks its layer boundaries with ``utils.profiling.span``: while
the profiler records, each is a ``record_function`` range, which the Chrome
trace holds as a ``user_annotation`` event on the kernels' clock (names:
``pipeline.copy_in``, ``cascade.embed``, ``cascade.stage<i>``,
``pipeline.answers``, ``get_logits.data``/``.forward``/``.store``,
``v2.tower``). Its counters (``utils.profiling.counters``) count what the
serving path ran. A program without them (an older commit) leaves every
reader here with nothing to read: each then returns None, never 0.
"""

from __future__ import annotations

import bisect
import re
import sys
from collections import defaultdict

from h100bench import flops
from h100bench.tracing import union

CASCADE = r"^cascade\.(embed|stage\d+)$"
PROFILING = "multi_modal_early_exit_tpu_torch.utils.profiling"


def spans(trace, pattern: str) -> list:
    """(start, end) of every span whose name matches ``pattern``, clipped
    to the slice, in start order."""
    rx = re.compile(pattern)
    return sorted((max(a, trace.t0), min(b, trace.t1)) for name, a, b, cat in trace.host
                  if cat == "user_annotation" and rx.search(name))


def overlap_s(xs, ys) -> float:
    """Seconds covered by both the interval sets ``xs`` and ``ys`` (each
    merged first, so intervals that overlap within a set count once)."""
    xs, ys = union(xs), union(ys)
    total, j = 0.0, 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            total += max(0.0, min(b, ys[k][1]) - max(a, ys[k][0]))
            k += 1
    return total


def host_ms_per_unit(run, pattern: str):
    """Host ms per batch inside the union of the spans matching
    ``pattern``; None without a trace or without such spans."""
    if run.trace is None or not run.units:
        return None
    found = spans(run.trace, pattern)
    if not found:
        return None
    return 1e3 * sum(b - a for a, b in union(found)) / run.units


def idle_ms_per_unit(run, pattern: str):
    """Ms per batch in which the card ran nothing while a span matching
    ``pattern`` was open: the slice's idle gaps intersected with the
    spans' union."""
    if run.trace is None or not run.units:
        return None
    found = spans(run.trace, pattern)
    if not found:
        return None
    return 1e3 * overlap_s(run.trace.gaps(), found) / run.units


def span_thread(trace, a: float, b: float):
    """The thread that ran the span (a, b): the one whose CPU operations
    inside it take the most time (a span's operations nest in it on its
    own thread)."""
    inside = defaultdict(float)
    for tid, ops in trace.ops.items():
        for start, end, _ in ops:
            if a <= start and end <= b:
                inside[tid] += end - start
    return max(inside, key=inside.get) if inside else None


def device_s_launched_in(trace, pattern: str):
    """Device seconds of every kernel, copy and set whose launch call lies
    inside a span matching ``pattern`` on the span's own thread (by the
    profiler's correlation id); None without such spans."""
    found = spans(trace, pattern)
    if not found:
        return None
    by_thread = defaultdict(list)
    for corr, (tid, at) in trace.launches.items():
        by_thread[tid].append((at, corr))
    for launches in by_thread.values():
        launches.sort()
    under = set()
    for a, b in found:
        launches = by_thread.get(span_thread(trace, a, b), [])
        i = bisect.bisect_left(launches, (a,))
        while i < len(launches) and launches[i][0] <= b:
            under.add(launches[i][1])
            i += 1
    return sum(d[2] - d[1] for d in trace.device if d[4] in under)


def counters():
    """The program's named counters, read from its module where the run
    loaded it (only the entries import the port); None where it has none."""
    read = getattr(sys.modules.get(PROFILING), "counters", None)
    return read() if read is not None else None


def encoder_fill_pct(run):
    """100 x sum_i L_i (wanted_i - refused_i) / sum_i L_i rows_i over the
    cascade's encoder stages, L_i the stage's layer count: the share of the
    encoder's row-layers that served a real document still running. The
    counters cover the whole run (warm-up, window and slice); the traffic
    is stationary, so the ratio is the window's. None without counters or
    outside a cascade."""
    counts = counters()
    if not counts or "exits" not in run.cfg:
        return None
    ends = sorted(flops.encoder_exit_layers(run.cfg)) + [run.cfg["num_hidden_layers"]]
    useful = ran = 0
    for i, (start, end) in enumerate(zip([0] + ends, ends)):
        key = f"cascade.stage{i}"
        if f"{key}.rows" not in counts:
            return None
        useful += (end - start) * (counts[f"{key}.rows_wanted"] - counts[f"{key}.rows_refused"])
        ran += (end - start) * counts[f"{key}.rows"]
    return 100.0 * useful / ran if ran else None
