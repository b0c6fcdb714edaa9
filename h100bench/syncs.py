"""The program's waits on the card, read from a traced slice.

Every call on the serving path that makes the host wait for the card (a copy
to the host, a ``nonzero``, a copy from pageable host memory) lies inside a
span of its own, ``sync.<site>`` (``utils.profiling.sync``), on the kernels'
clock. While the host waits the card drains its queue, then stands idle
until the host has issued the next work, so the idle gap that follows a
wait belongs to it whole. Inside the cascade's spans, the time not spent
waiting is the host's own cost of issuing the stage's work. A program
without the spans (an older commit) leaves each reader here with nothing to
read: it returns None, never 0.
"""

from __future__ import annotations

from h100bench import spans
from h100bench.tracing import union

SYNC = r"^sync\."


def waits(run):
    """(start, end) of every ``sync.*`` span in the slice, in start order;
    None without a trace or without such spans."""
    if run.trace is None or not run.units:
        return None
    return spans.spans(run.trace, SYNC) or None


def syncs_per_unit(run):
    """``sync.*`` spans a batch."""
    found = waits(run)
    return None if found is None else len(found) / run.units


def sync_idle_ms_per_unit(run):
    """Ms a batch of the slice's idle gaps that overlap a ``sync.*`` span,
    each gap counted whole and once, however many waits it overlaps."""
    found = waits(run)
    if found is None:
        return None
    found, total, j = union(found), 0.0, 0
    for a, b in run.trace.gaps():  # in time order, like the merged waits
        while j < len(found) and found[j][1] <= a:
            j += 1
        if j < len(found) and found[j][0] < b:
            total += b - a
    return 1e3 * total / run.units


def stage_issue_ms_per_unit(run):
    """Host ms a batch inside the union of the cascade's spans
    (``cascade.embed``, ``cascade.stage<i>``) less the part that
    ``sync.*`` spans cover: the host issuing the stages' work, without its
    waits. None without the waits or without the cascade's spans."""
    found = waits(run)
    if found is None:
        return None
    stages = spans.spans(run.trace, spans.CASCADE)
    if not stages:
        return None
    inside = sum(b - a for a, b in union(stages))
    return 1e3 * (inside - spans.overlap_s(stages, found)) / run.units
