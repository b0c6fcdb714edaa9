"""interactive.cascade_graphed_pct: the share of cascade calls served by replaying
CUDA graphs, 100 x ``cascade.graph_replays`` / (replays +
``cascade.eager_calls``), from the program's counters over the whole run
(warm-up, window and slice). None without those counters (an older
program) or without a cascade call."""

from h100bench import spans


def read(run):
    counts = spans.counters() or {}
    replays = counts.get("cascade.graph_replays", 0)
    calls = replays + counts.get("cascade.eager_calls", 0)
    return 100.0 * replays / calls if calls else None
