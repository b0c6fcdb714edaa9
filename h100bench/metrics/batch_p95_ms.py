"""batch_p95_ms: the 95th percentile of the latency of every request in the
window, one batch each, from the call to its answers on the host."""

import statistics


def read(run):
    lat = run.window.get("latencies") or []
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
