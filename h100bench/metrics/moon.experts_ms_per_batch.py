"""moon.experts_ms_per_batch: device ms a batch of every kernel, copy and
set launched inside the program's ``moe.experts`` spans (the routed
experts: the token sort, both grouped products, the weighted sum). None
without the spans."""

from h100bench import spans


def read(run):
    if run.trace is None or not run.units:
        return None
    spent = spans.device_s_launched_in(run.trace, r"^moe\.experts$")
    return None if spent is None else 1e3 * spent / run.units
