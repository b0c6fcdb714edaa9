"""v2.tower_all_ms_per_batch: device ms per batch of every kernel, copy and
set launched inside a ``v2.tower`` span (LayoutLMv2's ResNeXt-FPN tower
and its pooling), by the profiler's link from each to its launch call on
the span's thread: the convolutions and the frozen-BN affines, ReLUs, adds
and casts that ``v2.tower_ms_per_batch`` leaves to the elementwise sum."""

from h100bench import spans


def read(run):
    if run.trace is None or not run.units:
        return None
    spent = spans.device_s_launched_in(run.trace, r"^v2\.tower$")
    return 1e3 * spent / run.units if spent is not None else None
