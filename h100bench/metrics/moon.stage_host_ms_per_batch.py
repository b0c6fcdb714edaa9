"""moon.stage_host_ms_per_batch: host ms per batch inside the cascade's
spans (``cascade.embed`` and each ``cascade.stage<i>``, their union)."""

from h100bench import spans


def read(run):
    return spans.host_ms_per_unit(run, spans.CASCADE)
