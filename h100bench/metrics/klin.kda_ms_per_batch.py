"""klin.kda_ms_per_batch: device ms a batch of every kernel, copy and set
launched inside the program's ``kda.mixer`` spans (each KDA sub-layer: its
projections, convolutions, gates, the core, the gated norm and o_proj).
None without the spans."""

from h100bench import kimi_linear


def read(run):
    return kimi_linear.kda_ms_per_batch(run)
