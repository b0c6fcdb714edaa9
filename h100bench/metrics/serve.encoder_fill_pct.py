"""serve.encoder_fill_pct: the share of the encoder's row-layers that
served a real document still running, from the serving counters
(``h100bench.spans.encoder_fill_pct``); the rest ran padding, documents a
stage was sized for but did not get, or none. Higher is better."""

from h100bench import spans


def read(run):
    return spans.encoder_fill_pct(run)
