"""klin.sync_idle_ms_per_batch: ms a batch of the traced slice's idle
gaps that overlap a ``sync.*`` span, each counted whole and once: the card
drains its queue while the host waits, then stands idle until the host
issues again. None without the spans."""

from h100bench import syncs


def read(run):
    return syncs.sync_idle_ms_per_unit(run)
