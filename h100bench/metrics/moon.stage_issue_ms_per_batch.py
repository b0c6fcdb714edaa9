"""moon.stage_issue_ms_per_batch: host ms a batch inside the union of the
cascade's spans (``cascade.embed`` and each ``cascade.stage<i>``) less the
part ``sync.*`` spans cover: the host's own cost of issuing the stages'
work, without its waits on the card. None without the ``sync.*`` spans."""

from h100bench import syncs


def read(run):
    return syncs.stage_issue_ms_per_unit(run)
