"""vl.syncs_per_batch: ``sync.*`` spans a batch in the traced slice, one
around each call that makes the host wait for the card (each host array's
copy in, the chunk's rows, the page grids, the packing's two copies, each
stage's real tokens, the three result copies). None without the spans."""

from h100bench import syncs


def read(run):
    return syncs.syncs_per_unit(run)
