"""moon.launches_per_batch: every kernel the card ran in the traced slice,
over its batches."""


def read(run):
    return run.trace.count() / run.units if run.trace is not None and run.units else None
