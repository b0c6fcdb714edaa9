"""train.launches_per_step: every kernel the card ran in the traced slice,
over its steps."""


def read(run):
    return run.trace.count() / run.units if run.trace is not None and run.units else None
