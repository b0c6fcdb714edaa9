"""interactive.answers_idle_ms_per_batch: ms per batch in which the card
ran nothing while ``pipeline.answers`` was open (the copies of the logits,
exits and flags to the host, the softmax, one answer dict a document): the
slice's idle gaps intersected with the spans."""

from h100bench import spans


def read(run):
    return spans.idle_ms_per_unit(run, r"^pipeline\.answers$")
