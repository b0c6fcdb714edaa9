"""harvest.data_idle_ms_per_batch: ms per batch in which the card ran
nothing while ``get_logits.data`` was open (the next batch's gather from
the split, its pinning and the copy's enqueue): the time work waited for
its data, the slice's idle gaps intersected with the spans."""

from h100bench import spans


def read(run):
    return spans.idle_ms_per_unit(run, r"^get_logits\.data$")
