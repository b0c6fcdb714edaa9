"""vl.pack_idle_ms_per_batch: ms a batch in which the card ran nothing while
``vit.pack`` was open (the host packing the pages: the index arrays, the
position table's bicubic matrices and their two copies to the card): the
traced slice's idle gaps intersected with the spans. None without them."""

from h100bench import spans


def read(run):
    return spans.idle_ms_per_unit(run, r"^vit\.pack$")
