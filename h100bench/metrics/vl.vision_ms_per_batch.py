"""vl.vision_ms_per_batch: device ms a batch of every kernel, copy and set
launched inside the program's ``vit.tower`` spans (the patch embedding
through the projector). None without the spans."""

from h100bench import kimi_vl


def read(run):
    return kimi_vl.vision_ms_per_batch(run)
