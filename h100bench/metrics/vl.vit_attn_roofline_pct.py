"""vl.vit_attn_roofline_pct: the bound of the vision tower's attention over
the slice's pages (``h100bench.kimi_vl.vit_attn_cost`` of the patches and
query-key pairs the program counted, ``vit.patches`` and
``vit.patch_pairs``, at the true head dim) over the device time of what was
launched inside the program's ``vit.attention`` spans. What an
implementation pads to reads the same work."""

from h100bench import kimi_vl


def read(run):
    return kimi_vl.vit_attn_roofline_pct(run)
