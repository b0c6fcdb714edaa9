"""moon.attn_roofline_pct: the causal attention calls' bound
(``h100bench.moonlight.attn_cost`` of each call: capacity rows, the padded
sequence) over the device time of what was launched inside the program's
``mla.attention`` spans (the attention kernel, its workspace's memset)."""

from h100bench import moonlight


def read(run):
    return moonlight.attn_roofline_pct(run)
