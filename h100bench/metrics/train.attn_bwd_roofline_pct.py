"""train.attn_bwd_roofline_pct: the training attention backward (#8, the
pair ``bwd_dq_kernel`` + ``bwd_dkv_kernel``): the sum of each call's bound
(flops.attn_bwd_cost) over the pair's device time in the traced slice.
Nothing when the slice's launches do not match the calls the cell makes."""

from h100bench import flops

PAIR = r"\b(bwd_dq_kernel|bwd_dkv_kernel)\b"


def read(run):
    if run.trace is None or run.trace.count(PAIR) != 2 * len(run.attention_calls):
        return None
    spent = run.trace.kernel_s(PAIR)
    need = sum(flops.bound_s(*flops.attn_bwd_cost(*c)) for c in run.attention_calls)
    return 100.0 * need / spent if spent > 0 else None
