"""serve.attn_fwd_roofline_pct: the packed attention forward (#2,
``fwd_kernel`` in csrc/flash_attention_packed_train.cu): the sum of each
call's bound (flops.attn_fwd_cost) over the sum of the kernel's device time
in the traced slice. Nothing when the slice's launches do not match the
calls the cell makes."""

from h100bench import flops

KERNEL = r"\bfwd_kernel\b"


def read(run):
    if run.trace is None or run.trace.count(KERNEL) != len(run.attention_calls):
        return None
    spent = run.trace.kernel_s(KERNEL)
    need = sum(flops.bound_s(*flops.attn_fwd_cost(*c)) for c in run.attention_calls)
    return 100.0 * need / spent if spent > 0 else None
