#!/usr/bin/env python3
"""Does the training gradient check of ``chip_smoke.py`` (phase 5) catch
faults in the training kernels? Needs one CUDA GPU.

    python3 scripts/grad_gate_faults.py

First runs the check, at its limits (``chip_smoke.GRAD_LIMITS``), on seven
other draws of documents and labels, then on phase 5's own input: each
should pass. Then runs it on phase 5's input with one fault at a time put
into a kernel wrapper's output on CUDA tensors (the f32 plain path on the
CPU stays sound): ``table_grads`` scaled by 1.1 and 1.3, the chained
backward's incoming bias gradient dropped, and dq, dk, dv or dbias scaled
by 1.1. Prints one ``RESULT`` line per case: passed, or failed with the
check that failed. No file is changed; the faults are monkeypatches.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from multi_modal_early_exit_tpu_torch.ops import flash_attention as fa  # noqa: E402
from multi_modal_early_exit_tpu_torch.ops import fused_bias_attention as fba  # noqa: E402
from multi_modal_early_exit_tpu_torch.training.subgraphs import (  # noqa: E402
    exit_loss_weights,
    subgraph_param_counts,
)

TABLE_GRADS, TRAIN_BWD = fba.table_grads, fa.flash_attention_packed_train_bwd


def run(name, *args) -> None:
    try:
        cs.train_gradient_check(*args)
        print(f"RESULT {name}: passed", flush=True)
    except RuntimeError as exc:
        print(f"RESULT {name}: failed: {str(exc)[:200]}", flush=True)


def tables_scaled(f):
    def fn(*a):
        out = TABLE_GRADS(*a)
        return tuple(t * f for t in out) if out[0].is_cuda else out
    return fn


def chain_dropped(*a, gbias=None):
    return TRAIN_BWD(*a, gbias=None if a[0].is_cuda else gbias)


def bwd_output_scaled(i, f):
    def fn(*a, **k):
        out = list(TRAIN_BWD(*a, **k))
        if out[i].is_cuda:
            out[i] = out[i] * f
        return tuple(out)
    return fn


def main() -> int:
    cs.phase_build()
    # the labels are drawn after the pages, so each number of batches
    # gives other labels to its first batch
    for n_batches in (1, 6):
        cfg, model32, batches, _ = cs.train_setup(n_batches)
        weights = exit_loss_weights(subgraph_param_counts(model32, cfg))
        for i, batch in enumerate(batches):
            run(f"sound, batch {i} of {n_batches}", cfg, model32, batch, weights)
    cfg, model32, batches, _ = cs.train_setup(cs.TRAIN_STEPS + 1)  # phase 5's input
    cases = [
        ("sound, phase 5's input", None, None),
        ("table_grads x1.1", fba, tables_scaled(1.1)),
        ("table_grads x1.3", fba, tables_scaled(1.3)),
        ("chained bias gradient dropped", fa, chain_dropped),
        ("dq x1.1", fa, bwd_output_scaled(0, 1.1)),
        ("dk x1.1", fa, bwd_output_scaled(1, 1.1)),
        ("dv x1.1", fa, bwd_output_scaled(2, 1.1)),
        ("dbias x1.1", fa, bwd_output_scaled(3, 1.1)),
    ]
    for name, module, fault in cases:
        fba.table_grads, fa.flash_attention_packed_train_bwd = TABLE_GRADS, TRAIN_BWD
        if fault is not None:
            fault.launches = 0  # the wrapped function counts through its global name
            setattr(module, "table_grads" if module is fba
                    else "flash_attention_packed_train_bwd", fault)
        run(name, cfg, model32, batches[0], weights)
    fba.table_grads, fa.flash_attention_packed_train_bwd = TABLE_GRADS, TRAIN_BWD
    return 0


if __name__ == "__main__":
    sys.exit(main())
