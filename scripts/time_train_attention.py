#!/usr/bin/env python3
"""Time the training attention kernels of one checkout of the port on a GPU.

    python3 scripts/time_train_attention.py [--root DIR] [--rounds N]

Imports ``multi_modal_early_exit_tpu_torch`` from ``--root`` (default: this
checkout), builds its kernel libraries and times, at
the training path's shape (batch 16, S = P = 768, 12 heads of 64, bf16 q/k/v
and bias, the bias of one sample masked past 2/3 of S), by CUDA events (20
calls after 3 warm-ups, ``--rounds`` rounds, the median printed):

- ``flash_attention_packed``, the serving forward (no lse, no dropout);
- the packed training forward at dropout rates 0 and 0.1;
- its backward, plain at both rates and chained at 0.1;
- where the checkout has them, the head-form forward and backward on the
  packed tensors' (B, H, S, D) views at rate 0;
- the yardstick, one PyTorch call: ``scaled_dot_product_attention`` on the
  same views with the bias as a float mask, at rate 0 (no lse).

Beside each forward it prints the host's microseconds per call: the wall
time of 200 calls issued back to back at a tiny shape (batch 1, S = P = 64,
one head), where the card finishes each kernel before the host issues the
next, so the wrapper's own cost, tensor-map encoding included.

To compare two versions, run it on each in one call, in turns (parent,
change, change, parent). The last line is one JSON object with the card's
name and power limit, the times in ms and the host us per forward call.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200, warmup: int = 10) -> float:
    """Host microseconds per ``fn()`` call, issued back to back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--rounds", type=int, default=3)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_train_attention: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)
    from multi_modal_early_exit_tpu_torch.ops import cuda_build
    from multi_modal_early_exit_tpu_torch.ops import flash_attention as fa

    if not cuda_build.__file__.startswith(root):
        raise RuntimeError(f"imported {cuda_build.__file__}, not the package under {root}")
    cuda_build.build_all()
    b, s, h, d = 16, 768, 12, 64
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((b, s, h * d), generator=g).to("cuda", torch.bfloat16)
                   for _ in range(4))
    bias = torch.randn((b, h, s, s), generator=g)
    bias[0, :, :, (2 * s) // 3:] = -1e30
    bias = bias.to("cuda", torch.bfloat16)
    gbias = (torch.randn((b, h, s, s), generator=g) * 1e-3).to("cuda", torch.bfloat16)

    cases = {"packed_serving_fwd": lambda: fa.flash_attention_packed(q, k, v, bias, h)}
    for rate in (0.0, 0.1):
        cases[f"packed_fwd@{rate}"] = lambda r=rate: fa.flash_attention_packed_train_fwd(
            q, k, v, bias, 7, h, r)
        o, lse = fa.flash_attention_packed_train_fwd(q, k, v, bias, 7, h, rate)
        cases[f"packed_bwd@{rate}"] = lambda r=rate, o=o, lse=lse: (
            fa.flash_attention_packed_train_bwd(q, k, v, bias, 7, o, lse, do, h, r))
        if rate > 0.0:
            cases[f"packed_bwd_chained@{rate}"] = lambda r=rate, o=o, lse=lse: (
                fa.flash_attention_packed_train_bwd(q, k, v, bias, 7, o, lse, do, h, r, gbias))
    if hasattr(fa, "flash_attention_fwd"):
        views = [x.view(b, s, h, d).transpose(1, 2) for x in (q, k, v, do)]
        cases["headform_fwd@0.0"] = lambda: fa.flash_attention_fwd(
            *views[:3], bias, 0, 0.0, with_lse=True)
        o_h, lse_h = fa.flash_attention_fwd(*views[:3], bias, 0, 0.0, with_lse=True)
        cases["headform_bwd@0.0"] = lambda: fa.flash_attention_bwd(
            *views[:3], bias, 0, o_h, lse_h, views[3], 0.0)
    heads = [x.view(b, s, h, d).transpose(1, 2) for x in (q, k, v)]
    mask = bias[:, :, :s, :s]
    cases["sdpa@0.0"] = lambda: torch.nn.functional.scaled_dot_product_attention(
        *heads, attn_mask=mask)
    tq, tk, tv = (x[:1, :64, :d].contiguous() for x in (q, k, v))
    tbias = bias[:1, :1, :64, :64].contiguous()
    tviews = [x.view(1, 64, 1, d).transpose(1, 2) for x in (tq, tk, tv)]
    tiny = {f"packed_fwd@{rate}": lambda r=rate: fa.flash_attention_packed_train_fwd(
        tq, tk, tv, tbias, 7, 1, r) for rate in (0.0, 0.1)}
    tiny["packed_serving_fwd"] = lambda: fa.flash_attention_packed(tq, tk, tv, tbias, 1)
    if hasattr(fa, "flash_attention_fwd"):
        tiny["headform_fwd@0.0"] = lambda: fa.flash_attention_fwd(
            *tviews, tbias, 0, 0.0, with_lse=True)
    readings = {name: [] for name in cases}
    hosts = {name: [] for name in tiny}
    for _ in range(opts.rounds):
        for name, fn in cases.items():
            readings[name].append(time_ms(fn))
        for name, fn in tiny.items():
            hosts[name].append(host_us(fn))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for name, ms in readings.items():
        host = f", host {statistics.median(hosts[name]):.1f} us per call" if name in hosts else ""
        print(f"{name}: median {statistics.median(ms):.4f} ms of {[round(x, 4) for x in ms]}{host}")
    print(json.dumps({"root": root, "device": card.splitlines()[0],
                      "ms": {n: statistics.median(ms) for n, ms in readings.items()},
                      "host_us": {n: statistics.median(us) for n, us in hosts.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
