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
- its backward (#8), plain at both rates and chained at 0.1, and in f32
  (f32 q/k/v and bias) plain and chained at 0.1;
- the f32 forwards: the serving forward (#2), the training forward (#7) at
  0.1 and the head-form forward (#5) at rate 0 on the packed views, each
  with its split pre-pass, and that pre-pass (of k and v) alone;
- the head-form forward and backward (#5/#6) on the packed tensors' (B, H,
  S, D) views at rate 0, the backward also in f32;
- the table-gradient backward (#9) at rate 0.1, also in f32, and
  ``table_grads`` (#4) on a bf16 and an f32 cotangent, on the main paths'
  bias inputs (``chip_smoke.main_path_bias_inputs`` of the checkout: word
  boxes in random order), and again with the boxes in reading order
  (sorted by y1, then x0);
- where the checkout has it, the f32 backwards' split pre-pass
  (``split_bf16x3`` of q, k, v and do; part of each f32 backward's time);
- the yardsticks, one PyTorch call each: ``scaled_dot_product_attention``
  on the same views with the bias as a float mask, at rate 0 (no lse), and
  its backward (``autograd.grad`` to q, k, v and the mask), in bf16 and f32.

Beside each forward and backward it prints the host's microseconds per
call: the wall time of 200 calls issued back to back at a tiny shape (batch
1, S = P = 64, one head), where the card finishes each kernel before the
host issues the next, so the wrapper's own cost, tensor-map encoding
included.

``--cases REGEX`` times only the cases whose name matches.
``--profile`` prints, for each backward and each f32 forward, the device
time of every kernel it launches (a torch.profiler trace of 10 calls): the
split pre-pass apart from the kernel. ``--ptxas`` first compiles
the checkout's training source once more with ``-Xptxas -v`` (into a
temporary directory) and prints the registers, stack, spills and static
SASS instruction count (``cuobjdump -sass``) of every kernel whose name
holds ``bwd`` or ``fwd_kernel`` (the forward's bf16 and f32 instantiations).

To compare two versions, run it on each in one call, in turns (parent,
change, change, parent). The last line is one JSON object with the card's
name and power limit, the times in ms and the host us per call.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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


def sdpa_backward(views, mask, do):
    """One autograd.grad through SDPA to q, k, v and the float mask: the
    library backward that computes what the attention backwards compute."""
    qg, kg, vg = (x.detach().requires_grad_() for x in views)
    mask_g = mask.detach().clone().requires_grad_()
    out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask_g)
    return lambda: torch.autograd.grad(out, (qg, kg, vg, mask_g), do, retain_graph=True)


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


def ptxas_report(cuda_build) -> None:
    """ptxas' registers, stack and spills of the training source's attention
    kernels and of the table_grads kernel, as ``-Xptxas -v`` reports them."""
    for source, keep in (("flash_attention_packed_train", ("bwd", "fwd_kernel")),
                         ("table_grads", ("table_grads_kernel",))):
        src = cuda_build.CSRC / f"{source}.cu"
        sass = {}
        with tempfile.TemporaryDirectory() as tmp:
            lib = os.path.join(tmp, "lib.so")
            res = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
                                  "-o", lib, str(src)], capture_output=True, text=True, check=True)
            dump = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
            if os.path.exists(dump):  # static SASS instructions per kernel
                fn = None
                for line in subprocess.run([dump, "-sass", lib], capture_output=True, text=True,
                                           check=True).stdout.splitlines():
                    found = re.search(r"Function : (\w+)", line)
                    if found:
                        fn = found.group(1)
                    elif fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
                        sass[fn] = sass.get(fn, 0) + 1
        name, rows = None, []
        for line in (res.stdout + res.stderr).splitlines():
            found = re.search(r"Compiling entry function '(\w+)'", line)
            if found:
                name, stack = found.group(1), ("?", "?", "?")
            found = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", line)
            if found and name:
                stack = found.groups()
            found = re.search(r"Used (\d+) registers", line)
            if found and name:
                rows.append((name, int(found.group(1)), stack))
                name = None
        names = [r[0] for r in rows]
        if shutil.which("c++filt"):
            names = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                                   text=True, check=True).stdout.splitlines()
        for full, (name, regs, (stack, st, ld)) in zip(names, rows):
            if any(k in full for k in keep):
                print(f"ptxas {full}: {regs} registers, {stack} B stack, {st} B spill stores, "
                      f"{ld} B spill loads, {sass.get(name, '?')} SASS instructions")


def kernel_split(name, fn, calls: int = 10) -> None:
    """Device microseconds per call of each kernel that ``fn`` launches, from
    a torch.profiler trace of ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        if us > 0:
            short = re.search(r"\w+_kernel(<[^()]*>)?", e.key)
            parts.append(f"{short.group(0) if short else e.key[:60]} {us / calls:.1f} us "
                         f"(x{e.count // calls})")
    print(f"split {name}: " + "; ".join(parts))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--profile", action="store_true",
                        help="print each backward's device time by kernel (torch.profiler)")
    parser.add_argument("--ptxas", action="store_true",
                        help="print ptxas' registers and spills of the attention kernels")
    parser.add_argument("--cases", default="",
                        help="time only the cases whose name matches this regular expression")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_train_attention: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)
    from multi_modal_early_exit_tpu_torch.ops import cuda_build
    from multi_modal_early_exit_tpu_torch.ops import flash_attention as fa
    from multi_modal_early_exit_tpu_torch.ops import fused_bias_attention as fba
    from chip_smoke import main_path_bias_inputs

    if not cuda_build.__file__.startswith(root):
        raise RuntimeError(f"imported {cuda_build.__file__}, not the package under {root}")
    if opts.ptxas:
        ptxas_report(cuda_build)
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
    views = [x.view(b, s, h, d).transpose(1, 2) for x in (q, k, v, do)]
    cases["headform_fwd@0.0"] = lambda: fa.flash_attention_fwd(
        *views[:3], bias, 0, 0.0, with_lse=True)
    o_h, lse_h = fa.flash_attention_fwd(*views[:3], bias, 0, 0.0, with_lse=True)
    cases["headform_bwd@0.0"] = lambda: fa.flash_attention_bwd(
        *views[:3], bias, 0, o_h, lse_h, views[3], 0.0)
    # the tables backward and table_grads on the main paths' bias inputs,
    # and on the same with the boxes in reading order (sorted by y1, x0)
    vecs = main_path_bias_inputs(torch.device("cuda"), torch.Generator().manual_seed(0))[0]
    key = (vecs[2].long() * 4096 + vecs[1].long()).sort(dim=1).values
    reading = [vecs[0], (key % 4096).to(torch.int32).contiguous(),
               (key // 4096).to(torch.int32).contiguous(), *vecs[3:]]
    g_bias = (torch.randn((b, h, s, s), generator=g) * 1e-3).to("cuda", torch.bfloat16)
    for tag, vv in (("", vecs), ("_reading", reading)):
        tbias = fba.materialize_bias(*vv)
        ot, lset = fa.flash_attention_packed_train_fwd(q, k, v, tbias, 7, h, 0.1)
        cases[f"packed_tables_bwd@0.1{tag}"] = lambda vv=vv, tbias=tbias, ot=ot, lset=lset: (
            fa.flash_attention_packed_train_tables_bwd(q, k, v, tbias, *vv[:3], 7, ot, lset, do,
                                                       h, 0.1))
        cases[f"table_grads{tag}"] = lambda vv=vv: fba.table_grads(*vv[:3], g_bias)
    g_bias32 = (torch.randn((b, h, s, s), generator=g) * 1e-3).to("cuda")  # all 24 bits
    cases["f32_table_grads"] = lambda: fba.table_grads(*vecs[:3], g_bias32)
    cases["f32_table_grads_reading"] = lambda: fba.table_grads(*reading[:3], g_bias32)
    mask = bias[:, :, :s, :s]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases["sdpa@0.0"] = lambda: sdpa(*views[:3], attn_mask=mask)
    cases["sdpa_bwd@0.0"] = sdpa_backward(views[:3], mask, views[3])

    # f32: the f32 backwards beside f32 SDPA's backward
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    bias32, gbias32 = bias.float(), gbias.float()
    o32, lse32 = fa.flash_attention_packed_train_fwd(q32, k32, v32, bias32, 7, h, 0.1)
    cases["f32_packed_serving_fwd"] = lambda: fa.flash_attention_packed(
        q32, k32, v32, bias32, h)
    cases["f32_packed_fwd@0.1"] = lambda: fa.flash_attention_packed_train_fwd(
        q32, k32, v32, bias32, 7, h, 0.1)
    cases["f32_packed_bwd@0.1"] = lambda: fa.flash_attention_packed_train_bwd(
        q32, k32, v32, bias32, 7, o32, lse32, do32, h, 0.1)
    cases["f32_packed_bwd_chained@0.1"] = lambda: fa.flash_attention_packed_train_bwd(
        q32, k32, v32, bias32, 7, o32, lse32, do32, h, 0.1, gbias32)
    views32 = [x.view(b, s, h, d).transpose(1, 2) for x in (q32, k32, v32, do32)]
    cases["f32_headform_fwd@0.0"] = lambda: fa.flash_attention_fwd(
        *views32[:3], bias32, 0, 0.0, with_lse=True)
    cases["f32_sdpa@0.0"] = lambda: sdpa(*views32[:3], attn_mask=bias32[:, :, :s, :s])
    o_h32, lse_h32 = fa.flash_attention_fwd(*views32[:3], bias32, 0, 0.0, with_lse=True)
    cases["f32_headform_bwd@0.0"] = lambda: fa.flash_attention_bwd(
        *views32[:3], bias32, 0, o_h32, lse_h32, views32[3], 0.0)
    tbias32 = fba.materialize_bias(*vecs, out_dtype=torch.float32)
    ot32, lset32 = fa.flash_attention_packed_train_fwd(q32, k32, v32, tbias32, 7, h, 0.1)
    cases["f32_packed_tables_bwd@0.1"] = lambda: fa.flash_attention_packed_train_tables_bwd(
        q32, k32, v32, tbias32, *vecs[:3], 7, ot32, lset32, do32, h, 0.1)
    if hasattr(fa, "split_bf16x3"):
        cases["f32_split"] = lambda: fa.split_bf16x3(*views32)
        cases["f32_split_kv"] = lambda: fa.split_bf16x3(*views32[1:3])
    cases["f32_sdpa_bwd@0.0"] = sdpa_backward(views32[:3], bias32[:, :, :s, :s], views32[3])

    tq, tk, tv, tdo = (x[:1, :64, :d].contiguous() for x in (q, k, v, do))
    tbias = bias[:1, :1, :64, :64].contiguous()
    tviews = [x.view(1, 64, 1, d).transpose(1, 2) for x in (tq, tk, tv, tdo)]
    tiny = {f"packed_fwd@{rate}": lambda r=rate: fa.flash_attention_packed_train_fwd(
        tq, tk, tv, tbias, 7, 1, r) for rate in (0.0, 0.1)}
    tiny["packed_serving_fwd"] = lambda: fa.flash_attention_packed(tq, tk, tv, tbias, 1)
    tiny["headform_fwd@0.0"] = lambda: fa.flash_attention_fwd(
        *tviews[:3], tbias, 0, 0.0, with_lse=True)
    to, tlse = fa.flash_attention_packed_train_fwd(tq, tk, tv, tbias, 7, 1, 0.0)
    tiny["packed_bwd@0.0"] = lambda: fa.flash_attention_packed_train_bwd(
        tq, tk, tv, tbias, 7, to, tlse, tdo, 1, 0.0)
    tiny["packed_bwd_chained@0.1"] = lambda: fa.flash_attention_packed_train_bwd(
        tq, tk, tv, tbias, 7, to, tlse, tdo, 1, 0.1, tbias)
    th_o, th_lse = fa.flash_attention_fwd(*tviews[:3], tbias, 0, 0.0, with_lse=True)
    tiny["headform_bwd@0.0"] = lambda: fa.flash_attention_bwd(
        *tviews[:3], tbias, 0, th_o, th_lse, tviews[3], 0.0)
    if opts.cases:
        cases = {n: fn for n, fn in cases.items() if re.search(opts.cases, n)}
        tiny = {n: fn for n, fn in tiny.items() if re.search(opts.cases, n)}
    if opts.profile:
        for name in cases:
            if "bwd" in name or (name.startswith("f32_") and "fwd" in name):
                kernel_split(name, cases[name])
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
