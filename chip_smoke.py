#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each reported on its own line:

1. device: the card's name and power limit (nvidia-smi) and capability;
2. build: the hand-written CUDA kernels, from ``csrc/`` in this checkout;
3. kernels: each kernel against its plain PyTorch version at the shape
   both paths give it (batch 16, 709 tokens padded with mask 0 to 768, so
   S = P = 768; 12 heads x 64, bf16), then again, untimed, at S = 709
   inside P = 768, as ``ee_forward`` (which does not pad) gives it:
   ``materialize_bias`` bit-equal, ``flash_attention_packed`` within 1e-2;
   the training kernels at dropout rate 0.1: ``flash_attention_packed_train``
   (out within 2e-2, lse within 1e-3; at rate 0 bit-equal to
   ``flash_attention_packed``, which phases 5c and 5d rely on, and timed
   there too beside SDPA), its backward, plain and chained
   (dq/dk/dv/dbias within 2e-2 of each output's largest value, the same
   bits on a second run) and
   ``table_grads`` (within 1e-4 of the largest table gradient, the same
   bits on a second run); the two
   kernels of the bias modes: ``fused_bias_attention`` (the forward kernel
   with the bias built on chip) on the packed
   projections' transposed view (within 1e-2 of its plain version and
   bit-equal to ``materialize_bias`` + ``flash_attention_packed``, then the
   same at unit-scale tables, where dropping any one table moves the
   outputs past the tolerance; timed beside that pair) and the table-gradient
   backward (dq/dk/dv within 2e-2 of their scale, the three table gradients
   within ``TABLE_GRAD_LIMIT`` of theirs, the same on a second run); the
   head-form forward and backward (``flash_attention_fwd``/``_bwd``, the
   training kernels' bodies with explicit strides) at the contiguous
   (B, H, S, D) layout and at the packed projections' strides, at dropout
   rates 0 and 0.1, to the training kernels' tolerances, dbias exactly 0 in
   the pad, the backward's bits the same on a second run; times at the
   paths' shape by CUDA events after warm-up (the
   head form at the packed strides and rate 0, as the backward of
   ``flash_attention_packed`` runs it), beside the least time the card could
   take and one PyTorch library call where one computes the same function,
   or the pair of kernels it replaces. Then every kernel again at f32
   inputs (f32 q/k/v and bias; the attention kernels' f32 instantiations,
   the forwards and backwards by six bf16 products of operands split into
   three bf16 parts on the tensor cores)
   against its plain version in f32, at
   both shapes: outputs, lse and gradients within ``F32_BAR`` (1e-4) of
   each output's largest value, the f32 forwards' and backwards' bits the
   same on a second run, the table gradients (``table_grads``, the same
   bits on a second run, and the tables backward) within
   ``TABLE_GRAD_LIMIT``, the fused kernel bit-equal to ``materialize_bias``
   + ``flash_attention_packed`` in f32, and the
   split pre-pass (``split_bf16x3``) bit-equal to its plain version; each
   timed beside f32 SDPA and an f32 bound (FLOPs over a sixth of the bf16
   peak for split operands), the f32
   forwards also beside their design's floor (the bytes of the pre-pass
   and of a kernel that reads the parts), ``table_grads`` and the tables
   backward beside theirs in both types, the fused kernel beside its f32
   pair;
4. serving path: EE LayoutLMv3-base (exits text_avg, vision_avg, 7; random
   weights from a seed, bf16) served through ``Pipeline.predict_features``
   at batch 16 with capacities (16, 8), from word features and uint8 page
   images normalised on the card. Checks: well-formed results and finite
   logits; launch counts of one bias build and 12 attention calls per batch;
   at full capacity the cascade's exits equal ``decide_exits(ee_forward())``
   away from the thresholds; the bf16 kernel path agrees with the f32 plain
   path (on the CPU) on a small input; the device ms of one more, traced,
   call (4 batches: all kernels, the attention, the bias build);
5. training path: the same model with f32 master weights, trained by
   ``EETrainer.train_step`` (one_stage_subgraphs_weighted, bf16 forward,
   dropout 0.1, AdamW at lr 2e-5, ``scan_fold=12``: every layer in one step,
   bench.py's train schedule, where the bias cotangent is chained) on
   batches of 16 documents: one warm-up
   step, then 3 timed steps. Checks: finite losses, parameters that moved,
   launch counts per step of 1 bias build, 1 ``table_grads`` (2 kernels:
   the per-CTA sums and their fixed-order sum), 12 training
   attention forwards and 12 chained backwards (24 kernels: dq/dbias and
   dk/dv); the gradients of one loss on 2 documents at dropout 0, bf16
   kernel path against the f32 plain path on the CPU: relative L2 over all
   gradients within 5e-2, and the worst error of one tensor over its own
   scale within ``GRAD_LIMITS``, among the tensors above 1e-2 of the largest
   gradient, the rel-pos tables and the q/k/v weights.
4b. serving with ``MMEE_FUSED_BIAS=1`` (the bias built in the attention
   kernel): the same model, thresholds and batches as phase 4. Checks: 12
   ``fused_bias_attention`` launches and no bias build or attention launch
   per batch; exits equal phase 4's for the documents away from the
   thresholds, logits within the bf16 tolerance. docs/sec, peak memory and
   the device ms of one more, traced, call beside phase 4's;
5b. training with ``MMEE_TABLE_GRADS=1`` (the table gradients in the
   attention backward): 1 + 3 steps as in phase 5. Checks: finite losses,
   parameters that moved (the rel-pos tables too), per step 1 bias build, no
   ``table_grads``, 12 training forwards, no chained backward and 12 tables
   backwards (36 kernels); the gradient check against phase 5's f32 CPU
   reference with ``GRAD_LIMITS``, and against phase 5's chained gradients
   on the card with ``CHAINED_LIMITS``. docs/sec and peak memory beside
   phase 5's, and the attention backward's device ms of one more, traced,
   step (the tables backward's three kernels) beside phase 5's (the
   chained backward's two and ``table_grads``).
4f. serving in f32: phase 4's model, thresholds procedure and batches with
   f32 weights, through ``Pipeline.predict_features``. Checks: as phase 4,
   with the small-input logits within the north star's f32 bars (atol 2e-4,
   rtol 1e-3) of the f32 plain path on the CPU. docs/sec and peak memory
   beside phase 4's, the launch counts with one ``split_bf16x3`` per
   attention call (none in phase 4), and the attention's device ms (the
   split pre-pass and the forward kernel) in one more, traced, call.
5c. the JAX package's default training schedule, ``scan_fold=1``, at
   attention dropout 0 (hidden dropout 0.1): every layer takes the bias
   tensor through ``flash_attention_packed``, whose backward runs the
   head-form forward and backward. 1 + 3 steps as in phase 5. Checks:
   finite losses, parameters that moved, per step 1 bias build, 1
   ``table_grads``, 12 ``flash_attention_packed``, 12 head-form forwards and
   12 head-form backwards (24 kernels), no training forward or chained
   backward; the gradient check (which runs the same three kernels) against
   phase 5's f32 CPU reference with ``GRAD_LIMITS`` and against phase 5's
   chained gradients on the card with ``UNCHAINED_LIMITS``. docs/sec and
   peak memory beside phase 5's.
5d. bench.py's remat schedule (``BENCH_REMAT=1``): ``scan_fold=1`` with
   ``gradient_checkpointing``, dropout 0.1. Checks: per step 24 training
   forwards (12 and 12 recomputed) and 12 plain (not chained) backwards (24
   kernels); the same two gradient checks; the gradients at dropout 0 equal
   phase 5c's bit for bit, and at dropout 0.1 (the same seeds) those of the
   same schedule without checkpointing. docs/sec and peak memory beside
   phase 5's.
5f. training in f32, ``EETrainer(TrainingArguments(bf16=False))``: the
   gradient check against phase 5's f32 CPU reference with
   ``F32_GRAD_LIMITS`` at ``scan_fold=1`` (``flash_attention_packed`` and
   the head-form pair) and at ``scan_fold=12`` (the training forward, the
   chained backward, ``table_grads``), each with its launch counts; then
   1 + 2 steps at the JAX default schedule (``scan_fold=1``, dropout 0.1).
   Checks: finite losses, parameters that moved, launch counts per step
   (one ``split_bf16x3`` per forward and per backward). docs/sec and peak
   memory beside phase 5c's, and the f32 attention's device ms (forward
   kernel, backward kernels, split pre-passes) in one more, traced, step.
4t. the tiny config (hidden 64, 4 heads of 16, 2 layers: head dim 16,
   which the kernels take zero-padded to their 64): 2 batches of 16 served
   through ``Pipeline.predict_features`` in f32 and in bf16, and one
   ``EETrainer`` step in bf16. Checks: the launch counts (every attention
   call in the kernels); the f32 kernel path's logits within the north
   star's f32 bars of the f32 plain path on the CPU, and its f32 gradients
   within ``TINY_GRAD_LIMITS``; bf16 logits within the bf16 tolerance;
   a finite loss and parameters that moved.

Every phase runs with MMEE_CHAINED_DBIAS and MMEE_LAYERS_PER_STEP unset and
phases 4, 4f, 4t, 5, 5c, 5d and 5f with the two bias switches unset, whatever the
environment says; 4b and 5b set theirs and restore it.

The next-to-last line is a JSON object with one entry per kernel (its
launches counted on the path that runs it; the f32 fields from phase 3's
f32 run and the f32 launches from phases 4f/5f; ``split_bf16x3`` runs in
f32 only, on phases 4f's and 5f's paths), the last
``{"ok": true, "device": {...}}``. Every failed check raises, so the script
exits non-zero; it needs a CUDA device and the repository's package.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# published peaks (dense) by card: bytes/s, bf16 tensor FLOP/s, f32 FLOP/s
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H100": (3.35e12, 989e12, 67e12),  # SXM
}
# the f32 attention kernels multiply by six bf16 passes of split operands,
# so their operations bound is FLOPs over a sixth of the bf16 peak (165
# TFLOP/s on an H100 SXM)
SPLIT_PASSES = 6
B, S_TEXT, HEADS, HEAD_DIM = 16, 512, 12, 64
N_BATCHES = 4
TRAIN_STEPS, TRAIN_RATE = 3, 0.1
F32_TRAIN_STEPS = 2  # phase 5f's timed steps
REL_POS_TABLES = ("rel_pos_bias", "rel_pos_x_bias", "rel_pos_y_bias")
QKV_WEIGHTS = (".query.weight", ".key.weight", ".value.weight")
# limits on the phase-5 gradient check's worst error of a tensor over its
# own scale, by group. On an H100 this input reads 2.50e-2 (visual.pos_embed),
# 3.98e-2 (rel_pos_x_bias) and 3.09e-2 (layer 2's query weight); seven other
# draws of documents and labels read at most 2.13e-2, 8.66e-2 and 5.39e-2
# (the table gradients sum terms that largely cancel, so bf16 noise in the
# bias cotangent shows most there); scripts/grad_gate_faults.py reads them
# and the faults these limits catch
GRAD_LIMITS = {"tensors": 0.05, "rel-pos tables": 0.15, "q/k/v weights": 0.1}
# the table-gradient backward's dT against its plain version, over the
# largest table gradient: both sum the same f32 ds in another order. On an
# H100 three calls read 1.7e-5 to 4.1e-5 over S = P = 768 and S = 709 inside
# P = 768 (the kernel is deterministic; the plain version's index_add_ on the
# card adds with float atomics, so the reading moves between calls)
TABLE_GRAD_LIMIT = 3e-4
# phase 5b's gradients against phase 5's chained ones on the card, same
# input, by group. Both paths share every kernel but the attention backward,
# and both backwards compute dq/dk/dv alike: on an H100 every tensor but
# the tables read 0 (bit-equal), the tables 6.5e-3 of their scale (the
# chained path rounds its running bias cotangent to bf16 in every layer,
# the tables path sums f32 ds)
CHAINED_LIMITS = {"tensors but the tables": 1e-6, "rel-pos tables": 2e-2}
# phases 5c's and 5d's gradients against phase 5's chained ones on the card,
# same input, by group. The forward runs flash_attention_packed where phase
# 5 runs the training forward at rate 0, the backward the same body at the
# same strides: on an H100 every tensor but the tables read 0 (bit-equal),
# the tables 7.97e-3 of their scale in both phases (autograd sums the
# layers' bf16 bias cotangents where phase 5 adds each layer's ds to the
# running one in the kernel)
UNCHAINED_LIMITS = {"tensors but the tables": 1e-6, "rel-pos tables": 2e-2}
# the f32 attention kernels (six bf16 products of split operands) against
# their f32 plain versions on the card, over each output's largest value;
# plain TF32 (~3 digits) misses it
F32_BAR = 1e-4
# phase 5f's gradient checks, the f32 kernel path on the card against phase
# 5's f32 plain path on the CPU, by phase 5's groups. On an H100, with the
# split-operand f32 backward, phase 5's input reads 2.96e-6
# (visual.pos_embed), 8.40e-5 (rel_pos_x_bias) and 2.39e-5 (layer 11's query
# weight); eight draws (scripts/grad_gate_faults.py --f32) read at most
# 4.75e-6, 1.22e-4 and 4.12e-5, and every fault it puts in (any kernel
# output or table gradient scaled by 1.001) fails the check, the nearest
# (dq) at 6.6e-5 on visual.pos_embed. (The 3xTF32 backward read 5.70e-6,
# 7.90e-5 and 2.21e-5, eight draws at most 1.15e-5, 1.08e-4 and 3.63e-5.)
# None may be looser than 1e-3
F32_GRAD_LIMITS = {"tensors": 5e-5, "rel-pos tables": 3e-4, "q/k/v weights": 1e-4}
# phase 4t's f32 gradient check of the tiny config (head dim 16, padded to
# the kernels' 64) against the f32 plain path on the CPU: the card tests'
# 1e-4 of each tensor's scale, and F32_GRAD_LIMITS' bar on the tables
TINY_GRAD_LIMITS = {"tensors": 1e-4, "rel-pos tables": 3e-4, "q/k/v weights": 1e-4}
SWITCHES = ("MMEE_FUSED_BIAS", "MMEE_TABLE_GRADS", "MMEE_CHAINED_DBIAS", "MMEE_LAYERS_PER_STEP")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


@contextlib.contextmanager
def bias_modes(fused=None, tables=None):
    """MMEE_FUSED_BIAS and MMEE_TABLE_GRADS set to the given values (None:
    unset), MMEE_CHAINED_DBIAS and MMEE_LAYERS_PER_STEP unset, for a phase;
    all four restored after it."""
    saved = {n: os.environ.get(n) for n in SWITCHES}

    def put(name, value):
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value

    for name, value in zip(SWITCHES, (fused, tables, None, None)):
        put(name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            put(name, value)


def bf16_close(err: float, reference: torch.Tensor) -> bool:
    """Tolerance of a bf16 forward through 12 layers against another run
    of it: 5% of the logits' scale, plus 0.05."""
    return err <= 0.05 * reference.abs().max().item() + 0.05


def widest_gap_threshold(values, lo: float, hi: float) -> float:
    """Midpoint of the widest gap between neighbouring sorted values whose
    lower end lies between the lo and hi quantiles."""
    v = np.sort(np.asarray(values, np.float64))
    a, b = int(lo * (len(v) - 1)), max(int(hi * (len(v) - 1)), int(lo * (len(v) - 1)) + 1)
    k = a + int(np.argmax(v[a + 1:b + 1] - v[a:b]))
    return float((v[k] + v[k + 1]) / 2)


def peaks_for(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    return PEAKS["H100"]


def device_ms(fn, groups):
    """Device ms of one ``fn()`` call under torch.profiler: by group (the
    kernels whose names hold one of the group's fragments), and of all
    kernels (``"all"``). Fails if a group ran no kernel on the card."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(groups, 0.0)
    ms["all"] = 0.0
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        ms["all"] += us / 1e3
        for group, frags in groups.items():
            if any(frag in e.key for frag in frags):
                ms[group] += us / 1e3
    for group, frags in groups.items():
        check(ms[group] > 0, f"the traced call ran none of {frags} on the card")
    return ms


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Milliseconds per ``fn()`` call: CUDA events around ``iters`` calls,
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"device: {name}, capability {cap[0]}.{cap[1]}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")
    check(cap == (9, 0), f"the kernels are built for sm_90a, the card is sm_{cap[0]}{cap[1]}")
    return name, smi


def phase_build():
    from multi_modal_early_exit_tpu_torch.ops import cuda_build

    secs = cuda_build.build_all()
    print(f"build: {len(cuda_build.SOURCES)} kernel libraries in {secs:.1f} s "
          f"({cuda_build.find_nvcc()})")


def main_path_bias_inputs(dev, gen):
    """The main paths' bias inputs, built as both paths build them: text
    positions then visual ones, x0/y1 of word boxes and of the visual patch
    grid and ragged text masks for 512 + 197 = 709 positions, zero-padded
    (mask 0) to 768 as the cascade and the training loss pad the sequence
    before the encoder; then the three rel-pos tables. Returns (the seven
    inputs, the unpadded length 709)."""
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import LayoutLMv3Config
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import (
        pad_sequence,
        sequence_layout,
    )
    from multi_modal_early_exit_tpu_torch.ops.fused_bias_attention import LANE

    cfg = LayoutLMv3Config.base()
    lengths = torch.randint(50, S_TEXT + 1, (B,), generator=gen)
    mask = (torch.arange(S_TEXT)[None] < lengths[:, None]).to(torch.int32)
    bbox = torch.sort(torch.randint(0, 1000, (B, S_TEXT, 4), generator=gen), -1).values
    full_bbox, pos, full_mask = sequence_layout(
        cfg, bbox.to(dev), mask.to(dev), cfg.num_visual_tokens
    )
    vecs = pad_sequence(LANE, pos, full_bbox[:, :, 0].contiguous(),
                        full_bbox[:, :, 3].contiguous(), full_mask)
    scale = 1.0 / math.sqrt(HEAD_DIM)
    tables = [(torch.randn((n, HEADS), generator=gen) * 0.02 * scale).to(dev)
              for n in (cfg.rel_pos_bins, cfg.rel_2d_pos_bins, cfg.rel_2d_pos_bins)]
    return list(vecs) + tables, pos.shape[1]


def scaled_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def heads_of(x):
    """(B, S, H*D) -> its (B, H, S, D) view, no copy."""
    return x.view(x.shape[0], x.shape[1], HEADS, HEAD_DIM).transpose(1, 2)


def compare_kernels(args, gen):
    """Each of the nine kernels against its plain version on the bias
    inputs ``args`` (batch 16; S their length, P = S rounded up to 128),
    the training kernels at dropout rate ``TRAIN_RATE``, the head form at
    rates 0 and ``TRAIN_RATE``. Raises on a disagreement. Returns (max abs
    error by kernel, what each comparison read, the inputs and outputs that
    the timing reuses)."""
    from multi_modal_early_exit_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_fwd,
        flash_attention_fwd_plain,
        flash_attention_packed,
        flash_attention_packed_plain,
        flash_attention_packed_train_bwd,
        flash_attention_packed_train_bwd_plain,
        flash_attention_packed_train_fwd,
        flash_attention_packed_train_fwd_plain,
        flash_attention_packed_train_tables_bwd,
        flash_attention_packed_train_tables_bwd_plain,
    )
    from multi_modal_early_exit_tpu_torch.ops.fused_bias_attention import (
        fused_bias_attention,
        fused_bias_attention_plain,
        materialize_bias,
        materialize_bias_plain,
        table_grads,
        table_grads_plain,
    )

    dev, s = args[0].device, args[0].shape[1]
    errs, notes = {}, {}

    # ---- materialize_bias: bit-equal to its plain version ---------------
    bias = materialize_bias(*args)
    plain = materialize_bias_plain(*args)
    torch.cuda.synchronize()
    p = bias.shape[-1]
    check(bias.shape == (B, HEADS, p, p) and p == 768, f"bias shape {tuple(bias.shape)}")
    check(torch.equal(bias, plain), f"materialize_bias differs from its plain version (S {s})")
    errs["materialize_bias"] = (bias.float() - plain.float()).abs().max().item()
    notes["materialize_bias"] = "bit-equal"
    del plain

    # ---- flash_attention_packed: within 1e-2 ----------------------------
    q, k, v = (torch.randn((B, s, HEADS * HEAD_DIM), generator=gen)
               .to(dev, torch.bfloat16) for _ in range(3))
    out = flash_attention_packed(q, k, v, bias, HEADS)
    ref = flash_attention_packed_plain(q, k, v, bias, HEADS)
    torch.cuda.synchronize()
    check(torch.isfinite(out.float()).all().item(), "flash_attention_packed gave non-finite values")
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= 1e-2, f"flash_attention_packed max error {err} > 1e-2 (S {s})")
    errs["flash_attention_packed"] = err
    notes["flash_attention_packed"] = f"max_err {err:.3e} (tol 1e-2)"

    # ---- fused_bias_attention on the projections' view: within 1e-2 ----
    qh, kh, vh = (x.view(B, s, HEADS, HEAD_DIM).transpose(1, 2) for x in (q, k, v))
    fused = fused_bias_attention(qh, kh, vh, *args)
    fused_ref = fused_bias_attention_plain(qh, kh, vh, *args)
    torch.cuda.synchronize()
    check(fused.stride() == qh.stride(), "fused_bias_attention: not in q's layout")
    check(bool(torch.isfinite(fused.float()).all()), "fused_bias_attention gave non-finite values")
    err = (fused.float() - fused_ref.float()).abs().max().item()
    check(err <= 1e-2, f"fused_bias_attention max error {err} > 1e-2 (S {s})")
    # it rounds the same bias to bf16 and shares the pair's tiling and score
    # arithmetic, so it is held bit-equal to the pair it replaces
    check(torch.equal(fused.transpose(1, 2).reshape(B, s, -1), out),
          f"fused_bias_attention differs from materialize_bias + flash_attention_packed (S {s})")
    del fused, fused_ref
    # at these tables the bias spreads the scores by ~4e-3, so dropping a
    # table moves the outputs less than the tolerance: again with unit-scale
    # tables, where each table moves them by most of their scale
    unit = list(args[:4]) + [torch.randn(a.shape, generator=gen).to(dev) for a in args[4:]]
    fused = fused_bias_attention(qh, kh, vh, *unit)
    fused_ref = fused_bias_attention_plain(qh, kh, vh, *unit)
    pair = flash_attention_packed(q, k, v, materialize_bias(*unit), HEADS)
    dropped = []
    for i in range(3):
        without = list(unit)
        without[4 + i] = torch.zeros_like(unit[4 + i])
        dropped.append(scaled_err(fused_bias_attention_plain(qh, kh, vh, *without), fused_ref))
    torch.cuda.synchronize()
    unit_err = scaled_err(fused, fused_ref)
    check(unit_err <= 1e-2, f"fused_bias_attention at unit-scale tables: error {unit_err} > "
          f"1e-2 of its scale (S {s})")
    check(torch.equal(fused.transpose(1, 2).reshape(B, s, -1), pair),
          f"fused_bias_attention at unit-scale tables differs from the pair it replaces (S {s})")
    check(min(dropped) > 1e-2, f"a dropped table moves the unit-scale outputs by only "
          f"{min(dropped)} of their scale, within the tolerance (S {s})")
    errs["fused_bias_attention"] = err
    notes["fused_bias_attention"] = (
        f"max_err {err:.3e} (tol 1e-2), bit-equal to the pair it replaces; at unit-scale "
        f"tables error {unit_err:.3e} of scale (tol 1e-2), bit-equal to the pair, and "
        f"dropping T1/Tx/Ty moves the plain output by "
        + "/".join(f"{x:.3f}" for x in dropped) + " of scale")
    del fused, fused_ref, pair

    # ---- training forward: out and lse, +inf past S ---------------------
    seed, rate = 1234, TRAIN_RATE
    t_out, lse = flash_attention_packed_train_fwd(q, k, v, bias, seed, HEADS, rate)
    ref_out, ref_lse = flash_attention_packed_train_fwd_plain(q, k, v, bias, seed, HEADS, rate)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(t_out.float()).all()), "train forward gave non-finite values")
    check(bool(torch.isinf(lse[:, :, s:]).all()), "train forward: the pad rows' lse is not +inf")
    out_err = (t_out.float() - ref_out.float()).abs().max().item()
    lse_err = (lse[:, :, :s] - ref_lse[:, :, :s]).abs().max().item()
    check(out_err <= 2e-2, f"train forward out max error {out_err} > 2e-2 (S {s})")
    check(lse_err <= 1e-3, f"train forward lse max error {lse_err} > 1e-3 (S {s})")
    # at rate 0 it repeats flash_attention_packed's arithmetic: phases 5c and
    # 5d hold their gradients bit-equal to phase 5's, which needs the same bits
    out0, _ = flash_attention_packed_train_fwd(q, k, v, bias, seed, HEADS, 0.0)
    torch.cuda.synchronize()
    check(torch.equal(out0, out), f"train forward at rate 0 differs from "
          f"flash_attention_packed (S {s})")
    errs["flash_attention_packed_train"] = max(out_err, lse_err)
    notes["flash_attention_packed_train"] = (f"out max_err {out_err:.3e} (tol 2e-2), "
                                             f"lse max_err {lse_err:.3e} (tol 1e-3); at rate 0 "
                                             f"bit-equal to flash_attention_packed")
    del ref_out, ref_lse, out0, out

    # ---- backward: dq, dk, dv, dbias; plain and chained ----------------
    do = (torch.randn((B, s, HEADS * HEAD_DIM), generator=gen) * 0.1).to(dev, torch.bfloat16)
    gbias = (torch.randn(bias.shape, generator=gen) * 1e-3).to(dev, bias.dtype)
    bwd_args = (q, k, v, bias, seed, t_out, lse, do, HEADS, rate)
    scaled, abs_errs = {}, []
    for chained in (False, True):
        extra = gbias if chained else None
        got = flash_attention_packed_train_bwd(*bwd_args, extra)
        again = flash_attention_packed_train_bwd(*bwd_args, extra)
        want = flash_attention_packed_train_bwd_plain(*bwd_args, extra)
        torch.cuda.synchronize()
        for what, a, w, a2 in zip(("dq", "dk", "dv", "dbias"), got, want, again):
            check(a.shape == w.shape and a.dtype == w.dtype, f"train backward {what} layout")
            check(bool(torch.isfinite(a.float()).all()), f"train backward {what} not finite")
            check(torch.equal(a, a2), f"train backward {what} (chained={chained}) differs "
                  f"between two runs")
            err = scaled_err(a, w)
            scaled[f"{what}{'_chained' if chained else ''}"] = round(err, 6)
            abs_errs.append((a.float() - w.float()).abs().max().item())
            check(err <= 2e-2, f"train backward {what} (chained={chained}, S {s}): error "
                  f"{err} > 2e-2 of its scale")
        pad = got[3][:, :, s:, :].float()
        want_pad = gbias[:, :, s:, :].float() if chained else torch.zeros_like(pad)
        check(torch.equal(pad, want_pad), f"train backward: dbias pad rows (chained={chained})")
        if chained:
            dbias = got[3]
        del got, want, again
    errs["flash_attention_packed_train_bwd"] = max(abs_errs)
    notes["flash_attention_packed_train_bwd"] = (
        f"errors over scale {json.dumps(scaled)} (tol 2e-2), equal on a second run")

    # ---- head form: contiguous (B, H, S, D) and the packed strides ------
    fwd_abs, bwd_abs, fwd_read, bwd_read = [], [], {}, {}
    for layout in ("contiguous", "packed"):
        views = [heads_of(x) if layout == "packed" else heads_of(x).contiguous()
                 for x in (q, k, v, do)]
        for rate_h in (0.0, TRAIN_RATE):
            tag = f"{layout}@{rate_h}"
            o_h, lse_h = flash_attention_fwd(*views[:3], bias, seed, rate_h, with_lse=True)
            ref_o, ref_lse = flash_attention_fwd_plain(*views[:3], bias, seed, rate_h)
            torch.cuda.synchronize()
            check(o_h.stride() == views[0].stride(),
                  f"head-form forward: not in q's layout ({tag})")
            check(bool(torch.isfinite(o_h.float()).all()), f"head-form forward not finite ({tag})")
            check(bool(torch.isinf(lse_h[:, :, s:]).all()), "head-form forward: pad rows' lse")
            out_err = (o_h.float() - ref_o.float()).abs().max().item()
            lse_err = (lse_h[:, :, :s] - ref_lse[:, :, :s]).abs().max().item()
            check(out_err <= 2e-2, f"head-form forward out error {out_err} > 2e-2 ({tag}, S {s})")
            check(lse_err <= 1e-3, f"head-form forward lse error {lse_err} > 1e-3 ({tag}, S {s})")
            fwd_abs.append(max(out_err, lse_err))
            fwd_read[tag] = [round(out_err, 6), round(lse_err, 7)]
            del ref_o, ref_lse
            bwd_h = (*views[:3], bias, seed, o_h, lse_h, views[3], rate_h)
            got = flash_attention_bwd(*bwd_h)
            again = flash_attention_bwd(*bwd_h)
            want = flash_attention_bwd_plain(*bwd_h)
            torch.cuda.synchronize()
            read = []
            for what, a, w, a2 in zip(("dq", "dk", "dv", "dbias"), got, want, again):
                check(a.shape == w.shape and a.dtype == w.dtype,
                      f"head-form backward {what} layout")
                check(bool(torch.isfinite(a.float()).all()),
                      f"head-form backward {what} not finite")
                check(torch.equal(a, a2), f"head-form backward {what} differs between two "
                      f"runs ({tag})")
                err = scaled_err(a, w)
                read.append(round(err, 6))
                bwd_abs.append((a.float() - w.float()).abs().max().item())
                check(err <= 2e-2, f"head-form backward {what} ({tag}, S {s}): error {err} > 2e-2 "
                      f"of its scale")
            pad = torch.cat([got[3][:, :, s:, :].flatten(), got[3][:, :, :, s:].flatten()])
            check(not bool(pad.any()), f"head-form backward: dbias not 0 in the pad ({tag})")
            bwd_read[tag] = read
            del got, want, again, o_h, lse_h
    errs["flash_attention_fwd"], errs["flash_attention_bwd"] = max(fwd_abs), max(bwd_abs)
    notes["flash_attention_fwd"] = (f"out/lse max_err by layout@rate {json.dumps(fwd_read)} "
                                    f"(tol 2e-2/1e-3)")
    notes["flash_attention_bwd"] = (f"dq/dk/dv/dbias errors over scale by layout@rate "
                                    f"{json.dumps(bwd_read)} (tol 2e-2), dbias 0 in the pad, "
                                    f"equal on a second run")

    # ---- table_grads on the chained backward's dbias -------------------
    vecs = args[:3]
    got = table_grads(*vecs, dbias)
    again = table_grads(*vecs, dbias)
    want = table_grads_plain(*vecs, dbias)
    torch.cuda.synchronize()
    tg_err, tg_abs = 0.0, 0.0
    for a, w, a2 in zip(got, want, again):
        check(bool(torch.isfinite(a).all()), "table_grads gave non-finite values")
        check(torch.equal(a, a2), f"table_grads differs between two runs (S {s})")
        tg_err = max(tg_err, scaled_err(a, w))
        tg_abs = max(tg_abs, (a - w).abs().max().item())
    check(tg_err <= 1e-4, f"table_grads error {tg_err} > 1e-4 of its scale (S {s})")
    errs["table_grads"] = tg_abs
    notes["table_grads"] = f"error {tg_err:.3e} of scale (tol 1e-4), equal on a second run"

    # ---- the table-gradient backward: dq/dk/dv and dT, deterministic ----
    tables_args = (q, k, v, bias, *vecs, seed, t_out, lse, do, HEADS, rate)
    got = flash_attention_packed_train_tables_bwd(*tables_args)
    again = flash_attention_packed_train_tables_bwd(*tables_args)
    want = flash_attention_packed_train_tables_bwd_plain(*tables_args)
    torch.cuda.synchronize()
    scaled, abs_errs = {}, []
    for what, a, w, a2 in zip(("dq", "dk", "dv", "dt1", "dtx", "dty"), got, want, again):
        check(a.shape == w.shape and a.dtype == w.dtype, f"tables backward {what} layout")
        check(bool(torch.isfinite(a.float()).all()), f"tables backward {what} not finite")
        check(torch.equal(a, a2), f"tables backward {what} differs between two runs")
        err = scaled_err(a, w)
        scaled[what] = round(err, 7)
        abs_errs.append((a.float() - w.float()).abs().max().item())
        limit = 2e-2 if what in ("dq", "dk", "dv") else TABLE_GRAD_LIMIT
        check(err <= limit, f"tables backward {what} (S {s}): error {err} > {limit} of its scale")
    errs["flash_attention_packed_train_tables_bwd"] = max(abs_errs)
    notes["flash_attention_packed_train_tables_bwd"] = (
        f"errors over scale {json.dumps(scaled)} (tol 2e-2 dq/dk/dv, {TABLE_GRAD_LIMIT} dT), "
        f"equal on a second run")
    del again, want
    saved = dict(bias=bias, q=q, k=k, v=v, ref=ref, bwd_args=bwd_args, gbias=gbias,
                 dbias=dbias, tables_out=got[3:], tables_args=tables_args)
    return errs, notes, saved


def compare_kernels_f32(args, gen):
    """Each attention kernel's f32 instantiation (f32 q/k/v, f32 bias) and
    the two bias kernels in f32 against their plain versions in f32 on the
    bias inputs ``args``: outputs, lse and gradients within ``F32_BAR`` of
    each output's largest value, the table gradients (of ``table_grads``
    and of the tables backward) within ``TABLE_GRAD_LIMIT``;
    ``materialize_bias`` bit-equal; the fused
    kernel also bit-equal to ``materialize_bias`` + ``flash_attention_packed``
    in f32; ``table_grads`` the same bits on a second run; the training
    forward at rate 0
    bit-equal to ``flash_attention_packed`` (one kernel). The training
    kernels at rate ``TRAIN_RATE``, the head form at rates 0 and
    ``TRAIN_RATE`` and both layouts. Raises on a disagreement. Returns (max
    abs error by kernel, what each comparison read, the tensors that the
    timing reuses)."""
    from multi_modal_early_exit_tpu_torch.ops import flash_attention as fa
    from multi_modal_early_exit_tpu_torch.ops import fused_bias_attention as fba

    dev, s = args[0].device, args[0].shape[1]
    f32 = torch.float32
    errs, notes = {}, {}

    def gate(kname, what, got, want, limit=F32_BAR):
        check(got.shape == want.shape and got.dtype == want.dtype, f"f32 {kname} {what} layout")
        check(bool(torch.isfinite(got).all()), f"f32 {kname} {what} not finite")
        err = scaled_err(got, want)
        check(err <= limit, f"f32 {kname} {what} (S {s}): error {err} > {limit} of its scale")
        errs[kname] = max(errs.get(kname, 0.0), (got - want).abs().max().item())
        notes.setdefault(kname, {})[what] = float(f"{err:.3e}")

    bias = fba.materialize_bias(*args, out_dtype=f32)
    check(torch.equal(bias, fba.materialize_bias_plain(*args, out_dtype=f32)),
          f"f32 materialize_bias differs from its plain version (S {s})")
    errs["materialize_bias"], notes["materialize_bias"] = 0.0, "bit-equal"
    q, k, v = (torch.randn((B, s, HEADS * HEAD_DIM), generator=gen).to(dev) for _ in range(3))
    out = fa.flash_attention_packed(q, k, v, bias, HEADS)
    gate("flash_attention_packed", "out", out, fa.flash_attention_packed_plain(q, k, v, bias, HEADS))
    check(torch.equal(out, fa.flash_attention_packed(q, k, v, bias, HEADS)),
          f"f32 flash_attention_packed differs between two runs (S {s})")
    notes["flash_attention_packed"]["two runs"] = "equal"

    qh, kh, vh = heads_of(q), heads_of(k), heads_of(v)
    for tag, bias_args in (("", args), (" at unit-scale tables", list(args[:4]) + [
            torch.randn(a.shape, generator=gen).to(dev) for a in args[4:]])):
        fused = fba.fused_bias_attention(qh, kh, vh, *bias_args)
        gate("fused_bias_attention", "out" + tag, fused,
             fba.fused_bias_attention_plain(qh, kh, vh, *bias_args))
        pair = fa.flash_attention_packed(
            q, k, v, fba.materialize_bias(*bias_args, out_dtype=f32), HEADS)
        # it builds the f32 bias the pair reads and shares its arithmetic
        check(torch.equal(fused.transpose(1, 2).reshape(B, s, -1), pair),
              f"f32 fused_bias_attention{tag} differs from materialize_bias + "
              f"flash_attention_packed (S {s})")
        notes["fused_bias_attention"]["vs the pair" + tag] = "bit-equal"
        del fused, pair

    seed, rate = 1234, TRAIN_RATE
    t_out, lse = fa.flash_attention_packed_train_fwd(q, k, v, bias, seed, HEADS, rate)
    ref_out, ref_lse = fa.flash_attention_packed_train_fwd_plain(q, k, v, bias, seed, HEADS, rate)
    check(bool(torch.isinf(lse[:, :, s:]).all()), "f32 train forward: the pad rows' lse")
    gate("flash_attention_packed_train", "out", t_out, ref_out)
    gate("flash_attention_packed_train", "lse", lse[:, :, :s], ref_lse[:, :, :s])
    out0, _ = fa.flash_attention_packed_train_fwd(q, k, v, bias, seed, HEADS, 0.0)
    check(torch.equal(out0, out), f"f32 train forward at rate 0 differs from "
          f"flash_attention_packed (S {s})")
    notes["flash_attention_packed_train"]["rate 0"] = "bit-equal to flash_attention_packed"
    del ref_out, ref_lse, out0

    do = (torch.randn((B, s, HEADS * HEAD_DIM), generator=gen) * 0.1).to(dev)
    gbias = (torch.randn(bias.shape, generator=gen) * 1e-3).to(dev)
    # the backwards' split pre-pass: q, k, v and do, as every f32 backward
    # splits them
    views = [heads_of(x) for x in (q, k, v, do)]
    parts = fa.split_bf16x3(*views)
    for x, got in zip(views, parts):
        check(torch.equal(got, fa.split_bf16x3_plain(x)),
              f"split_bf16x3 differs from its plain version (S {s})")
        hi, mid, lo = got.float()
        check(torch.equal(hi + (mid + lo), x), f"split_bf16x3: hi + mid + lo is not x (S {s})")
    errs["split_bf16x3"], notes["split_bf16x3"] = 0.0, "bit-equal, hi + (mid + lo) = x"
    del views, parts
    bwd_args = (q, k, v, bias, seed, t_out, lse, do, HEADS, rate)
    for chained in (False, True):
        extra = gbias if chained else None
        got = fa.flash_attention_packed_train_bwd(*bwd_args, extra)
        again = fa.flash_attention_packed_train_bwd(*bwd_args, extra)
        want = fa.flash_attention_packed_train_bwd_plain(*bwd_args, extra)
        for what, a, w, a2 in zip(("dq", "dk", "dv", "dbias"), got, want, again):
            gate("flash_attention_packed_train_bwd", what + ("_chained" if chained else ""), a, w)
            check(torch.equal(a, a2), f"f32 train backward {what} (chained={chained}) differs "
                  f"between two runs")
        pad = got[3][:, :, s:, :]
        check(torch.equal(pad, gbias[:, :, s:, :] if chained else torch.zeros_like(pad)),
              f"f32 train backward: dbias pad rows (chained={chained})")
        if chained:
            dbias = got[3]
        del got, want, again
    notes["flash_attention_packed_train_bwd"]["two runs"] = "equal"

    for layout in ("contiguous", "packed"):
        views = [heads_of(x) if layout == "packed" else heads_of(x).contiguous()
                 for x in (q, k, v, do)]
        for rate_h in (0.0, rate):
            tag = f"{layout}@{rate_h}"
            o_h, lse_h = fa.flash_attention_fwd(*views[:3], bias, seed, rate_h, with_lse=True)
            ref_o, ref_lse = fa.flash_attention_fwd_plain(*views[:3], bias, seed, rate_h)
            check(o_h.stride() == views[0].stride(), f"f32 head-form forward layout ({tag})")
            gate("flash_attention_fwd", f"out {tag}", o_h, ref_o)
            gate("flash_attention_fwd", f"lse {tag}", lse_h[:, :, :s], ref_lse[:, :, :s])
            del ref_o, ref_lse
            bwd_h = (*views[:3], bias, seed, o_h, lse_h, views[3], rate_h)
            got = fa.flash_attention_bwd(*bwd_h)
            again = fa.flash_attention_bwd(*bwd_h)
            want = fa.flash_attention_bwd_plain(*bwd_h)
            for what, a, w, a2 in zip(("dq", "dk", "dv", "dbias"), got, want, again):
                gate("flash_attention_bwd", f"{what} {tag}", a, w)
                check(torch.equal(a, a2), f"f32 head-form backward {what} differs between two "
                      f"runs ({tag})")
            check(not bool(got[3][:, :, s:, :].any()) and not bool(got[3][:, :, :, s:].any()),
                  f"f32 head-form backward: dbias not 0 in the pad ({tag})")
            del got, want, again, o_h, lse_h
    notes["flash_attention_bwd"]["two runs"] = "equal"

    # table_grads and its plain version sum the same f32 values in other
    # orders (the plain one by float atomics on the card): TABLE_GRAD_LIMIT
    vecs = args[:3]
    for what, a, w, a2 in zip(("dt1", "dtx", "dty"), fba.table_grads(*vecs, dbias),
                              fba.table_grads_plain(*vecs, dbias),
                              fba.table_grads(*vecs, dbias)):
        gate("table_grads", what, a, w, TABLE_GRAD_LIMIT)
        check(torch.equal(a, a2), f"f32 table_grads {what} differs between two runs (S {s})")
    notes["table_grads"]["two runs"] = "equal"

    tables_args = (q, k, v, bias, *vecs, seed, t_out, lse, do, HEADS, rate)
    got = fa.flash_attention_packed_train_tables_bwd(*tables_args)
    again = fa.flash_attention_packed_train_tables_bwd(*tables_args)
    want = fa.flash_attention_packed_train_tables_bwd_plain(*tables_args)
    for what, a, w, a2 in zip(("dq", "dk", "dv", "dt1", "dtx", "dty"), got, want, again):
        check(torch.equal(a, a2), f"f32 tables backward {what} differs between two runs")
        gate("flash_attention_packed_train_tables_bwd", what, a, w,
             F32_BAR if what in ("dq", "dk", "dv") else TABLE_GRAD_LIMIT)
    torch.cuda.synchronize()
    saved = dict(bias=bias, q=q, k=k, v=v, bwd_args=bwd_args, gbias=gbias, dbias=dbias,
                 tables_out=got[3:], tables_args=tables_args)
    return errs, {name: n if isinstance(n, str) else json.dumps(n) for name, n in notes.items()}, saved


def bound(n_bytes, n_ops, bw, peak):
    """(bound ms, what binds): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    by_bytes, by_ops = n_bytes / bw, n_ops / peak
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def phase_kernels(name):
    """Each kernel against its plain version at S = 709 inside P = 768
    (what ``ee_forward`` and ``EETrainer.evaluate``, which do not pad, give
    it), untimed, then at the shape both paths give it (S = P = 768); then
    each kernel's time at the paths' shape beside its plain version's, its
    bound and a library call where one computes the same function."""
    from multi_modal_early_exit_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_fwd,
        flash_attention_fwd_plain,
        flash_attention_packed,
        flash_attention_packed_plain,
        flash_attention_packed_train_bwd,
        flash_attention_packed_train_bwd_plain,
        flash_attention_packed_train_fwd,
        flash_attention_packed_train_fwd_plain,
        flash_attention_packed_train_tables_bwd,
        flash_attention_packed_train_tables_bwd_plain,
        split_bf16x3,
        split_bf16x3_plain,
    )
    from multi_modal_early_exit_tpu_torch.ops.fused_bias_attention import (
        fused_bias_attention,
        fused_bias_attention_plain,
        materialize_bias,
        materialize_bias_plain,
        table_grads,
        table_grads_plain,
    )

    bw, bf16_peak, f32_peak = peaks_for(name)[:3]
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    args, s_true = main_path_bias_inputs(dev, gen)
    s = args[0].shape[1]
    check(s == 768, f"the paths pad {s_true} positions to 768, the inputs have {s}")
    unpadded = [a[:, :s_true].contiguous() for a in args[:4]] + args[4:]
    notes = compare_kernels(unpadded, gen)[1]
    print(f"kernels at S {s_true} inside P 768 (untimed): "
          + "; ".join(f"{k} {v}" for k, v in notes.items()))
    errs, notes, t = compare_kernels(args, gen)
    bias, q, k, v = t["bias"], t["q"], t["k"], t["v"]
    p = bias.shape[-1]
    seed, rate = 1234, TRAIN_RATE
    qkv_bytes = B * s * HEADS * HEAD_DIM * 2  # one (B, S, H*D) bf16 tensor
    block_bytes = B * HEADS * s * s * bias.element_size()  # the S x S bias block read
    plane_bytes = B * HEADS * p * p * bias.element_size()  # a whole (B, H, P, P) tensor
    lse_bytes = B * HEADS * p * 4
    in_bytes = sum(a.numel() * a.element_size() for a in args)
    results = []
    heads = heads_of

    def entry(kname, source, replaces, ms, plain_ms, bound_pair, library_ms):
        e = dict(name=kname, route="cuda",
                 source=f"multi_modal_early_exit_tpu_torch/csrc/{source}",
                 replaces=f"multi_modal_early_exit_tpu/{replaces}", ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_pair[0], bound_by=bound_pair[1], library_ms=library_ms,
                 max_abs_err=errs[kname], ok=True)
        results.append(e)
        return e

    # ---- materialize_bias ------------------------------------------------
    e = entry("materialize_bias", "materialize_bias.cu", "ops/fused_bias_attention.py:244",
              time_ms(lambda: materialize_bias(*args)),
              time_ms(lambda: materialize_bias_plain(*args), iters=5),
              # two table sums and the mask per element, f32
              bound(plane_bytes + in_bytes, 3 * B * HEADS * p * p, bw, f32_peak), None)
    print(f"kernel materialize_bias: {notes['materialize_bias']}, kernel_ms {e['ms']:.4f}, "
          f"plain_ms {e['plain_ms']:.4f}, library_ms null, "
          f"bound {e['bound_ms'] * 1e3:.1f} us ({e['bound_by']})")

    # ---- flash_attention_packed -----------------------------------------
    mask4 = bias[:, :, :s, :s]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(heads(q), heads(k), heads(v), attn_mask=mask4)
    lib_err = (lib_out.transpose(1, 2).reshape(B, s, -1).float()
               - t["ref"].float()).abs().max().item()
    check(lib_err <= 5e-2, f"the library attention disagrees with the plain one by {lib_err}")
    del lib_out
    e = entry("flash_attention_packed", "flash_attention_packed_train.cu",
              "ops/flash_attention.py:446",
              time_ms(lambda: flash_attention_packed(q, k, v, bias, HEADS)),
              time_ms(lambda: flash_attention_packed_plain(q, k, v, bias, HEADS), iters=5),
              # the S x S bias block, q/k/v read and o written
              bound(block_bytes + 4 * qkv_bytes, 4 * B * s * s * HEADS * HEAD_DIM, bw, bf16_peak),
              time_ms(lambda: sdpa(heads(q), heads(k), heads(v), attn_mask=mask4)))
    print(f"kernel flash_attention_packed: {notes['flash_attention_packed']}, "
          f"kernel_ms {e['ms']:.4f}, plain_ms {e['plain_ms']:.4f}, library_ms "
          f"{e['library_ms']:.4f} (SDPA, max diff {lib_err:.3e}), "
          f"bound {e['bound_ms'] * 1e3:.1f} us ({e['bound_by']})")

    # ---- fused_bias_attention on the projections' view: the forward kernel
    # with the bias built on chip, beside the pair it replaces ------------
    qh, kh, vh = heads(q), heads(k), heads(v)
    pair_ms = time_ms(lambda: flash_attention_packed(q, k, v, materialize_bias(*args), HEADS))
    e = entry("fused_bias_attention", "flash_attention_packed_train.cu",
              "ops/fused_bias_attention.py:70",
              time_ms(lambda: fused_bias_attention(qh, kh, vh, *args)),
              time_ms(lambda: fused_bias_attention_plain(qh, kh, vh, *args), iters=5),
              # q/k/v read and o written, the vectors and tables read
              bound(4 * qkv_bytes + in_bytes, 4 * B * HEADS * s * s * HEAD_DIM, bw, bf16_peak),
              None)
    e["pair_ms"] = pair_ms
    print(f"kernel fused_bias_attention: {notes['fused_bias_attention']}, kernel_ms "
          f"{e['ms']:.4f}, plain_ms {e['plain_ms']:.4f}, library_ms null (no one PyTorch "
          f"call builds this bias; the pair it replaces, materialize_bias + "
          f"flash_attention_packed: {pair_ms:.4f} ms), "
          f"bound {e['bound_ms'] * 1e3:.1f} us ({e['bound_by']})")

    # ---- training forward: at the path's rate, and at rate 0 beside SDPA ----
    e = entry("flash_attention_packed_train", "flash_attention_packed_train.cu",
              "ops/flash_attention.py:607",
              time_ms(lambda: flash_attention_packed_train_fwd(q, k, v, bias, seed, HEADS, rate)),
              time_ms(lambda: flash_attention_packed_train_fwd_plain(
                  q, k, v, bias, seed, HEADS, rate), iters=5),
              bound(block_bytes + 4 * qkv_bytes + lse_bytes,
                    4 * B * HEADS * s * s * HEAD_DIM, bw, bf16_peak),
              time_ms(lambda: sdpa(heads(q), heads(k), heads(v), attn_mask=mask4)))
    rate0_ms = time_ms(lambda: flash_attention_packed_train_fwd(q, k, v, bias, seed, HEADS, 0.0))
    print(f"kernel flash_attention_packed_train (rate {rate}): "
          f"{notes['flash_attention_packed_train']}, kernel_ms {e['ms']:.4f} (rate 0: "
          f"{rate0_ms:.4f}, {rate0_ms / e['library_ms']:.2f}x SDPA), "
          f"plain_ms {e['plain_ms']:.4f}, library_ms {e['library_ms']:.4f} (SDPA at rate 0, "
          f"no lse), bound {e['bound_ms'] * 1e3:.1f} us ({e['bound_by']})")

    # ---- training backward, chained as on the path ----------------------
    bwd_args, gbias = t["bwd_args"], t["gbias"]
    ms_unchained = time_ms(lambda: flash_attention_packed_train_bwd(*bwd_args, None), iters=10)
    lib_bwd, lib_note = None, ""
    try:
        qh, kh, vh = (heads(x).detach().requires_grad_() for x in (q, k, v))
        mask_g = mask4.detach().clone().requires_grad_()
        o_lib = sdpa(qh, kh, vh, attn_mask=mask_g)
        do_h = heads(bwd_args[7])
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            o_lib, (qh, kh, vh, mask_g), do_h, retain_graph=True), iters=10)
        lib_note = "autograd.grad through SDPA, mask requiring grad, rate 0"
        del o_lib
    except RuntimeError as exc:  # the installed torch cannot differentiate the mask
        lib_note = f"none: {str(exc).splitlines()[0][:120]}"
    flops = 10 * B * HEADS * s * s * HEAD_DIM
    # reads bias, q/k/v/o/do and lse (and gbias), writes dq/dk/dv and dbias
    unchained_bound = bound(block_bytes + plane_bytes + 8 * qkv_bytes + lse_bytes,
                            flops, bw, bf16_peak)
    e = entry("flash_attention_packed_train_bwd", "flash_attention_packed_train.cu",
              "ops/flash_attention.py:652",
              time_ms(lambda: flash_attention_packed_train_bwd(*bwd_args, gbias), iters=10),
              time_ms(lambda: flash_attention_packed_train_bwd_plain(*bwd_args, gbias),
                      iters=3, warmup=1),
              bound(block_bytes + 2 * plane_bytes + 8 * qkv_bytes + lse_bytes,
                    flops, bw, bf16_peak), lib_bwd)
    print(f"kernel flash_attention_packed_train_bwd (rate {rate}, chained as on the path; "
          f"2 kernels per call): {notes['flash_attention_packed_train_bwd']}, kernel_ms "
          f"{e['ms']:.4f} (not chained {ms_unchained:.4f}, bound "
          f"{unchained_bound[0] * 1e3:.1f} us), plain_ms {e['plain_ms']:.4f}, library_ms "
          f"{'null' if lib_bwd is None else f'{lib_bwd:.4f}'} ({lib_note}), "
          f"bound {e['bound_ms'] * 1e3:.1f} us ({e['bound_by']})")

    # ---- the head form at the packed strides and rate 0, as the backward
    # of flash_attention_packed runs it; the contiguous layout beside it ----
    views = [heads(x) for x in (q, k, v, bwd_args[7])]
    dense = [x.contiguous() for x in views]
    e = entry("flash_attention_fwd", "flash_attention_packed_train.cu",
              "ops/flash_attention.py:73",
              time_ms(lambda: flash_attention_fwd(*views[:3], bias, 0, 0.0, with_lse=True)),
              time_ms(lambda: flash_attention_fwd_plain(*views[:3], bias, 0, 0.0), iters=5),
              bound(block_bytes + 4 * qkv_bytes + lse_bytes,
                    4 * B * HEADS * s * s * HEAD_DIM, bw, bf16_peak),
              time_ms(lambda: sdpa(heads(q), heads(k), heads(v), attn_mask=mask4)))
    dense_ms = time_ms(lambda: flash_attention_fwd(*dense[:3], bias, 0, 0.0, with_lse=True))
    print(f"kernel flash_attention_fwd (head form, rate 0, packed strides): "
          f"{notes['flash_attention_fwd']}, kernel_ms {e['ms']:.4f} (contiguous layout "
          f"{dense_ms:.4f}), plain_ms {e['plain_ms']:.4f}, library_ms {e['library_ms']:.4f} "
          f"(SDPA, float mask, no lse), bound {e['bound_ms'] * 1e3:.1f} us ({e['bound_by']})")
    o_h, lse_h = flash_attention_fwd(*views[:3], bias, 0, 0.0, with_lse=True)
    hbwd = (*views[:3], bias, 0, o_h, lse_h, views[3], 0.0)
    o_d, lse_d = flash_attention_fwd(*dense[:3], bias, 0, 0.0, with_lse=True)
    e = entry("flash_attention_bwd", "flash_attention_packed_train.cu",
              "ops/flash_attention.py:231",
              time_ms(lambda: flash_attention_bwd(*hbwd), iters=10),
              time_ms(lambda: flash_attention_bwd_plain(*hbwd), iters=3, warmup=1),
              unchained_bound, lib_bwd)
    dense_ms = time_ms(lambda: flash_attention_bwd(*dense[:3], bias, 0, o_d, lse_d, dense[3],
                                                   0.0), iters=10)
    print(f"kernel flash_attention_bwd (head form, rate 0, packed strides; 2 kernels per "
          f"call): {notes['flash_attention_bwd']}, kernel_ms {e['ms']:.4f} (contiguous layout "
          f"{dense_ms:.4f}; the packed plain backward {ms_unchained:.4f}), plain_ms "
          f"{e['plain_ms']:.4f}, library_ms "
          f"{'null' if lib_bwd is None else f'{lib_bwd:.4f}'} ({lib_note}), "
          f"bound {e['bound_ms'] * 1e3:.1f} us ({e['bound_by']})")
    del views, dense, o_h, lse_h, o_d, lse_d, hbwd

    # ---- table_grads on the chained backward's dbias --------------------
    vecs, dbias = args[:3], t["dbias"]
    e = entry("table_grads", "table_grads.cu", "ops/fused_bias_attention.py:362",
              time_ms(lambda: table_grads(*vecs, dbias)),
              time_ms(lambda: table_grads_plain(*vecs, dbias), iters=3, warmup=1),
              bound(block_bytes + sum(a.numel() * a.element_size() for a in vecs)
                    + sum(a.numel() * 4 for a in t["tables_out"]),
                    3 * B * HEADS * s * s, bw, f32_peak), None)
    print(f"kernel table_grads: {notes['table_grads']}, kernel_ms {e['ms']:.4f}, plain_ms "
          f"{e['plain_ms']:.4f}, library_ms null (no one PyTorch call buckets g into the "
          f"three tables; the plain version is three index_add_ calls after the bucket "
          f"maps), bound {e['bound_ms'] * 1e3:.1f} us ({e['bound_by']}; the design reads g "
          f"once: its floor is the bound)")
    tg_ms = e["ms"]

    # ---- the table-gradient backward ----------------------------------------
    tables_args = t["tables_args"]
    chained_ms = next(r["ms"] for r in results if r["name"] == "flash_attention_packed_train_bwd")
    vec_table_bytes = (sum(a.numel() * a.element_size() for a in vecs)
                       + sum(a.numel() * 4 for a in t["tables_out"]))
    tables_bound = bound(block_bytes + 8 * qkv_bytes + lse_bytes + vec_table_bytes,
                         10 * B * HEADS * s * s * HEAD_DIM, bw, bf16_peak)
    # the design's floor: (A') reads the bias block, q, do, k, v and o (for
    # delta) and the lse, writes dq and delta; (B) reads the bias block, q,
    # do, k, v, the lse and delta, writes dk and dv: the bias twice, no
    # gbias and no dbias
    tables_floor = (2 * block_bytes + 12 * qkv_bytes + 3 * lse_bytes + vec_table_bytes) / bw * 1e3
    e = entry("flash_attention_packed_train_tables_bwd", "flash_attention_packed_train.cu",
              "ops/flash_attention.py:1038",
              time_ms(lambda: flash_attention_packed_train_tables_bwd(*tables_args), iters=10),
              time_ms(lambda: flash_attention_packed_train_tables_bwd_plain(*tables_args),
                      iters=3, warmup=1),
              tables_bound, None)
    print(f"kernel flash_attention_packed_train_tables_bwd (rate {rate}; 3 kernels per call): "
          f"{notes['flash_attention_packed_train_tables_bwd']}, kernel_ms {e['ms']:.4f}, "
          f"plain_ms {e['plain_ms']:.4f}, library_ms null (no one call gives table "
          f"gradients; the pair it replaces, the chained backward + table_grads: "
          f"{chained_ms:.4f} + {tg_ms:.4f} ms; per step of 12 layers {12 * e['ms']:.3f} ms "
          f"against {12 * chained_ms + tg_ms:.3f} ms), "
          f"bound {e['bound_ms'] * 1e3:.1f} us ({e['bound_by']}; design floor "
          f"{tables_floor:.4f} ms)")

    # ---- f32: every kernel again at f32 inputs (the attention kernels'
    # f32 instantiations), against f32 plain versions, then timed beside
    # f32 SDPA and an f32 bound --------------------------------------------
    split_peak = bf16_peak / SPLIT_PASSES
    notes32 = compare_kernels_f32(unpadded, gen)[1]
    print(f"f32 kernels at S {s_true} inside P 768 (untimed; errors over scale, tol "
          f"{F32_BAR}): " + "; ".join(f"{k} {v}" for k, v in notes32.items()))
    errs32, notes32, t32 = compare_kernels_f32(args, gen)
    bias32, q32, k32, v32 = t32["bias"], t32["q"], t32["k"], t32["v"]
    qkv32 = 2 * qkv_bytes
    block32 = B * HEADS * s * s * 4
    plane32 = B * HEADS * p * p * 4
    by_name = {e["name"]: e for e in results}

    def f32_entry(kname, ms, bound_pair, library_ms, note=""):
        e = by_name[kname]
        e.update(f32_ms=ms, f32_bound_ms=bound_pair[0], f32_bound_by=bound_pair[1],
                 f32_library_ms=library_ms, f32_max_abs_err=errs32[kname])
        lib = "null" if library_ms is None else f"{library_ms:.4f}"
        print(f"kernel {kname} f32: {notes32[kname]}, kernel_ms {ms:.4f}{note}, library_ms "
              f"{lib}, bound {e['f32_bound_ms'] * 1e3:.1f} us ({e['f32_bound_by']})")

    mask32 = bias32[:, :, :s, :s]
    fwd_flops = 4 * B * HEADS * s * s * HEAD_DIM
    bwd_flops = 10 * B * HEADS * s * s * HEAD_DIM
    sdpa32 = time_ms(lambda: sdpa(heads(q32), heads(k32), heads(v32), attn_mask=mask32))
    # the f32 forwards' own floor: the split pre-pass reads k/v and writes
    # their three bf16 parts, then the kernel reads the bias block, q and the
    # parts and writes o (and the lse); timed beside it, the pre-pass alone
    views32 = [heads(x) for x in (k32, v32)]
    split_kv_ms = time_ms(lambda: split_bf16x3(*views32))
    del views32

    def fwd_floor(extra_bytes=0):
        kernel = (block32 + 2 * qkv32 + 6 * qkv_bytes + extra_bytes) / bw * 1e3
        pre = (2 * qkv32 + 6 * qkv_bytes) / bw * 1e3
        return (f"; design floor {kernel + pre:.4f} ms: the kernel {kernel:.4f} (bias, q, k/v "
                f"parts, o), the pre-pass {pre:.4f} (measured alone: {split_kv_ms:.4f} ms)")

    f32_entry("materialize_bias", time_ms(lambda: materialize_bias(*args, out_dtype=torch.float32)),
              bound(plane32 + in_bytes, 3 * B * HEADS * p * p, bw, f32_peak), None)
    f32_entry("flash_attention_packed",
              time_ms(lambda: flash_attention_packed(q32, k32, v32, bias32, HEADS)),
              bound(block32 + 4 * qkv32, fwd_flops, bw, split_peak), sdpa32,
              " (SDPA, f32" + fwd_floor() + ")")
    qh32, kh32, vh32 = heads(q32), heads(k32), heads(v32)
    pair32 = time_ms(lambda: flash_attention_packed(
        q32, k32, v32, materialize_bias(*args, out_dtype=torch.float32), HEADS))
    by_name["fused_bias_attention"]["f32_pair_ms"] = pair32
    # its own floor: the split pre-pass, then q read and o written in f32
    # and the k/v parts read, no bias
    fused_floor = (2 * (2 * qkv32 + 6 * qkv_bytes) + in_bytes) / bw * 1e3
    f32_entry("fused_bias_attention",
              time_ms(lambda: fused_bias_attention(qh32, kh32, vh32, *args)),
              bound(4 * qkv32 + in_bytes, fwd_flops, bw, split_peak), None,
              f" (split pre-pass included; the f32 pair it replaces, materialize_bias + "
              f"flash_attention_packed: {pair32:.4f} ms; design floor {fused_floor:.4f} ms)")
    f32_entry("flash_attention_packed_train",
              time_ms(lambda: flash_attention_packed_train_fwd(q32, k32, v32, bias32, seed, HEADS,
                                                               rate)),
              bound(block32 + 4 * qkv32 + lse_bytes, fwd_flops, bw, split_peak), sdpa32,
              f" (rate {rate}; SDPA at rate 0, no lse" + fwd_floor(lse_bytes) + ")")
    bwd32, gbias32 = t32["bwd_args"], t32["gbias"]
    lib_bwd32 = None
    if lib_bwd is not None:  # the installed torch differentiates the mask
        qg, kg, vg = (heads(x).detach().requires_grad_() for x in (q32, k32, v32))
        mask_g32 = mask32.detach().clone().requires_grad_()
        o_lib = sdpa(qg, kg, vg, attn_mask=mask_g32)
        do_h32 = heads(bwd32[7])
        lib_bwd32 = time_ms(lambda: torch.autograd.grad(
            o_lib, (qg, kg, vg, mask_g32), do_h32, retain_graph=True), iters=10)
        del o_lib
    f32_entry("flash_attention_packed_train_bwd",
              time_ms(lambda: flash_attention_packed_train_bwd(*bwd32, gbias32), iters=10),
              bound(block32 + 2 * plane32 + 8 * qkv32 + lse_bytes, bwd_flops, bw, split_peak),
              lib_bwd32, f" (rate {rate}, chained; not chained "
              f"{time_ms(lambda: flash_attention_packed_train_bwd(*bwd32, None), iters=10):.4f})")
    views32 = [heads(x) for x in (q32, k32, v32, bwd32[7])]
    f32_entry("flash_attention_fwd",
              time_ms(lambda: flash_attention_fwd(*views32[:3], bias32, 0, 0.0, with_lse=True)),
              bound(block32 + 4 * qkv32 + lse_bytes, fwd_flops, bw, split_peak), sdpa32,
              " (rate 0, packed strides" + fwd_floor(lse_bytes) + ")")
    o_h32, lse_h32 = flash_attention_fwd(*views32[:3], bias32, 0, 0.0, with_lse=True)
    hbwd32 = (*views32[:3], bias32, 0, o_h32, lse_h32, views32[3], 0.0)
    f32_entry("flash_attention_bwd", time_ms(lambda: flash_attention_bwd(*hbwd32), iters=10),
              bound(block32 + plane32 + 8 * qkv32 + lse_bytes, bwd_flops, bw, split_peak),
              lib_bwd32, " (rate 0, packed strides)")
    # the split pre-pass of q, k, v and do, as each f32 backward runs it
    # (each f32 forward splits k and v: timed above): f32 only, so its
    # row's fields are its f32 readings
    split_ms = time_ms(lambda: split_bf16x3(*views32))
    split_bound = bound(4 * qkv32 + 12 * qkv_bytes, 0, bw, bf16_peak)  # 3 bf16 parts each
    e = dict(name="split_bf16x3", route="cuda",
             source="multi_modal_early_exit_tpu_torch/csrc/flash_attention_packed_train.cu",
             replaces="multi_modal_early_exit_tpu/ops/flash_attention.py:652", ms=split_ms,
             plain_ms=time_ms(lambda: [split_bf16x3_plain(x) for x in views32], iters=3,
                              warmup=1),
             bound_ms=split_bound[0], bound_by=split_bound[1], library_ms=None,
             max_abs_err=errs32["split_bf16x3"], ok=True, f32_ms=split_ms,
             f32_bound_ms=split_bound[0], f32_bound_by=split_bound[1], f32_library_ms=None,
             f32_max_abs_err=errs32["split_bf16x3"])
    results.append(e)
    print(f"kernel split_bf16x3 (f32 only; q, k, v and do, as each f32 backward splits "
          f"them; k and v before each f32 forward: {split_kv_ms:.4f} ms): "
          f"{notes32['split_bf16x3']}, kernel_ms {split_ms:.4f}, plain_ms "
          f"{e['plain_ms']:.4f}, library_ms null (no one PyTorch call splits f32 into three "
          f"bf16 parts), bound {split_bound[0] * 1e3:.1f} us ({split_bound[1]})")
    del views32, o_h32, lse_h32, hbwd32
    dbias32 = t32["dbias"]
    f32_entry("table_grads", time_ms(lambda: table_grads(*vecs, dbias32)),
              bound(block32 + vec_table_bytes, 3 * B * HEADS * s * s, bw, f32_peak), None,
              " (f32 g; the design reads g once: its floor is the bound)")
    tables32 = t32["tables_args"]
    # the design's floor in f32: the split pre-pass reads q, k, v, do and
    # writes their parts; (A') and (B) each read the f32 bias block and the
    # parts of q, do, k, v, (A') also o and do in f32 for delta
    floor32 = (2 * block32 + 4 * qkv32 + 12 * qkv_bytes + 2 * 12 * qkv_bytes + 2 * qkv32
               + 3 * qkv32 + 3 * lse_bytes + vec_table_bytes) / bw * 1e3
    f32_entry("flash_attention_packed_train_tables_bwd",
              time_ms(lambda: flash_attention_packed_train_tables_bwd(*tables32), iters=10),
              bound(block32 + 8 * qkv32 + lse_bytes + vec_table_bytes, bwd_flops, bw,
                    split_peak), None,
              f" (rate {rate}; (A') and (B) on split operands; design floor {floor32:.4f} ms, "
              f"pre-pass included)")

    print("kernels: " + ", ".join(f"{e['name']} ok={e['ok']}" for e in results))
    return results


def synthetic_pages(n, rng, tokenizer, seq_len):
    """n documents: word features (ragged lengths, word boxes on lines) and
    uint8 page images with text-like bands."""
    from multi_modal_early_exit_tpu_torch.data.features import convert_words_to_features

    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    feats, pages = [], []
    for _ in range(n):
        n_words = int(rng.integers(20, 420))
        words = ["".join(rng.choice(letters, int(rng.integers(2, 11)))) for _ in range(n_words)]
        x0 = rng.integers(0, 900, n_words)
        y0 = np.sort(rng.integers(0, 980, n_words))
        boxes = np.stack([x0, y0, x0 + rng.integers(10, 100, n_words), y0 + 15], -1)
        feats.append(convert_words_to_features(words, boxes.tolist(), tokenizer, seq_len))
        page = np.full((1000, 772, 3), 255, np.uint8)
        for y in rng.integers(0, 990, 40):
            page[y:y + 8, rng.integers(0, 300):rng.integers(400, 772)] = rng.integers(0, 120)
        pages.append(page)
    stack = {k: np.stack([f[k] for f in feats]) for k in feats[0]}
    return stack, np.stack(pages)


DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def f32_close(got, want) -> bool:
    """The north star's f32 bars: atol 2e-4, rtol 1e-3
    (tests/test_golden_base.py:65,78)."""
    return bool(((got - want).abs() <= 2e-4 + 1e-3 * want.abs()).all())


@torch.no_grad()
def phase_main_path(dtype=torch.bfloat16, base=None):
    """Phase 4 (bf16), or 4f (f32, with phase 4's readings ``base`` to
    print beside its own): returns (launches, the state that phase 4b
    reuses)."""
    from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig
    from multi_modal_early_exit_tpu_torch.data.features import HashWordTokenizer
    from multi_modal_early_exit_tpu_torch.data.images import preprocess_images
    from multi_modal_early_exit_tpu_torch.models.ee.cascade import make_cascade_forward
    from multi_modal_early_exit_tpu_torch.models.ee.model import (
        decide_exits,
        ee_forward,
        init_ee_params,
    )
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import (
        EEModelConfig,
        LayoutLMv3Config,
    )
    from multi_modal_early_exit_tpu_torch.ops.flash_attention import (
        flash_attention_packed,
        split_bf16x3,
    )
    from multi_modal_early_exit_tpu_torch.ops.fused_bias_attention import materialize_bias
    from multi_modal_early_exit_tpu_torch.serving import Pipeline

    cfg = EEModelConfig(
        backbone=LayoutLMv3Config.base(num_labels=16),
        exit=ExitConfig(exits="text_avg,vision_avg,7"),
    )
    t0 = time.perf_counter()
    model32 = init_ee_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    n_params = sum(p.numel() for p in model32.parameters())
    model = copy.deepcopy(model32).to("cuda", dtype)
    tag = DTYPE_NAMES[dtype]
    print(f"main path: EE LayoutLMv3-base, {n_params / 1e6:.1f}M params, {tag}, "
          f"exits text_avg,vision_avg,7, init {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    tok = HashWordTokenizer(vocab_size=cfg.backbone.vocab_size)
    feats, pages = synthetic_pages(N_BATCHES * B, rng, tok, S_TEXT)
    pixels = preprocess_images(torch.from_numpy(pages).cuda(), size=224)
    check(pixels.shape == (N_BATCHES * B, 3, 224, 224) and pixels.is_cuda, "pixel shape")
    batch = {k: torch.from_numpy(v).cuda() for k, v in feats.items()}
    batch["pixel_values"] = pixels

    keys = ("input_ids", "bbox", "pixel_values", "attention_mask")
    chunks = [[batch[k][i * B:(i + 1) * B] for k in keys] for i in range(N_BATCHES)]

    # the kernel path against the f32 plain path on the CPU, 2 documents,
    # with the heads as initialised: bf16 to the bf16 tolerance, f32 to the
    # north star's f32 bars
    small = [a[:2] for a in chunks[0]]
    cpu_out = ee_forward(model32, cfg, *[a.cpu() for a in small])
    gpu_out = ee_forward(model, cfg, *small)
    a, b = gpu_out.policy_logits().float().cpu(), cpu_out.policy_logits()
    ref_err = (a - b).abs().max().item()
    check(bool(torch.isfinite(a).all()), "non-finite logits on the kernel path")
    if dtype == torch.float32:
        check(f32_close(a, b), f"f32 kernel path vs f32 plain path: {ref_err} "
              f"(atol 2e-4, rtol 1e-3)")
        bar = "atol 2e-4 / rtol 1e-3"
    else:
        check(bf16_close(ref_err, b), f"kernel path vs f32 plain path: {ref_err}")
        bar = "5% of scale + 0.05"
    print(f"reference: {tag} kernel path vs f32 plain path (CPU), 2 documents: "
          f"policy-logit max diff {ref_err:.3e} at logit scale {b.abs().max().item():.2f} "
          f"(tol {bar})")

    # random heads give every document nearly the same logits (a common
    # offset per class, a tiny spread across documents), so every criterion
    # sits near one value; rescale and re-centre each head's out_proj on
    # these documents so its logits vary across documents with std 1
    heads = [*model.embedding_exits.values(), *model.encoder_exits, model.backbone.classifier]
    store = torch.cat([ee_forward(model, cfg, *c).policy_logits().float() for c in chunks], 1)
    with torch.no_grad():
        for head, logits in zip(heads, store):
            mean = logits.mean(dim=0)
            gain = 1.0 / (logits - mean).std().item()
            proj = head.out_proj
            proj.weight.mul_(gain)
            proj.bias.copy_(proj.bias * gain - gain * mean.to(proj.bias))

    # per-exit thresholds in the widest gap among each exit's top criteria
    # over all documents: a few exit at every exit, and more than 8 of a
    # batch's 16 usually reach layer 7, so stage 1's capacity overflows
    refs = [ee_forward(model, cfg, *c) for c in chunks]
    crit = torch.cat([r.exit_criteria for r in refs], dim=1).float().cpu().numpy()
    thr = [widest_gap_threshold(row, 0.88, 0.97) for row in crit[:-1]]
    print(f"thresholds per exit: {[round(t, 4) for t in thr]}")

    # full capacity: the cascade is the exact threshold policy
    full_cascade = make_cascade_forward(cfg, (B, B), thr)
    got_ids, got_logits, want_ids, want_logits = [], [], [], []
    for c, r in zip(chunks, refs):
        res = full_cascade(model, *c)
        ids = decide_exits(r, cfg.exit, thr)
        got_ids.append(res.exit_ids.cpu())
        got_logits.append(res.logits.cpu())
        want_ids.append(ids.cpu())
        want_logits.append(r.policy_logits().float()[ids.long(), torch.arange(B, device="cuda")].cpu())
    got_ids, want_ids = torch.cat(got_ids), torch.cat(want_ids)
    got_logits, want_logits = torch.cat(got_logits), torch.cat(want_logits)
    margin = np.abs(crit[:-1] - np.asarray(thr)[:, None]).min(axis=0)
    far = torch.from_numpy(margin > 1e-2)
    n_docs = N_BATCHES * B
    check(int(far.sum()) >= n_docs // 4, f"only {int(far.sum())} documents lie 1e-2 "
          f"away from every threshold: the comparison would say little")
    check(bool(torch.isfinite(got_logits).all()), "non-finite cascade logits")
    agree = got_ids == want_ids
    check(bool(agree[far].all()), f"cascade exits differ from the exact policy: "
          f"{got_ids.tolist()} vs {want_ids.tolist()}")
    logit_err = (got_logits - want_logits)[agree].abs().max().item()
    check(bf16_close(logit_err, want_logits),
          f"cascade logits differ from ee_forward by {logit_err}")
    print(f"full capacity: exits equal the exact policy for {int(far.sum())}/{n_docs} "
          f"documents farther than 1e-2 from every threshold ({int((~far).sum())} "
          f"nearer, {int(agree[~far].sum())} of those agree), logit max diff {logit_err:.3e}")

    # ---- serve through the Pipeline: capacities (16, 8) ------------------
    pipe = Pipeline(model, cfg, threshold=thr, batch_size=B, tokenizer=tok,
                    exit_distribution={0: 0.05, 1: 0.05, 2: 0.8, 3: 0.1})
    check(pipe.capacities == (16, 8), f"capacities {pipe.capacities}")
    pipe.predict_features({k: v[:B] for k, v in batch.items()})  # warm-up
    counters = {"materialize_bias": materialize_bias,
                "flash_attention_packed": flash_attention_packed, "split_bf16x3": split_bf16x3}
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = pipe.predict_features(batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = {name: f.launches for name, f in counters.items()}
    check(len(results) == n_docs, f"{len(results)} results for {n_docs} documents")
    order = [str(e) for e in pipe.order] + ["final"]
    for r in results:
        check(r["exit_name"] in order and 0.0 <= r["confidence"] <= 1.0
              and math.isfinite(r["confidence"]) and r["label_id"] in range(16),
              f"malformed result {r}")
    check(launches["materialize_bias"] == N_BATCHES, f"bias launches {launches}")
    check(launches["flash_attention_packed"] == 12 * N_BATCHES, f"attention launches {launches}")
    # an f32 attention call splits k and v first; a bf16 one does not
    check(launches["split_bf16x3"] == (12 * N_BATCHES if dtype == torch.float32 else 0),
          f"split launches {launches}")
    hist = {name: sum(r["exit_name"] == name for r in results) for name in order}
    forced = sum(r["capacity_exited"] for r in results)
    check(forced > 0 and hist["final"] > 0 and hist[order[0]] + hist[order[1]] > 0,
          f"expected early, forced and final exits: {hist}, forced {forced}")
    beside = "" if base is None else (
        f" (phase 4: {base['docs_per_sec']:.1f} docs/sec, {base['peak_mb']:.1f} MiB)")
    if dtype == torch.float32:  # the f32 attention's device time in one more call
        ms = device_ms(lambda: pipe.predict_features(batch),
                       {"attention": ("fwd_kernel<", "split_bf16x3_kernel"),
                        "split": ("split_bf16x3_kernel",)})
        traced = (f"; one more call traced: the f32 attention (split pre-pass and forward "
                  f"kernel) {ms['attention']:.3f} device ms (the pre-pass {ms['split']:.3f}) "
                  f"of {ms['all']:.3f}")
    else:  # phase 4b prints its own beside these
        ms = device_ms(lambda: pipe.predict_features(batch),
                       {"attention": ("fwd_kernel<",), "bias": ("materialize_bias_kernel",)})
        traced = (f"; one more call traced: {ms['all']:.3f} device ms, the attention "
                  f"{ms['attention']:.3f}, the bias build {ms['bias']:.3f}")
    print(f"served {n_docs} documents in {N_BATCHES} batches of {B} ({tag}): "
          f"{n_docs / dt:.1f} docs/sec (predict_features, host clock), "
          f"exits {hist}, capacity-exited {forced}, launches {launches}, "
          f"peak memory {peak_mb:.1f} MiB{beside}{traced}")
    served = dict(model=model, cfg=cfg, pipe=pipe, batch=batch, chunks=chunks, thr=thr,
                  far=far, got_ids=got_ids, got_logits=got_logits, results=results,
                  docs_per_sec=n_docs / dt, peak_mb=peak_mb, device_ms=ms)
    return launches, served


@torch.no_grad()
def phase_serve_fused(served):
    """Phase 4 again with MMEE_FUSED_BIAS=1 (the caller sets it): the same
    model, thresholds and batches, through the full-capacity cascade and the
    Pipeline."""
    from multi_modal_early_exit_tpu_torch.models.ee.cascade import make_cascade_forward
    from multi_modal_early_exit_tpu_torch.ops.flash_attention import flash_attention_packed
    from multi_modal_early_exit_tpu_torch.ops.fused_bias_attention import (
        fused_bias_attention,
        materialize_bias,
    )

    s = served
    model, cfg, far = s["model"], s["cfg"], s["far"]
    counters = {"fused_bias_attention": fused_bias_attention,
                "materialize_bias": materialize_bias,
                "flash_attention_packed": flash_attention_packed}
    full_cascade = make_cascade_forward(cfg, (B, B), s["thr"])
    res = [full_cascade(model, *c) for c in s["chunks"]]
    ids = torch.cat([r.exit_ids.cpu() for r in res])
    logits = torch.cat([r.logits.cpu() for r in res])
    check(bool(torch.isfinite(logits).all()), "non-finite fused-bias cascade logits")
    agree = ids == s["got_ids"]
    check(bool(agree[far].all()), f"fused-bias exits differ from phase 4's: {ids.tolist()} "
          f"vs {s['got_ids'].tolist()}")
    logit_err = (logits - s["got_logits"])[agree].abs().max().item()
    check(bf16_close(logit_err, s["got_logits"]),
          f"fused-bias cascade logits differ from phase 4's by {logit_err}")

    pipe = s["pipe"]
    pipe.predict_features({k: v[:B] for k, v in s["batch"].items()})  # warm-up
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = pipe.predict_features(s["batch"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = {name: f.launches for name, f in counters.items()}
    want = {"fused_bias_attention": 12, "materialize_bias": 0, "flash_attention_packed": 0}
    for name, per_batch in want.items():
        check(launches[name] == per_batch * N_BATCHES,
              f"{name}: {launches[name]} launches in {N_BATCHES} batches")
    n_docs = N_BATCHES * B
    same = [a["exit_name"] == b["exit_name"] for a, b in zip(results, s["results"])]
    check(len(results) == n_docs and all(x for x, f in zip(same, far.tolist()) if f),
          "the fused-bias Pipeline's exits differ from phase 4's away from the thresholds")
    ms, base = device_ms(lambda: pipe.predict_features(s["batch"]),
                         {"attention": ("fwd_kernel<",)}), s["device_ms"]
    print(f"served with MMEE_FUSED_BIAS=1: full-capacity exits equal phase 4's for "
          f"{int(far.sum())}/{n_docs} documents farther than 1e-2 from every threshold "
          f"({int(agree.sum())}/{n_docs} in all), logit max diff {logit_err:.3e}; Pipeline: "
          f"{n_docs / dt:.1f} docs/sec (phase 4: {s['docs_per_sec']:.1f}), exits equal "
          f"phase 4's for {sum(same)}/{n_docs} documents, launches {launches}, peak memory "
          f"{peak_mb:.1f} MiB (phase 4: {s['peak_mb']:.1f} MiB); one more call traced: "
          f"{ms['all']:.3f} device ms per {N_BATCHES} batches, the fused attention "
          f"{ms['attention']:.3f} (phase 4: {base['all']:.3f}, the attention "
          f"{base['attention']:.3f} + the bias build {base['bias']:.3f})")
    return launches


def phase_tiny(card: str):
    """Phase 4t: the tiny config (4 heads of 16: the kernels take the head
    dim zero-padded to 64) served and trained on the card, gated against
    the f32 plain path on the CPU."""
    from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig
    from multi_modal_early_exit_tpu_torch.data.features import HashWordTokenizer
    from multi_modal_early_exit_tpu_torch.data.images import preprocess_images
    from multi_modal_early_exit_tpu_torch.models.ee.model import ee_forward, init_ee_params
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import (
        EEModelConfig,
        LayoutLMv3Config,
    )
    from multi_modal_early_exit_tpu_torch.serving import Pipeline
    from multi_modal_early_exit_tpu_torch.training.subgraphs import (
        exit_loss_weights,
        subgraph_param_counts,
    )
    from multi_modal_early_exit_tpu_torch.training.trainer import EETrainer, TrainingArguments

    cfg = EEModelConfig(
        backbone=LayoutLMv3Config.tiny(num_labels=16),
        exit=ExitConfig(exits="text_avg,1", training_strategy="one_stage_subgraphs_weighted"),
    )
    bb = cfg.backbone
    head_dim, layers = bb.hidden_size // bb.num_attention_heads, bb.num_hidden_layers
    model32 = init_ee_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(2)
    tok = HashWordTokenizer(vocab_size=bb.vocab_size)
    n_batches, seq = 2, 32
    feats, pages = synthetic_pages(n_batches * B, rng, tok, seq)
    data = {k: torch.from_numpy(v) for k, v in feats.items()}
    data["pixel_values"] = preprocess_images(torch.from_numpy(pages).cuda(),
                                             size=bb.input_size).cpu()
    keys = ("input_ids", "bbox", "pixel_values", "attention_mask")
    counters = train_counters()
    readings = []
    with torch.no_grad():
        cpu_logits = ee_forward(model32, cfg, *[data[k][:B] for k in keys]).policy_logits()
    for dtype in (torch.float32, torch.bfloat16):
        model = copy.deepcopy(model32).to("cuda", dtype)
        with torch.no_grad():
            got = ee_forward(model, cfg, *[data[k][:B].cuda() for k in keys])
            got = got.policy_logits().float().cpu()
        err = (got - cpu_logits).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"tiny config: non-finite {dtype} logits")
        if dtype == torch.float32:
            check(f32_close(got, cpu_logits), f"tiny config f32 kernel path vs f32 plain path: "
                  f"{err} (atol 2e-4, rtol 1e-3)")
        else:
            check(bf16_close(err, cpu_logits), f"tiny config bf16 kernel path: {err}")
        pipe = Pipeline(model, cfg, batch_size=B, tokenizer=tok, device="cuda")
        before = launch_counts()
        results = pipe.predict_features(data)
        ran = {n: c - before[n] for n, c in launch_counts().items() if c > before[n]}
        want = {"materialize_bias": n_batches, "flash_attention_packed": layers * n_batches}
        if dtype == torch.float32:
            want["split_bf16x3"] = layers * n_batches
        check(ran == want, f"tiny config {DTYPE_NAMES[dtype]} serving launched {ran}, not {want}")
        check(len(results) == n_batches * B and all(
            0.0 <= r["confidence"] <= 1.0 and r["label_id"] in range(16) for r in results),
            "tiny config: malformed results")
        readings.append(f"{DTYPE_NAMES[dtype]} logits max diff {err:.3e}")
    # one bf16 training step, then the f32 gradients against the CPU's
    batch = {k: v[:B][None].cuda() for k, v in data.items()}
    batch["labels"] = torch.from_numpy(rng.integers(0, 16, B))[None].cuda()
    trainer = EETrainer(cfg, copy.deepcopy(model32), TrainingArguments(bf16=True,
                        learning_rate=2e-5), total_steps=10, device="cuda")
    probe = trainer.model.backbone.encoder.layers[0].attention.query.weight.detach().clone()
    before = launch_counts()
    loss = trainer.train_step(batch, torch.Generator().manual_seed(1))[0]
    torch.cuda.synchronize()
    ran = {n: c - before[n] for n, c in launch_counts().items() if c > before[n]}
    want = {"materialize_bias": 1, "table_grads": 2, "flash_attention_packed_train": layers,
            "flash_attention_packed_train_bwd": 2 * layers}
    check(ran == want, f"tiny config training step launched {ran}, not {want}")
    check(math.isfinite(loss), f"tiny config: loss {loss}")
    check(not torch.equal(probe, trainer.model.backbone.encoder.layers[0].attention.query
                          .weight.detach()), "tiny config: the step moved no query weight")
    weights = exit_loss_weights(subgraph_param_counts(model32, cfg))
    train_gradient_check(cfg, model32, batch, weights, dtype=None, limits=TINY_GRAD_LIMITS)
    print(f"tiny config (head dim {head_dim}, {layers} layers) on the card: served "
          f"{n_batches} batches of {B} in f32 and bf16 ({'; '.join(readings)}, tol f32 atol 2e-4 "
          f"/ rtol 1e-3, bf16 5% of scale + 0.05), one bf16 training step (loss {loss:.4f}), "
          f"launches per step {ran}, on {card}")


def train_setup(n_batches: int, scan_fold: int = 12, remat: bool = False,
                attn_dropout=None):
    """The training path's configuration (the JAX package's train benchmark:
    one_stage_subgraphs_weighted, bf16 forward over f32 master weights,
    lr 2e-5, every layer in one step unless ``scan_fold`` says otherwise,
    ``gradient_checkpointing`` = ``remat``, the attention dropout rate 0.1
    unless ``attn_dropout`` is given), its f32 model on the CPU (random
    weights from seed 0) and ``n_batches`` batches of 16 synthetic documents
    on the card, each array shaped (1, 16, ...)."""
    from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig
    from multi_modal_early_exit_tpu_torch.data.features import HashWordTokenizer
    from multi_modal_early_exit_tpu_torch.data.images import preprocess_images
    from multi_modal_early_exit_tpu_torch.models.ee.model import init_ee_params
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import (
        EEModelConfig,
        LayoutLMv3Config,
    )
    from multi_modal_early_exit_tpu_torch.training.trainer import TrainingArguments

    backbone = LayoutLMv3Config.base(num_labels=16).replace(
        scan_fold=scan_fold, gradient_checkpointing=remat)
    if attn_dropout is not None:
        backbone = backbone.replace(attention_probs_dropout_prob=attn_dropout)
    cfg = EEModelConfig(
        backbone=backbone,
        exit=ExitConfig(exits="text_avg,vision_avg,7",
                        training_strategy="one_stage_subgraphs_weighted"),
    )
    model32 = init_ee_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    tok = HashWordTokenizer(vocab_size=cfg.backbone.vocab_size)
    feats, pages = synthetic_pages(n_batches * B, rng, tok, S_TEXT)
    data = {k: torch.from_numpy(v).cuda() for k, v in feats.items()}
    data["pixel_values"] = preprocess_images(torch.from_numpy(pages).cuda(), size=224)
    data["labels"] = torch.from_numpy(rng.integers(0, 16, n_batches * B)).cuda()
    batches = [{k: v[i * B:(i + 1) * B][None] for k, v in data.items()}
               for i in range(n_batches)]
    args = TrainingArguments(bf16=True, learning_rate=2e-5)
    return cfg, model32, batches, args


def loss_grads(model, cfg, batch, weights, device, dtype, rng=None):
    """(loss, gradients) of ``ee_loss_fn`` on the first 2 documents of a
    training batch, on ``device`` in the compute dtype ``dtype``, the
    dropout seeds from ``rng`` (none: no dropout)."""
    from multi_modal_early_exit_tpu_torch.training.losses import ee_loss_fn

    small = {k: v[0, :2].to(device) for k, v in batch.items()}
    loss, _ = ee_loss_fn(model, cfg, small, rng=rng, exit_weights=weights.to(device),
                         compute_dtype=dtype, device=device)
    params = [p for _, p in model.named_parameters()]
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.item(), [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]


def train_gradient_check(cfg, model32, batch, weights, reference=None, dtype=torch.bfloat16,
                         limits=GRAD_LIMITS):
    """The gradients of one loss on 2 documents at dropout 0: the kernel
    path on the card in the compute dtype ``dtype`` (None: the parameters'
    f32) against the f32 plain path on the CPU, gated by ``limits``. The
    CPU reference is computed once: pass the returned one back to reuse it.
    Returns (the reference, the card's (loss, gradients))."""
    rates = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                 classifier_dropout=0.0)
    cfg0 = cfg.replace(backbone=cfg.backbone.replace(**rates))

    def grads(model, device, dtype):
        return loss_grads(model, cfg0, batch, weights, device, dtype)

    if reference is None:
        t0 = time.perf_counter()
        reference = (*grads(model32, "cpu", None), time.perf_counter() - t0)
    cpu_loss, cpu_grads, t_cpu = reference
    gpu_model = copy.deepcopy(model32).cuda()
    gpu_loss, gpu_grads = grads(gpu_model, "cuda", dtype)
    del gpu_model
    names = [n for n, _ in model32.named_parameters()]
    tag = "f32" if dtype is None else DTYPE_NAMES[dtype]
    summary = gradient_gate(names, gpu_loss, gpu_grads, cpu_loss, cpu_grads,
                            f"{tag} kernel-path gradients vs the f32 plain path", limits)
    print(f"train reference: {tag} kernel path vs f32 plain path (CPU, {t_cpu:.1f} s), "
          f"2 documents, dropout 0, scan_fold={cfg.backbone.scan_fold}: {summary}")
    # kept on the host, so that they are not part of the steps' peak memory
    return reference, (gpu_loss, [g.cpu() for g in gpu_grads])


def gradient_gate(names, loss, grads, ref_loss, ref_grads, what, limits=GRAD_LIMITS):
    """Raises unless ``grads`` agree with ``ref_grads``: the loss within
    2e-2, the relative L2 of all gradients within 5e-2, and the worst error
    of one tensor over its own scale within ``limits`` by group. Returns a
    summary of the readings."""
    diff = sum(((a.cpu() - b.cpu()).square().sum() for a, b in zip(grads, ref_grads)))
    ref = sum((b.cpu().square().sum() for b in ref_grads))
    rel_l2 = math.sqrt(diff.item() / ref.item())
    big = max(b.abs().max().item() for b in ref_grads)
    # each tensor's max error over its own largest gradient: every tensor
    # above 1e-2 of the largest gradient (with or without the tables), and
    # by name the tensors that the training kernels' backward feeds alone
    # (the rel-pos tables, through table_grads) or first (the q/k/v
    # projections, through dq/dk/dv)
    table = lambda n: n.endswith(REL_POS_TABLES)  # noqa: E731
    every = {"tensors": lambda n: True, "tensors but the tables": lambda n: not table(n),
             "rel-pos tables": table, "q/k/v weights": lambda n: n.endswith(QKV_WEIGHTS)}
    groups = {g: every[g] for g in limits}
    worst = {g: (0.0, "") for g in groups}
    for n, a, b in zip(names, grads, ref_grads):
        e = scaled_err(a.cpu(), b.cpu())
        for g, member in groups.items():
            if member(n) and (not g.startswith("tensors") or b.abs().max().item() >= 1e-2 * big):
                worst[g] = max(worst[g], (e, n))
    check(all(worst[g][1] for g in groups), f"a gradient group is empty: {worst}")
    check(all(bool(torch.isfinite(g).all()) for g in grads), f"{what}: non-finite grads")
    check(all(g.dtype == torch.float32 for g in grads), "mixed precision: grads not f32")
    check(abs(loss - ref_loss) <= 2e-2 * abs(ref_loss), f"loss {loss} vs {ref_loss}")
    check(rel_l2 <= 5e-2, f"{what}: relative L2 {rel_l2}")
    for g, limit in limits.items():
        check(worst[g][0] <= limit, f"{what}: {worst[g][1]} at {worst[g][0]} of its scale "
              f"> {limit}")
    return (f"loss {loss:.6f} vs {ref_loss:.6f}, gradient relative L2 {rel_l2:.3e} "
            f"(tol 5e-2); worst error over its tensor's scale: "
            + ", ".join(f"{g} {worst[g][1]} {worst[g][0]:.3e} (tol {limits[g]})"
                        for g in groups)
            + " (tensors: those above 1e-2 of the largest gradient)")


# the device-time groups of phases 5 and 5b's traced step: the attention
# backward (the chained pair, or the tables backward's three kernels) and
# table_grads
TRACE_5 = {"attention backward": ("bwd_dq_kernel", "bwd_dkv_kernel"),
           "table_grads": ("table_grads_kernel",)}
TRACE_5B = {"attention backward": ("bwd_dq_kernel", "bwd_dkv_kernel", "table_partials_sum_kernel")}


def train_counters():
    """The launch counters of the kernels a training step can run, by the
    name of the kernel (the head-form pair under their wrappers' names)."""
    from multi_modal_early_exit_tpu_torch.ops import flash_attention as fa
    from multi_modal_early_exit_tpu_torch.ops import fused_bias_attention as fba

    return {"materialize_bias": fba.materialize_bias, "table_grads": fba.table_grads,
            "flash_attention_packed": fa.flash_attention_packed,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "flash_attention_packed_train": fa.flash_attention_packed_train_fwd,
            "flash_attention_packed_train_bwd": fa.flash_attention_packed_train_bwd,
            "flash_attention_packed_train_tables_bwd":
                fa.flash_attention_packed_train_tables_bwd,
            "split_bf16x3": fa.split_bf16x3}


def train_steps(cfg, model32, batches, args, want, trace=None):
    """One warm-up ``EETrainer.train_step``, then one on each further batch,
    timed, with the launch counts per step checked against ``want`` (every
    kernel it does not name: 0). With ``trace`` (groups of kernel-name
    fragments, as ``device_ms`` takes them), one more step on the last batch
    under torch.profiler: the device ms by group and of all kernels. Returns
    the readings."""
    n_steps = len(batches) - 1
    from multi_modal_early_exit_tpu_torch.training.trainer import EETrainer

    counters = train_counters()
    trainer = EETrainer(cfg, copy.deepcopy(model32), args, total_steps=1000, device="cuda")
    gen = torch.Generator().manual_seed(1)
    t0 = time.perf_counter()
    warm = trainer.train_step(batches[0], gen)[0]
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    probe = {n: p.detach().clone() for n, p in trainer.model.named_parameters()
             if n.endswith(("layers.0.attention.query.weight", "rel_pos_bias",
                            "classifier.out_proj.weight", "visual.patch_embed.weight"))}
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [trainer.train_step(b, gen)[0] for b in batches[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = {name: f.launches for name, f in counters.items()}
    check(all(math.isfinite(x) for x in [warm] + losses), f"non-finite losses {losses}")
    moved = [n for n, before in probe.items()
             if not torch.equal(before, dict(trainer.model.named_parameters())[n].detach())]
    check(len(moved) == len(probe), f"parameters that did not move: {set(probe) - set(moved)}")
    for name in counters:
        check(launches[name] == want.get(name, 0) * n_steps,
              f"{name}: {launches[name]} launches in {n_steps} steps")
    traced = device_ms(lambda: trainer.train_step(batches[-1], gen), trace) if trace else {}
    return dict(warm=warm, losses=losses, t_warm=t_warm, dt=dt, peak_mb=peak_mb,
                launches=launches, docs_per_sec=n_steps * B / dt, traced=traced)


def phase_train(card: str):
    """The training path: ``EETrainer.train_step`` on the card (``card``:
    its name and power limit, for the report). Returns (launches, the state
    that phase 5b reuses)."""
    from multi_modal_early_exit_tpu_torch.training.subgraphs import (
        exit_loss_weights,
        subgraph_param_counts,
    )

    cfg, model32, batches, args = train_setup(TRAIN_STEPS + 1)
    n_params = sum(p.numel() for p in model32.parameters())
    weights = exit_loss_weights(subgraph_param_counts(model32, cfg))
    reference, chained = train_gradient_check(cfg, model32, batches[0], weights)
    # the backward launches two kernels per layer: dq/dbias and dk/dv
    want = {"materialize_bias": 1, "table_grads": 2, "flash_attention_packed_train": 12,
            "flash_attention_packed_train_bwd": 24}
    run = train_steps(cfg, model32, batches, args, want, trace=TRACE_5)
    print(f"trained EE LayoutLMv3-base ({n_params / 1e6:.1f}M f32 master params, bf16 "
          f"forward, dropout {cfg.backbone.hidden_dropout_prob}, {args.learning_rate} lr): "
          f"warm-up step {run['t_warm']:.2f} s, then {TRAIN_STEPS} steps of {B} documents in "
          f"{run['dt']:.3f} s, {run['docs_per_sec']:.1f} train docs/sec (host clock), losses "
          f"{[round(x, 4) for x in [run['warm']] + run['losses']]}, launches "
          f"{run['launches']}, peak memory {run['peak_mb']:.1f} MiB, on {card}")
    trained = dict(cfg=cfg, model32=model32, batches=batches, args=args, weights=weights,
                   reference=reference, chained=chained, run=run)
    return run["launches"], trained


def phase_train_tables(card: str, trained):
    """Phase 5 again with MMEE_TABLE_GRADS=1 (the caller sets it): the
    gradient check against phase 5's CPU reference and against its chained
    gradients on the card, then 1 + 3 steps."""
    t = trained
    cfg, model32 = t["cfg"], t["model32"]
    _, (loss, grads) = train_gradient_check(cfg, model32, t["batches"][0], t["weights"],
                                            t["reference"])
    names = [n for n, _ in model32.named_parameters()]
    summary = gradient_gate(names, loss, grads, *t["chained"],
                            "table-gradient path vs the chained path on the card",
                            CHAINED_LIMITS)
    print(f"train with MMEE_TABLE_GRADS=1, against phase 5's chained gradients on the card, "
          f"same input: {summary}")
    # the tables backward launches three kernels per layer
    want = {"materialize_bias": 1, "flash_attention_packed_train": 12,
            "flash_attention_packed_train_tables_bwd": 36}
    run = train_steps(cfg, model32, t["batches"], t["args"], want, trace=TRACE_5B)
    print(f"trained with MMEE_TABLE_GRADS=1: {beside_phase_5(run, t['run'])}, on {card}")
    base = t["run"]["traced"]
    pair = base["attention backward"] + base["table_grads"]
    print(f"attention backward per step, one traced step each: "
          f"{run['traced']['attention backward']:.3f} device ms with MMEE_TABLE_GRADS=1 (the "
          f"tables backward's three kernels, 12 calls) "
          f"against phase 5's {pair:.3f} (the chained backward {base['attention backward']:.3f} "
          f"+ table_grads {base['table_grads']:.3f}); all kernels {run['traced']['all']:.2f} "
          f"against {base['all']:.2f} device ms, on {card}")
    return run["launches"]


def beside_phase_5(run, base, phase="5") -> str:
    return (f"warm-up step {run['t_warm']:.2f} s, then {len(run['losses'])} steps in "
            f"{run['dt']:.3f} s, {run['docs_per_sec']:.1f} train docs/sec (phase {phase}: "
            f"{base['docs_per_sec']:.1f}), losses "
            f"{[round(x, 4) for x in [run['warm']] + run['losses']]} (phase {phase}: "
            f"{[round(x, 4) for x in [base['warm']] + base['losses']]}), launches "
            f"{run['launches']}, peak memory {run['peak_mb']:.1f} MiB (phase {phase}: "
            f"{base['peak_mb']:.1f} MiB)")


def launch_counts():
    return {name: f.launches for name, f in train_counters().items()}


def phase_train_default(card: str, trained):
    """Phase 5c: the JAX package's default schedule, ``scan_fold=1``, at
    attention dropout 0: the gradient check, whose launches show that it
    ran ``flash_attention_packed`` and the head-form pair in every layer,
    against phase 5's CPU reference and its chained gradients on the card,
    then 1 + 3 steps. Returns (launches, the check's (loss, gradients), the steps'
    readings)."""
    t = trained
    cfg = t["cfg"].replace(backbone=t["cfg"].backbone.replace(
        scan_fold=1, attention_probs_dropout_prob=0.0))
    model32 = t["model32"]
    before = launch_counts()
    _, (loss, grads) = train_gradient_check(cfg, model32, t["batches"][0], t["weights"],
                                            t["reference"])
    ran = {name: n - before[name] for name, n in launch_counts().items() if n > before[name]}
    want = {"materialize_bias": 1, "table_grads": 2, "flash_attention_packed": 12,
            "flash_attention_fwd": 12, "flash_attention_bwd": 24}
    check(ran == want, f"the scan_fold=1 gradient check launched {ran}, not {want}")
    names = [n for n, _ in model32.named_parameters()]
    summary = gradient_gate(names, loss, grads, *t["chained"],
                            "scan_fold=1 vs the chained path on the card", UNCHAINED_LIMITS)
    print(f"train with scan_fold=1, attention dropout 0, against phase 5's chained gradients "
          f"on the card, same input: {summary}")
    run = train_steps(cfg, model32, t["batches"], t["args"], want)
    print(f"trained with scan_fold=1 and attention dropout 0: {beside_phase_5(run, t['run'])}, "
          f"on {card}")
    return run["launches"], (loss, grads), run


def phase_train_remat(card: str, trained, default):
    """Phase 5d: bench.py's remat schedule, ``scan_fold=1`` with
    ``gradient_checkpointing``, dropout 0.1: the two gradient checks, the
    check's gradients against phase 5c's (``default``: the same schedule
    without checkpointing) bit for bit, the same at dropout 0.1 with the
    same seeds, then 1 + 3 steps."""
    t = trained
    cfg = t["cfg"].replace(backbone=t["cfg"].backbone.replace(
        scan_fold=1, gradient_checkpointing=True))
    model32, batch, weights = t["model32"], t["batches"][0], t["weights"]
    names = [n for n, _ in model32.named_parameters()]
    _, (loss, grads) = train_gradient_check(cfg, model32, batch, weights, t["reference"])
    summary = gradient_gate(names, loss, grads, *t["chained"],
                            "remat vs the chained path on the card", UNCHAINED_LIMITS)
    print(f"train with gradient_checkpointing, against phase 5's chained gradients on the "
          f"card, same input: {summary}")
    differ = [n for n, a, b in zip(names, grads, default[1]) if not torch.equal(a, b)]
    check(loss == default[0] and not differ,
          f"remat gradients differ from phase 5c's: loss {loss} vs {default[0]}, {differ[:4]}")
    del grads
    # dropout 0.1, seeds from generators seeded alike: with and without
    # checkpointing, on the training kernels
    model = copy.deepcopy(model32).cuda()
    plain = cfg.replace(backbone=cfg.backbone.replace(gradient_checkpointing=False))
    runs = [loss_grads(model, c, batch, weights, "cuda", torch.bfloat16,
                       torch.Generator().manual_seed(3)) for c in (plain, cfg)]
    differ = [n for n, a, b in zip(names, runs[0][1], runs[1][1]) if not torch.equal(a, b)]
    check(runs[0][0] == runs[1][0] and not differ,
          f"at dropout 0.1 the remat gradients differ: {differ[:4]}")
    del model, runs
    print("train with gradient_checkpointing: gradients bit-equal to phase 5c's at dropout 0 "
          "and to the same schedule's without checkpointing at dropout 0.1 (same seeds)")
    # 12 training forwards and 12 recomputed; 12 plain backwards of 2 kernels
    want = {"materialize_bias": 1, "table_grads": 2, "flash_attention_packed_train": 24,
            "flash_attention_packed_train_bwd": 24}
    run = train_steps(cfg, model32, t["batches"], t["args"], want)
    print(f"trained with scan_fold=1 and gradient_checkpointing (dropout "
          f"{cfg.backbone.attention_probs_dropout_prob}): {beside_phase_5(run, t['run'])}, "
          f"on {card}")


def phase_train_f32(card: str, trained, base):
    """Phase 5f: an f32 model trained by ``EETrainer(TrainingArguments(
    bf16=False))`` through the f32 kernels. The gradient check (dropout 0)
    against phase 5's f32 CPU reference with ``F32_GRAD_LIMITS`` at
    ``scan_fold=1`` (``flash_attention_packed`` and the head-form pair) and
    at ``scan_fold=12`` (the training forward, the chained backward and
    ``table_grads``), then 1 + ``F32_TRAIN_STEPS`` steps at the JAX
    package's default schedule (``scan_fold=1``, attention dropout 0.1: the
    training forward and the plain backward), printed beside phase 5c's
    readings ``base``. Returns the launches of the whole phase by kernel."""
    from multi_modal_early_exit_tpu_torch.training.trainer import TrainingArguments

    t = trained
    model32, batch, weights = t["model32"], t["batches"][0], t["weights"]
    total = dict.fromkeys(train_counters(), 0)
    # every f32 forward splits k and v first, every f32 backward q, k, v and
    # do: one split_bf16x3 each
    checks = (
        (1, {"materialize_bias": 1, "table_grads": 2, "flash_attention_packed": 12,
             "flash_attention_fwd": 12, "flash_attention_bwd": 24, "split_bf16x3": 36}),
        (12, {"materialize_bias": 1, "table_grads": 2, "flash_attention_packed_train": 12,
              "flash_attention_packed_train_bwd": 24, "split_bf16x3": 24}),
    )
    for fold, want in checks:
        cfg = t["cfg"].replace(backbone=t["cfg"].backbone.replace(scan_fold=fold))
        before = launch_counts()
        train_gradient_check(cfg, model32, batch, weights, t["reference"], dtype=None,
                             limits=F32_GRAD_LIMITS)
        ran = {name: n - before[name] for name, n in launch_counts().items() if n > before[name]}
        check(ran == want, f"the f32 scan_fold={fold} gradient check launched {ran}, not {want}")
        for name, n in ran.items():
            total[name] += n
    cfg = t["cfg"].replace(backbone=t["cfg"].backbone.replace(scan_fold=1))
    args = TrainingArguments(bf16=False, learning_rate=t["args"].learning_rate)
    # 12 training forwards and 12 plain backwards of 2 kernels (each with a
    # split) per step
    want = {"materialize_bias": 1, "table_grads": 2, "flash_attention_packed_train": 12,
            "flash_attention_packed_train_bwd": 24, "split_bf16x3": 24}
    run = train_steps(cfg, model32, t["batches"][:F32_TRAIN_STEPS + 1], args, want,
                      trace={"forward": ("fwd_kernel<",),
                             "backward": ("bwd_dq_kernel<", "bwd_dkv_kernel<"),
                             "split": ("split_bf16x3_kernel",)})
    for name, n in run["launches"].items():
        total[name] += n
    ms = run["traced"]
    print(f"trained in f32 (TrainingArguments(bf16=False), scan_fold=1, dropout "
          f"{cfg.backbone.attention_probs_dropout_prob}): {beside_phase_5(run, base, '5c')}; "
          f"one more step traced: the f32 attention {ms['forward'] + ms['backward'] + ms['split']:.3f} "
          f"device ms of {ms['all']:.3f} (the forward kernel {ms['forward']:.3f}, the dq/dbias and "
          f"dk/dv kernels {ms['backward']:.3f}, the split pre-passes of both {ms['split']:.3f}), "
          f"on {card}")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # fails here, before any output, when run outside the repository
    import multi_modal_early_exit_tpu_torch  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, card = phase_device()
    phase_build()
    with bias_modes():
        kernels = phase_kernels(name)
    with bias_modes():
        serve_launches, served = phase_main_path()
    with bias_modes(fused="1"):
        fused_launches = phase_serve_fused(served)
    base4 = {k: served[k] for k in ("docs_per_sec", "peak_mb")}
    del served
    with bias_modes():
        serve32_launches = phase_main_path(torch.float32, base4)[0]
    with bias_modes():
        phase_tiny(card)
    with bias_modes():
        train_launches, trained = phase_train(card)
    with bias_modes(tables="1"):
        tables_launches = phase_train_tables(card, trained)
    with bias_modes():
        default_launches, default_grads, default_run = phase_train_default(card, trained)
    with bias_modes():
        phase_train_remat(card, trained, default_grads)
    with bias_modes():
        train32_launches = phase_train_f32(card, trained, default_run)
    default_path = f"{TRAIN_STEPS} training steps, scan_fold=1, attention dropout 0"
    # the split pre-pass runs before every f32 forward and backward
    f32_split = {"split_bf16x3": serve32_launches["split_bf16x3"]
                 + train32_launches["split_bf16x3"]}
    f32_split_in = (f"phase 4f, {N_BATCHES} batches ({serve32_launches['split_bf16x3']}), and "
                    f"phase 5f, 2 gradient checks and {F32_TRAIN_STEPS} steps "
                    f"({train32_launches['split_bf16x3']})")
    # each kernel's launches on the path that runs it
    paths = {
        "flash_attention_fwd": (default_launches, default_path),
        "flash_attention_bwd": (default_launches, default_path),
        "materialize_bias": (serve_launches, f"{N_BATCHES} served batches"),
        "flash_attention_packed": (serve_launches, f"{N_BATCHES} served batches"),
        "fused_bias_attention": (fused_launches,
                                 f"{N_BATCHES} served batches, MMEE_FUSED_BIAS=1"),
        "flash_attention_packed_train": (train_launches, f"{TRAIN_STEPS} training steps"),
        "flash_attention_packed_train_bwd": (train_launches, f"{TRAIN_STEPS} training steps"),
        "table_grads": (train_launches, f"{TRAIN_STEPS} training steps"),
        "flash_attention_packed_train_tables_bwd": (
            tables_launches, f"{TRAIN_STEPS} training steps, MMEE_TABLE_GRADS=1"),
        # f32 only: the paths that run it are phases 4f's and 5f's
        "split_bf16x3": (f32_split, f32_split_in),
    }
    check(len(kernels) == len(paths), f"{len(kernels)} kernels timed, {len(paths)} paths")
    # each kernel's f32 launches: on phase 4f's served batches or in phase
    # 5f (its two gradient checks and its steps); #3 and #9 run in f32 only
    # in phase 3
    f32_paths = {"materialize_bias": (serve32_launches, f"phase 4f, {N_BATCHES} batches"),
                 "flash_attention_packed": (serve32_launches, f"phase 4f, {N_BATCHES} batches"),
                 "split_bf16x3": (f32_split, f32_split_in)}
    f32_train = (train32_launches, f"phase 5f, 2 gradient checks and {F32_TRAIN_STEPS} steps")
    for k in kernels:
        launches, where = paths[k["name"]]
        k["launches"], k["launches_in"] = launches[k["name"]], where
        check(k["launches"] > 0, f"{k['name']} was never launched on its path")
        launches32, where32 = f32_paths.get(k["name"], f32_train)
        k["f32_launches"], k["f32_launches_in"] = launches32.get(k["name"], 0), where32
        only_phase_3 = k["name"] in ("fused_bias_attention",
                                     "flash_attention_packed_train_tables_bwd")
        check((k["f32_launches"] == 0) == only_phase_3,
              f"{k['name']}: {k['f32_launches']} f32 launches in {where32}")
    keys = ("name", "route", "source", "replaces", "launches", "launches_in", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "f32_ms", "f32_bound_ms",
            "f32_bound_by", "f32_library_ms", "f32_max_abs_err", "f32_launches",
            "f32_launches_in", "ok")
    # the fused kernel's rows also carry the pair it replaces
    extra = ("pair_ms", "f32_pair_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys + extra if key in k}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
