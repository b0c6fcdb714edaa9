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
   pair. Then ``add_layer_norm`` (the residual add and LayerNorm of the
   no-grad path) at a served b64 batch's 49,152 rows of 768, bf16 and f32,
   against the composed chain it replaces, both timed, beside its bytes
   bound. Then ``swiglu_weigh`` and ``combine_pairs`` (Moonlight's expert
   layer either side of its down product) at one full pass of its routed
   experts, 98,304 pairs of F = 1,408 and H = 2,048, bf16: within 1 ulp of
   the f32 function and of the composed sum, both timed beside the composed
   chains they replace and their bytes bounds; ``swiglu_weigh`` also
   unweighted at 16,384 tokens of F = 2,816 and 11,264 (the shared experts
   and layer 0), within 1 ulp of the f32 function. Then ``page_attention``
   (MoonViT's attention within each page of a packed batch, 16 heads of 72,
   bf16) on q/k/v at the tower's strides: 16 pages drawn as
   ``kimivl-serve-b16`` draws them, one page of 4,096 patches and ragged
   pages (``VL_RAGGED``), within ``PAGE_ATTN_TOL`` of its plain version,
   the same bits on a second run, PyTorch's ``varlen_attn`` (which the port
   no longer calls) read against the same plain version; timed at the first
   two beside the plain version, ``varlen_attn`` and the bound. Then the
   KDA kernels at one served Kimi-Linear layer (4 documents right-padded to
   16,384, 32 heads of 128): the core ``kda`` within ``KDA_TOL`` of
   ``kda_chunked_plain`` at two served draws (``KDA_SEEDS``: 50,786 and
   35,481 real tokens), each also timed launch by launch (one profiled
   call); ``short_conv`` (as q, k and v), ``kda_gate`` and
   ``gated_rms_norm`` within ``ELEMENTWISE_TOL`` of their plain versions;
   each the same bits on a second run, timed beside its plain version and
   its bound. Then the kernels whose
   bodies depend on the head dim (the forwards #2, #3, #5, #7, the
   backwards #6, #8, #9 and the split pre-pass) at head dim 128 (the same
   bias inputs in 6 heads of 128, hidden 768, S = P = 768), bf16 and f32,
   against their plain versions at
   the same tolerances, the same bits on a second run, the fused kernel
   bit-equal to its pair, each timed beside SDPA at D = 128 and its bound;
   then the same in the kernels' wide mode at D = 192 (4 heads), 256 (3) and
   320 (2) (``WIDE_DIMS``: untimed at S = 709 inside P = 768 at 192, then at
   S = P = 768 at each, timed beside SDPA at the same D);
4. serving path: EE LayoutLMv3-base (exits text_avg, vision_avg, 7; random
   weights from a seed, bf16) served through ``Pipeline.predict_features``
   at batch 16 with capacities (16, 8), from word features and uint8 page
   images normalised on the card. Checks: well-formed results and finite
   logits; launch counts of one bias build, 12 attention calls and 27
   ``add_layer_norm`` calls (``V3_NORMS``) per batch, as the wrappers
   tally them and as the traced call below counts the kernels the card
   ran (the cascade's replayed CUDA graphs); at full capacity the cascade's exits equal ``decide_exits(ee_forward())``
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
   ``fused_bias_attention`` and 27 ``add_layer_norm`` launches and no bias
   build or attention launch per batch, tallied and counted in the trace; exits equal phase 4's for the documents away from the
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
   which the kernels take zero-padded to their 64), then the same with
   hidden 384 in 4 heads of 96 (padded to 128), hidden 512 in 4 heads of
   128, and in the wide mode hidden 384 in 2 heads of 192 and 512 in 2
   heads of 256: each serves 2 batches of 16 through ``Pipeline.predict_features``
   in f32 and in bf16 and takes one ``EETrainer`` step in bf16. Checks: the
   launch counts (every attention call in the kernels); the f32 kernel
   path's logits within the north star's f32 bars of the f32 plain path on
   the CPU, and its f32 gradients within ``TINY_GRAD_LIMITS``; bf16 logits
   within the bf16 tolerance; a finite loss and parameters that moved.
6. anytime evaluation (after 4b, on phase 4's bf16 model): ``get_logits``
   harvests the exit logits of ``build_synthetic``'s test and validation
   splits (256 documents each, 512 tokens, 224-pixel pages, 16 labels) at
   batch 16 into a temporary directory. Checks: a finite (4, 256, 16)
   float64 store, two batches' rows bit-equal to ``ee_forward``'s policy
   logits, 1 ``materialize_bias`` and 12 ``flash_attention_packed`` launches
   per batch; the f32 model's harvest of 8 documents within the f32 bars of
   the f32 plain path on the CPU, its exits equal away from the threshold;
   finite, positive temperatures from ``calibrate``; 19 thresholds from
   ``full_test_iteration`` and ``evaluate_checkpoint``'s ``results.json``;
   a million-mixture ``mixture_pareto_sweep`` bit-equal between the torch
   backend on the card and the native one. Prints the harvest's docs/sec,
   one traced batch's device ms and both sweeps' seconds.
4m. early-exit Moonlight (after 6) at its published widths (hidden 2,048;
   64 routed experts of 1,408, 6 a token; the shared experts' 2,816;
   layer 0's dense 11,264), 3 layers deep, exits after layers 1 and 2,
   random weights from a seed, bf16, served as ``moonlight-serve-b32``
   serves it: ``Pipeline.predict_features`` over the cascade's
   ``CascadeStages.layers``, 2 batches of 8 documents of 512-2,048 tokens,
   a threshold no document meets (every stage runs every row). The launch
   counts are read from those batches alone: 5 ``swiglu_weigh`` and 2
   ``combine_pairs`` a batch, every MLP row through the kernels (the
   composed chains never called). Each MLP call on the way
   (layer 0's, and each expert layer's routed and shared experts) is
   recomputed by the plain versions of ``ops.moe_pairs`` on its own
   inputs: relative L2 within ``MOON_TOL``, which a zeroed MLP (1.0) and
   the routed experts without their weights (printed, checked above it)
   fail.
4v. early-exit Kimi-VL (after 4m): the vision tower and projector at their
   published widths (hidden 1152, 16 heads of 72, MLP 4,304, the projector
   to 2,048) in front of Moonlight's decoder at its own, both 3 layers
   deep, exits 1 and 2, random weights from a seed, bf16, served as
   ``kimivl-serve-b16`` serves it: ``Pipeline.predict_features`` with
   ``pixel_values`` and ``image_grid_hws`` (the cascade runs the tower in
   ``KimiVLStages.embed``), 2 batches of 16 pages drawn as the cell draws
   them, a threshold no page meets. The launch counts are read from those
   batches alone: 3 ``page_attention`` a batch, and the MLP kernels as in
   phase 4m. Each ``page_attention`` call on the way is recomputed by
   ``page_attention_plain`` on its own inputs: error over scale within
   ``PAGE_ATTN_TOL``, which the plain attention over each two neighbouring
   pages merged (printed, checked above it) fails.
4k. early-exit Kimi-Linear (after 4v) at its published widths (hidden
   2,304; KDA in 32 heads of 128 behind width-4 convolutions; MLA in 32
   heads without rotary; 128 of the 256 routed experts of 1,024 held, 8 a
   token; layer 1's dense 9,216), one whole period of 4 layers (KDA, KDA,
   KDA, MLA), exits 1 and 2, random weights from a seed, bf16, served as
   ``kimilinear-serve-b4`` serves it: ``Pipeline.predict_features`` over
   ``KimiLinearStages.layers``, 2 batches of 4 documents of 4,096-16,384
   tokens right-padded to 16,384, a threshold no document meets. The
   launch counts are read from those batches alone: a KDA layer's 2
   ``kda``, 3 ``short_conv``, 1 ``kda_gate`` and 1 ``gated_rms_norm``, and
   the MLP kernels as in phase 4m. Each ``kda`` call on the way is
   recomputed by ``kda_chunked_plain`` on its own inputs (error over scale
   within ``KDA_TOL``), each elementwise kernel's call by its plain version
   (within ``ELEMENTWISE_TOL``), and each expert layer's held share
   (``swiglu_weigh`` and ``combine_pairs`` given ``held``) by the plain
   versions (relative L2 within ``MOON_TOL``, which the share without its
   weights misses). Phase 3's rows ``kda``, ``short_conv``, ``kda_gate``
   and ``gated_rms_norm`` time the kernels at one served layer's 4
   documents beside their plain versions and bounds.
7. the command-line path at full width (after every earlier phase), in a
   temporary directory that it removes: ``cli.train.main`` on
   ``CLI_TRAIN`` (EE LayoutLMv3-base, random weights, bf16, batch 16, 2
   epochs of 4 steps at the default schedule, a checkpoint per epoch);
   a trainer resumed from a checkpoint saved with its optimizer state and
   step; 2 steps with ``bf16_momentum``; ``cli.evaluate.main`` on the best
   checkpoint (dump, then ``--full_test --calibrate``); ``cli.research.main``
   over the dump (10^6 mixtures, torch and native backends);
   ``Pipeline.from_checkpoint``. Checks: finite losses; per step 1
   ``materialize_bias``, 2 ``table_grads``, 12 training forwards and 12
   plain backwards (24 kernels); two checkpoints with their config.json;
   the test metrics' keys (the JAX package's); the resumed trainer's
   parameters bit-equal to those of one that kept going; bf16 first
   moments; a finite float64 (4, 32, 16) store, finite positive
   temperatures, one sweep result per threshold, 1 ``materialize_bias``, 12
   ``flash_attention_packed`` and 12 ``split_bf16x3`` launches per
   harvested batch (the checkpoint's f32 weights); the two
   Pareto fronts bit-equal; ``from_checkpoint``'s predictions bit-equal to
   an in-memory ``Pipeline``'s, its backbone config the trained model's.
   Prints each step's seconds, train docs/sec, the peak memory with the
   bf16 and the f32 first moment, and the CLIs' seconds.

8. the model variants and the anytime engine at full width (after phase 7):
   8a. LayoutLMv2-base (12 layers, hidden 768, 12 heads x 64, the
   ResNeXt-101 32x8d FPN tower at 224 pixels, 512 text + 49 visual tokens,
   16 labels; random weights from ``build_model``'s seed): first its five
   kernels against their plain versions at its shapes (``compare_path_kernels``:
   batch 16, S = 561 inside P = 640, the model's unscaled tables, phase 3's
   tolerances); ``get_logits``
   harvests 64 synthetic documents in bf16 at batch 16 (561 tokens padded to
   640); ``cli.train.main`` with ``model=layoutlmv2`` (1 epoch, 1 + 3 steps,
   bf16, dropout 0.1, batch 16). Checks: a finite (1, 64, 16) float64 store,
   two batches bit-equal to ``forward_sequence_classification``, 1
   ``materialize_bias``, 12 ``flash_attention_packed`` and 26
   ``add_layer_norm`` launches a batch;
   the f32 model's logits on 4 documents within atol 2e-4 / rtol 1e-3 of the
   f32 plain path on the CPU; finite losses, parameters that moved, per step
   1 ``materialize_bias``, 2 ``table_grads``, 12 training forwards and 12
   plain backwards (24 kernels); the gradients of one loss on 2 documents
   at dropout 0 against the f32 plain path on the CPU: bf16 on the card
   within phase 5's relative L2 bar (5e-2) over every tensor and
   ``GRAD_LIMITS`` over every tensor outside the visual tower, f32 on the
   card within ``F32_GRAD_LIMITS`` outside the tower (the tower's worst
   tensor printed: bf16 on the card and on the CPU, f32 on the card).
   Prints the harvest's docs/sec, one
   traced batch's device ms (the visual tower traced alone, the attention,
   the rest), the steps' seconds and the peak memory.
   8b. ``AnytimeEngine`` on phase 4's bf16 model and 64 documents (kept on
   the host since phase 6) in batches of 32, buckets (8, 16, 32), after its
   two kernels against their plain versions at its largest bucket (32, S =
   709 inside P = 768). Checks:
   exits equal ``decide_exits(ee_forward())`` away from the threshold, the
   ``collect_store`` store against ``ee_forward``'s policy logits, patience
   at t = 2 equal to the offline patience policy of the engine's store, per
   stage 1 ``materialize_bias`` and one ``flash_attention_packed`` per layer
   on the bucket of its survivors. Prints its docs/sec beside the
   full-capacity cascade ``Pipeline``'s on the same batches.

9. the parallel layer (after phase 8), with several ranks sharing this card
   (their collectives go through the host, so nothing here measures
   scaling). First, in this process, the kernels of the meshes' paths
   against their plain versions at a rank's shapes (``compare_path_kernels``,
   phase 3's tolerances): a (2, 2) rank's training batch, 8 of phase 5's
   documents (S = 709 inside P = 768) at 6 heads of 64 (a 384-wide packed
   row) with model rank 1's columns of the tables (#1, #2, #7, #8, #4), and
   9d's second stage, 4 documents at 12 heads (#1, #2). 9a a world of one
   rank on NCCL: 2 ``EETrainer`` steps (phase 5's model and batches) under
   a (1, 1) mesh, bit-equal to 2 with no mesh; then one launch of
   ``python -m torch.distributed.run --standalone --nproc-per-node 4
   chip_smoke.py --mesh-cli-rank DIR with mesh_shape=2,2 device=cuda:0 ...``
   with ``MMEE_DIST_BACKEND=gloo`` (``mesh_cli_rank``), four gloo ranks on
   the world and mesh ``cli.train`` sets up, for 9b and 9c: 9b
   ``sharded_flash_attention`` (B 16, H 12, S = P 768, D 64, an f32 bias)
   at mesh (2, 2) in bf16 and f32 and (4, 1) in bf16: at rate 0 each rank's
   output and gradients bit-equal to the unsharded kernels' block (#5, #6),
   at rate 0.1 within phase 3's tolerances of the plain version at the
   shard's seed; 3 steps at (2, 2); 9c phase 5's gradient check (2 documents
   through the CLI's ``step_batch`` and ``EETrainer``'s step, 6 heads a
   rank) against phase 5's f32 CPU reference (``GRAD_LIMITS`` and the
   relative L2), then ``cli.train.main`` (1 + 3 steps) and its resume from
   checkpoint-0 (4 more), each rank's launches per step checked; the last
   checkpoint loads on one device and serves through
   ``Pipeline.from_checkpoint``; 9d two gloo ranks: the cascade per data
   shard (``make_cascade_forward``, as ``Pipeline`` runs it) at capacities
   (8, 4) on phase 5's first batch (heads rescaled as in phase 4), exits
   and capacity flags bit-equal to the single-device cascade run shard by
   shard; 3 steps at (2, 1). The ranks write their launch counts to JSON
   files, which the phase sums (``mesh_launches``: #1, #2, #4, #5, #6, #7
   and #8 each above 0). Prints the step seconds at (1, 1), (2, 1) and
   (2, 2) with the collectives' share of each, and the phase's seconds by
   part.

   ``python3 chip_smoke.py --mesh-cli-rank DIR with ...`` is that launch's
   rank (torchrun sets the rank); with no arguments the script runs every
   phase.

10. the rest of the public surface (after phase 9), imported only through
   the package root and the sub-packages' ``__init__``s, on phase 5's model
   and documents (phase 4's configuration, random weights from seed 0):
   10a ``ee_forward(collect_hidden=True, seq_pad_multiple=128)`` in bf16 at
   batch 16, its logits, exit logits and criteria bit-equal to the call
   without it, ``backbone_apply(collect_hidden=True).hidden_per_layer[-1]``
   bit-equal to its ``last_hidden_state``, 1 ``materialize_bias`` and 12
   ``flash_attention_packed`` launches a call; the f32 model on 2 documents
   against the f32 plain path on the CPU, every layer's state within atol
   5e-4 / rtol 1e-3, the policy logits within atol 2e-4 / rtol 1e-3; 10b
   one bf16 step of two ``EETrainer``s from one state, one given every
   ``TrainingArguments`` field (``SURFACE_ARGS``), bit-equal losses and
   parameters and phase 5's launches; 10c the HF exporter's round trip on
   the bf16 card model, bit-equal, the importer reading exactly the keys
   the exporter wrote; 10d ``prefetch_to_device(buffer_size=k)`` for k = 1,
   2, 3 giving the same batches, ``native.sweep.available()``, and
   ``cli.train`` and ``EETrainer`` refusing ``dit``, ``dit_rvl`` and
   ``bert``, named, before any launch. Prints a ``{"public_surface": ...}``
   line with the readings and the phase's seconds by part.

Every phase runs with MMEE_CHAINED_DBIAS and MMEE_LAYERS_PER_STEP unset and
phases 4, 4f, 4t, 5, 5c, 5d, 5f, 6, 7, 8, 9 and 10 with the two bias switches unset, whatever the
environment says; 4b and 5b set theirs and restore it.

The next-to-last line is a JSON object with one entry per kernel (its
launches counted on the path that runs it; the f32 fields from phase 3's
f32 run and the f32 launches from phases 4f/5f; ``split_bf16x3`` runs in
f32 only, on phases 4f's and 5f's paths; the ``_d128`` fields from phase
3's head-dim-128 run, the ``_wide`` fields (keyed by D) from its wide-mode
runs; the anytime harvest's launches of the two kernels it runs from phase
6, the command-line path's (``cli_launches``) from phase 7, LayoutLMv2's
(``v2_launches``) and the engine's (``engine_launches``) from phase 8, the
meshes' (``mesh_launches``, over every rank) from phase 9), the last
``{"ok": true, "device": {...}}``. Every failed check raises, so the script
exits non-zero; it needs a CUDA device and the repository's package.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import pathlib
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
V3_NORMS = 27  # a served batch's LayerNorms: text, vision, concat, 2 in each of 12 layers
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


# the serving path's hand-written kernels by the names the card's trace
# gives them: one forward template serves flash_attention_packed and
# fused_bias_attention
SERVE_KERNELS = {"attention": ("fwd_kernel<",), "bias": ("materialize_bias_kernel",),
                 "split": ("split_bf16x3_kernel",), "norm": ("add_layer_norm_kernel",)}


def device_ms(fn, groups, counted=None):
    """Device ms of one ``fn()`` call under torch.profiler: by group (the
    kernels whose names hold one of the group's fragments), and of all
    kernels (``"all"``); ``"kernels"``: how many kernels of each of
    ``counted``'s groups the card ran, a CUDA graph's replayed kernels
    among them. Fails if a group of ``groups`` ran no kernel on the card."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(groups, 0.0)
    ms["all"] = 0.0
    counts = dict.fromkeys(counted or {}, 0)
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        ms["all"] += us / 1e3
        for group, frags in groups.items():
            if any(frag in e.key for frag in frags):
                ms[group] += us / 1e3
        for group, frags in (counted or {}).items():
            if any(frag in e.key for frag in frags):
                counts[group] += e.count
    if counted:
        ms["kernels"] = counts
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

    kernel_add_layer_norm(bw, results)
    kernel_moe_pairs(bw, results)
    kernel_page_attention(bw, bf16_peak, results)
    kernel_kda(bw, bf16_peak, results)
    kernel_kda_elementwise(bw, results)
    print("kernels: " + ", ".join(f"{e['name']} ok={e['ok']}" for e in results))
    return results


LN_ROWS, LN_WIDTH = 64 * 768, 768  # a served batch of 64 documents, 768 positions each


def bf16_ulps(got, want):
    """|got - want| in bf16 ulps of want, each element's ulp taken at its
    magnitude but not below 1/256 of the tensor's largest (where the f32
    chain's own rounding, not the output's, sets the error)."""
    w, g = want.float(), got.float()
    mag = torch.clamp(w.abs(), min=w.abs().max().item() / 256)
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def kernel_add_layer_norm(bw, results):
    """Phase 3's ``add_layer_norm`` (no TPU kernel: the JAX package leaves
    LayerNorm to XLA) at a served b64 batch's shape, 49,152 rows of 768 with
    a residual, bf16 then f32: against the composed chain it replaces (the
    residual add and the 14-launch f32 LayerNorm, ``add_layer_norm_plain``),
    in bf16 within 1 ulp on 99.9 % of the elements and 2 ulps on every one,
    in f32 within 1e-5 of the output's scale; each timed beside the other
    and beside the bytes bound (x and the residual read once, the output
    written once). Appends the kernel's row (bf16 fields, then ``f32_*``)
    to ``results``."""
    from multi_modal_early_exit_tpu_torch.ops.layer_norm import (
        add_layer_norm,
        add_layer_norm_plain,
    )

    e = dict(name="add_layer_norm", route="cuda",
             source="multi_modal_early_exit_tpu_torch/csrc/add_layer_norm.cu",
             replaces="multi_modal_early_exit_tpu/models/layoutlmv3/modeling.py:63",
             library_ms=None, f32_library_ms=None, ok=True)
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device="cuda").manual_seed(0)
        x = (torch.randn((LN_ROWS, LN_WIDTH), generator=g, device="cuda") * 2 + 0.5).to(dtype)
        r = torch.randn((LN_ROWS, LN_WIDTH), generator=g, device="cuda").to(dtype)
        w = (1 + 0.1 * torch.randn(LN_WIDTH, generator=g, device="cuda")).to(dtype)
        b = (0.1 * torch.randn(LN_WIDTH, generator=g, device="cuda")).to(dtype)
        got, want = add_layer_norm(x, w, b, 1e-5, r), add_layer_norm_plain(x, w, b, 1e-5, r)
        max_abs = (got.float() - want.float()).abs().max().item()
        if dtype == torch.bfloat16:
            ulps = bf16_ulps(got, want)
            within1, worst = (ulps <= 1).float().mean().item(), ulps.max().item()
            check(within1 >= 0.999 and worst <= 2,
                  f"add_layer_norm bf16: {100 * within1:.4f} % of elements within 1 ulp "
                  f"(at least 99.9 %), worst {worst:.3g} ulps (at most 2)")
            err = f"{100 * within1:.4f} % within 1 bf16 ulp, worst {worst:.3g} ulps"
        else:
            rel = scaled_err(got, want)
            check(rel <= 1e-5, f"add_layer_norm f32: error {rel:.3g} over scale (tol 1e-5)")
            err = f"error over scale {rel:.3g}"
        del got, want
        ms = time_ms(lambda: add_layer_norm(x, w, b, 1e-5, r), iters=50)
        plain_ms = time_ms(lambda: add_layer_norm_plain(x, w, b, 1e-5, r), iters=20)
        n_bytes = 3 * x.numel() * x.element_size() + 2 * w.numel() * w.element_size()
        bound_ms, bound_by = bound(n_bytes, 0, bw, 1.0)
        pre = "" if dtype == torch.bfloat16 else "f32_"
        e.update({f"{pre}ms": ms, f"{pre}bound_ms": bound_ms, f"{pre}bound_by": bound_by,
                  f"{pre}max_abs_err": max_abs})
        if dtype == torch.bfloat16:
            e["plain_ms"] = plain_ms
        print(f"kernel add_layer_norm ({LN_ROWS} x {LN_WIDTH}, {dtype}, with a residual): "
              f"{err}, kernel_ms {ms:.4f}, composed_ms {plain_ms:.4f} (15 launches), "
              f"bound {bound_ms * 1e3:.1f} us (bytes), {100 * bound_ms / ms:.1f} % of it")
        del x, r
    results.append(e)


# Moonlight's routed expert layer at its largest pass: 16,384 tokens, 6
# pairs each, experts of width 1,408, hidden 2,048
MOE_TOKENS, MOE_K, MOE_WIDTH, MOE_HIDDEN = 16384, 6, 1408, 2048
# the shared experts' width and layer 0's, which run swiglu_weigh unweighted
MOE_DENSE_WIDTHS = (2816, 11264)


def kernel_moe_pairs(bw, results):
    """Phase 3's ``swiglu_weigh`` and ``combine_pairs`` (no TPU kernel: the
    JAX package runs no expert layer) at one full pass of Moonlight's routed
    experts, 98,304 pairs: ``swiglu_weigh`` on a (pairs, 2 x 1,408) gate-up
    product with f32 routing weights and a random sort, within 1 bf16 ulp
    of the f32 function, its ``inv`` the sort's inverse, and unweighted at
    the widths that run it so (``MOE_DENSE_WIDTHS``: the shared experts',
    layer 0's) over 16,384 tokens, to the same ulp; ``combine_pairs``
    on the (pairs, 2,048) down product, within 1 ulp of the composed
    ``index_copy_`` + f32 sum + cast, the same bits on a second run. Each
    timed beside the composed chain it replaces (``*_plain``) and its bytes
    bound (each row read once and written once). Appends both rows to
    ``results``."""
    from multi_modal_early_exit_tpu_torch.ops.moe_pairs import (
        combine_pairs,
        combine_pairs_plain,
        swiglu_weigh,
        swiglu_weigh_plain,
    )

    pairs = MOE_TOKENS * MOE_K
    g = torch.Generator(device="cuda").manual_seed(0)
    gate_up = (2 * torch.randn((pairs, 2 * MOE_WIDTH), generator=g, device="cuda")).bfloat16()
    weights = torch.rand((pairs,), generator=g, device="cuda") * 0.8
    order = torch.randperm(pairs, generator=g, device="cuda")
    act, inv = swiglu_weigh(gate_up, weights, order)
    gate, up = gate_up.float().chunk(2, dim=-1)
    want = torch.nn.functional.silu(gate) * up * weights[order, None]
    del gate, up
    ulps = bf16_ulps(act, want).max().item()
    check(ulps <= 1, f"swiglu_weigh: {ulps:.3g} bf16 ulps from the f32 function (at most 1)")
    check(torch.equal(inv[order], torch.arange(pairs, dtype=torch.int32, device="cuda")),
          "swiglu_weigh: inv is not the inverse of the sort")
    max_abs = (act.float() - want).abs().max().item()
    del act, want
    # the unweighted instance, at the served widths that run it: the shared
    # experts' 2,816 and layer 0's 11,264, one full pass of tokens each
    unweighted = []
    for width in MOE_DENSE_WIDTHS:
        dense = (2 * torch.randn((MOE_TOKENS, 2 * width), generator=g, device="cuda")).bfloat16()
        act, none = swiglu_weigh(dense)
        gate, up = dense.float().chunk(2, dim=-1)
        want = torch.nn.functional.silu(gate) * up
        del gate, up, dense
        dense_ulps = bf16_ulps(act, want).max().item()
        check(none is None and dense_ulps <= 1,
              f"swiglu_weigh unweighted, F {width}: {dense_ulps:.3g} bf16 ulps from the f32 "
              f"function (at most 1)")
        unweighted.append(f"F {width} {dense_ulps:.3g}")
        del act, want
    rows = []
    ms = time_ms(lambda: swiglu_weigh(gate_up, weights, order), iters=50)
    plain_ms = time_ms(lambda: swiglu_weigh_plain(gate_up, weights, order), iters=20)
    # gate_up read (2 bytes an element), act written (half as many); the
    # weights, the sort and inv, 4 + 8 + 4 bytes a pair
    n_bytes = 3 * gate_up.numel() + 16 * pairs
    rows.append(("swiglu_weigh", ms, plain_ms, n_bytes, max_abs,
                 f"{ulps:.3g} bf16 ulps from the f32 function at most (unweighted, "
                 f"{MOE_TOKENS} tokens: {', '.join(unweighted)})", "SiLU, the products with "
                 "up and the weight, the weights' gather and cast: 5 launches"))
    del gate_up

    out_sorted = torch.randn((pairs, MOE_HIDDEN), generator=g, device="cuda").bfloat16()
    got = combine_pairs(out_sorted, inv, MOE_K)
    plain = combine_pairs_plain(out_sorted, order, MOE_K)
    ulps = bf16_ulps(got, plain).max().item()
    check(ulps <= 1, f"combine_pairs: {ulps:.3g} bf16 ulps from the composed chain (at most 1)")
    check(torch.equal(got, combine_pairs(out_sorted, inv, MOE_K)),
          "combine_pairs: another result on a second run")
    equal = (got == plain).float().mean().item()
    max_abs = (got.float() - plain.float()).abs().max().item()
    del got, plain
    ms = time_ms(lambda: combine_pairs(out_sorted, inv, MOE_K), iters=50)
    plain_ms = time_ms(lambda: combine_pairs_plain(out_sorted, order, MOE_K), iters=20)
    n_bytes = out_sorted.numel() * 2 + pairs * 4 + MOE_TOKENS * MOE_HIDDEN * 2
    rows.append(("combine_pairs", ms, plain_ms, n_bytes, max_abs,
                 f"{ulps:.3g} bf16 ulps from the composed chain at most, {100 * equal:.4f} % "
                 f"bit-equal", "index_copy_, the f32 sum and the cast: 3 launches"))
    del out_sorted

    for name, ms, plain_ms, n_bytes, max_abs, err, chain in rows:
        bound_ms, bound_by = bound(n_bytes, 0, bw, 1.0)
        results.append(dict(
            name=name, route="cuda", source="multi_modal_early_exit_tpu_torch/csrc/moe_pairs.cu",
            replaces="none: the JAX package runs no expert layer (multi_modal_early_exit_tpu_torch/"
                     "models/moonlight/modeling.py::experts_apply)",
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            max_abs_err=max_abs, ok=True))
        print(f"kernel {name} ({pairs} pairs, F {MOE_WIDTH}, H {MOE_HIDDEN}, bf16): {err}, "
              f"kernel_ms {ms:.4f}, plain_ms {plain_ms:.4f} ({chain}), bound "
              f"{bound_ms * 1e3:.1f} us ({bound_by}, {n_bytes / 1e6:.1f} MB), "
              f"{100 * bound_ms / ms:.1f} % of it")


# MoonViT's attention (kimivl-serve-b16's tower): 16 heads of 72 over pages
# drawn as the cell's traffic draws them, one page of the most patches, and
# ragged pages: no multiple of a 128-row tile or a 64-key block, one
# shorter than both, one of a single patch
VL_HEADS, VL_HEAD_DIM, VL_PAGES = 16, 72, 16
VL_TRAFFIC = "h100bench/traffic/serve-vlm-b16.json"
VL_RAGGED = [37, 129, 1000, 64, 65, 127, 1, 200, 4095, 130, 3]
# the kernel's bf16 output against page_attention_plain's on the same
# inputs, the largest error over the output's largest value: on an H100 the
# kernel and PyTorch's varlen_attn each read 4.6e-3 to 1.05e-2 against the
# same plain version (the plain version rounds the normalised p to bf16,
# the kernels the unnormalised one)
PAGE_ATTN_TOL = 2e-2


def vl_grids(seed: int, n: int = VL_PAGES):
    """``n`` pages' patch grids (h, w) as ``kimivl-serve-b16`` draws them
    (``h100bench/entries/serve_vlm.py::page_grids`` on its traffic file)."""
    from h100bench.entries.serve_vlm import page_grids

    mix = json.loads(pathlib.Path(VL_TRAFFIC).read_text())
    return [(int(h), int(w)) for h, w in page_grids(np.random.default_rng(seed), n, mix)]


def vl_operands(lens, seed: int):
    """q and k as views of one (T, 2, 16, 72) bf16 tensor and v of a (T,
    3, 16, 72) one, as the tower's rotary embedding and qkv product give
    them, unit normal; the pages' starts, and as int32 on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    t = int(sum(lens))
    qk = torch.randn((t, 2, VL_HEADS, VL_HEAD_DIM), generator=g, device="cuda").bfloat16()
    qkv = torch.randn((t, 3, VL_HEADS, VL_HEAD_DIM), generator=g, device="cuda").bfloat16()
    starts = [0] + np.cumsum(lens).astype(int).tolist()
    cu = torch.tensor(starts, dtype=torch.int32, device="cuda")
    return qk[:, 0], qk[:, 1], qkv[:, 2], starts, cu


def kernel_page_attention(bw, peak, results):
    """Phase 3's ``page_attention`` (no TPU kernel: the JAX package runs no
    MoonViT; on the port's path it replaced PyTorch's ``varlen_attn``) on
    q, k and v laid out as the tower's views (``vl_operands``): 16 pages
    drawn as ``kimivl-serve-b16`` draws them, one page of 4,096 patches,
    and ``VL_RAGGED``. At each, the kernel's and ``varlen_attn``'s error
    over scale against ``page_attention_plain``, the kernel's within
    ``PAGE_ATTN_TOL``, and the same bits on a second run. At the first two
    the kernel timed beside the plain version, ``varlen_attn`` (the
    library yardstick, which the port does not call) and the bound of one
    layer (``h100bench/kimi_vl.py::vit_attn_cost``: q, k and v read and o
    written once, 4 x 1152 operations a query-key pair). Appends the row:
    the served 16 pages' times, the 4,096-patch page's as ``*_long``."""
    from torch.nn.attention.varlen import varlen_attn

    from multi_modal_early_exit_tpu_torch.ops.page_attention import (
        page_attention,
        page_attention_plain,
    )

    scale = VL_HEAD_DIM ** -0.5
    shapes = {"served": [h * w for h, w in vl_grids(0)], "long": [4096], "ragged": VL_RAGGED}
    e = dict(name="page_attention", route="cuda",
             source="multi_modal_early_exit_tpu_torch/csrc/page_attention.cu",
             replaces="none: the JAX package runs no MoonViT (multi_modal_early_exit_tpu_torch/"
                      "models/kimi_vl/modeling.py::block_apply); it replaced varlen_attn there",
             ok=True)
    worst, worst_lib = 0.0, 0.0
    for label, lens in shapes.items():
        q, k, v, starts, cu = vl_operands(lens, len(lens))
        longest = max(lens)
        got = page_attention(q, k, v, starts, cu, scale)
        torch.cuda.synchronize()
        want = page_attention_plain(q, k, v, starts, scale)
        lib = varlen_attn(q, k, v, cu, cu, longest, longest, scale=scale)
        err, lib_err = scaled_err(got, want), scaled_err(lib, want)
        check(err <= PAGE_ATTN_TOL, f"page_attention, {label} pages {lens}: error over scale "
                                    f"{err:.3g} (tol {PAGE_ATTN_TOL}; varlen_attn {lib_err:.3g})")
        check(torch.equal(got, page_attention(q, k, v, starts, cu, scale)),
              f"page_attention, {label}: another result on a second run")
        worst, worst_lib = max(worst, err), max(worst_lib, lib_err)
        if label == "served":
            e["max_abs_err"] = (got.float() - want.float()).abs().max().item()
        del got, want, lib
        line = f"kernel page_attention ({label}: {len(lens)} pages, {sum(lens)} patches"
        if label != "ragged":
            pairs = sum(n * n for n in lens)
            width = VL_HEADS * VL_HEAD_DIM
            bound_ms, bound_by = bound(4 * sum(lens) * width * 2, 4.0 * pairs * width, bw, peak)
            ms = time_ms(lambda: page_attention(q, k, v, starts, cu, scale), iters=30)
            lib_ms = time_ms(lambda: varlen_attn(q, k, v, cu, cu, longest, longest, scale=scale),
                             iters=30)
            plain_ms = time_ms(lambda: page_attention_plain(q, k, v, starts, scale), iters=3,
                               warmup=1)
            pre = "" if label == "served" else "_long"
            e.update({f"ms{pre}": ms, f"bound{pre}_ms" if pre else "bound_ms": bound_ms,
                      f"bound{pre}_by" if pre else "bound_by": bound_by,
                      f"library_ms{pre}": lib_ms, f"plain_ms{pre}": plain_ms})
            line += (f"): kernel_ms {ms:.4f}, varlen_attn {lib_ms:.4f}, plain_ms {plain_ms:.4f}, "
                     f"bound {bound_ms:.4f} ms ({bound_by}), kernel {100 * bound_ms / ms:.1f} % "
                     f"of it, varlen_attn {100 * bound_ms / lib_ms:.1f} %")
        else:
            line += ")"
        print(f"{line}; error over scale {err:.3g}, varlen_attn's {lib_err:.3g}")
        del q, k, v
    e["err_over_scale"], e["library_err_over_scale"] = worst, worst_lib
    results.append(e)


KLIN_TRAFFIC = "h100bench/traffic/serve-long-b4.json"
KLIN_ROWS, KLIN_HEADS = 4, 32  # a served batch of Kimi-Linear, its KDA heads of 128
# the KDA kernels' bf16 output against kda_chunked_plain on the same inputs,
# error over scale: both round once to bf16; the kernel's state products
# run on tf32 operands (2^-11 of a value). On an H100 it read 3.8e-3 to
# 5.8e-3 (the sub-chunk design of the intra kernel and the wgmma state pass
# read 5.5e-3 at the served shapes, as the design before them); a float8
# core reads 0.10 (the cell's control)
KDA_TOL = 1.2e-2


def klin_lengths(seed: int, n: int = KLIN_ROWS):
    """Document lengths as ``kimilinear-serve-b4``'s traffic draws them."""
    mix = json.loads(pathlib.Path(KLIN_TRAFFIC).read_text())
    lo, hi = mix["lengths"]
    rng = np.random.default_rng([seed, 1])
    return [int(x) for x in np.exp(rng.uniform(np.log(lo), np.log(hi), n)).round()]


def klin_operands(lengths, seed: int, seq: int = 16384, heads: int = KLIN_HEADS):
    """A KDA core call's inputs as the mixer gives them: q and k unit per
    head (q times 128^-1/2), v normal, bf16; g from a served layer's gate
    (-exp(A_log) softplus(x + dt_bias), A_log log U(1, 16), dt log-uniform
    on [1e-3, 1e-1]) in f32; beta in (0, 1); lengths int32 on the card."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, d = len(lengths), 128
    shape = (b, seq, heads, d)
    q = (F.normalize(torch.randn(shape, generator=gen, device="cuda"), dim=-1)
         * d ** -0.5).bfloat16()
    k = F.normalize(torch.randn(shape, generator=gen, device="cuda"), dim=-1).bfloat16()
    v = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    a_log = torch.empty(heads, device="cuda").uniform_(1.0, 16.0, generator=gen).log_()
    dt = torch.empty(heads * d, device="cuda").uniform_(np.log(1e-3), np.log(1e-1),
                                                          generator=gen).exp_()
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    raw = torch.randn(shape, generator=gen, device="cuda") * 0.5 + dt_bias.view(heads, d)
    g = -a_log.exp()[:, None] * F.softplus(raw)
    beta = torch.rand((b, seq, heads), generator=gen, device="cuda")
    dev = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, g, beta, dev


# the core's two served shapes, as the traffic draws them: seed 0 (50,786
# real tokens) and seed 26694 (35,481, the size PERF.md section 6 row 14
# has timed the core at since it was written)
KDA_SEEDS = {"": 0, "_35k": 26694}
KDA_LAUNCHES = {"intra": ("kda_intra_kernel",), "state": ("kda_state_kernel",)}


def kernel_kda(bw, peak, results):
    """Phase 3's ``kda`` (no TPU kernel: the JAX package runs no linear
    attention) at a served Kimi-Linear layer, at both of ``KDA_SEEDS``'
    shapes: 4 documents drawn as ``kimilinear-serve-b4`` draws them,
    right-padded to 16,384, 32 heads of 128, against ``kda_chunked_plain``
    within ``KDA_TOL`` and the same bits on a second run; then timed (CUDA
    events) beside the plain version (the first shape) and the bound
    (``h100bench/kimi_linear.py::kda_cost``: q, k, v, o in bf16 and g in f32
    once each, the chunked form's operations), with each of its two
    launches' device ms from one profiled call. No library call computes
    the same function. Appends the row."""
    from multi_modal_early_exit_tpu_torch.ops.kda import CHUNK, kda, kda_chunked_plain

    from h100bench import kimi_linear

    cfg = json.loads(pathlib.Path("h100bench/configs/kimi-linear-48b-a3b-instruct.json")
                     .read_text())
    e = dict(name="kda", route="cuda", source="multi_modal_early_exit_tpu_torch/csrc/kda.cu",
             replaces="none: the JAX package runs no linear attention (multi_modal_early_exit_"
                      "tpu_torch/models/kimi_linear/modeling.py::kda_apply)", ok=True)
    worst = 0.0
    for tag, seed in KDA_SEEDS.items():
        lengths = klin_lengths(seed)
        q, k, v, g, beta, dev = klin_operands(lengths, seed)
        got = kda(q, k, v, g, beta, dev, lengths)
        torch.cuda.synchronize()
        want = kda_chunked_plain(q, k, v, g, beta, dev, CHUNK)
        err = scaled_err(got, want)
        check(err <= KDA_TOL, f"kda, lengths {lengths}: error over scale {err:.3g} (tol {KDA_TOL})")
        check(torch.equal(got, kda(q, k, v, g, beta, dev, lengths)),
              "kda: another result on a second run")
        worst = max(worst, err)
        n_bytes, n_ops = kimi_linear.kda_cost(cfg, sum(lengths))
        bound_ms, bound_by = bound(n_bytes, n_ops, bw, peak)
        ms = time_ms(lambda: kda(q, k, v, g, beta, dev, lengths), iters=20)
        launch = device_ms(lambda: kda(q, k, v, g, beta, dev, lengths), KDA_LAUNCHES)
        e.update({f"ms{tag}": ms, f"bound{tag}_ms": bound_ms, f"bound{tag}_by": bound_by,
                  f"tokens{tag}": sum(lengths), f"intra_ms{tag}": launch["intra"],
                  f"state_ms{tag}": launch["state"]})
        line = (f"kernel kda ({KLIN_ROWS} documents of {lengths} tokens, {sum(lengths)} real, "
                f"{KLIN_HEADS} heads of 128): kernel_ms {ms:.4f} (traced: kda_intra_kernel "
                f"{launch['intra']:.4f}, kda_state_kernel {launch['state']:.4f}), bound "
                f"{bound_ms:.4f} ms ({bound_by}), kernel {100 * bound_ms / ms:.1f} % of it")
        if not tag:
            e["plain_ms"] = time_ms(lambda: kda_chunked_plain(q, k, v, g, beta, dev, CHUNK),
                                    iters=2, warmup=1)
            e["max_abs_err"] = (got.float() - want.float()).abs().max().item()
            line += f", plain_ms {e['plain_ms']:.1f}"
        print(f"{line}; error over scale {err:.3g}")
        del q, k, v, g, beta, got, want
    e["err_over_scale"] = worst
    results.append(e)


# the KDA sub-layer's elementwise kernels against their plain versions on
# the same inputs (``elementwise_err``): short_conv and gated_rms_norm
# compute in f32 as their plain versions do, in another order, and each
# rounds once to bf16, so an output may land one bf16 ulp from the plain
# one's: at most 2^-7 of the output's scale. On an H100 at a served batch
# short_conv read 1.9e-3 to 4.9e-3 (above half an ulp, 2^-8) and
# gated_rms_norm 2.3e-3 to 2.9e-3. kda_gate writes f32, so only the order
# of its exp and softplus steps parts the two (error over 1 + |value|, per
# element): it read 2.4e-7 to 2.6e-7
ELEMENTWISE_TOL = {"short_conv": 2 ** -7, "kda_gate": 1e-5, "gated_rms_norm": 2 ** -7}


def elementwise_err(name: str, got, want) -> float:
    """The reading of ``name``'s output against its plain version's that
    ``ELEMENTWISE_TOL`` bounds."""
    if name == "kda_gate":
        check(got.dtype == torch.float32, f"kda_gate wrote {got.dtype}")
        return ((got - want).abs() / (1 + want.abs())).max().item()
    return scaled_err(got, want)


def klin_elementwise_operands(seed: int, seq: int = 16384):
    """The KDA sub-layer's elementwise inputs at a served batch of 4
    documents, (4, seq, 4,096) each, at the served magnitudes of the cell's
    weights (initializer_range 0.02 over the normed hidden state of 2,304):
    a q/k/v projection, N(0, 0.96^2); the convolution's weights uniform on
    +-1/2; the gate's low-rank product, N(0, 0.22^2), with A_log = log U(1,
    16) and dt_bias from a dt log-uniform on [1e-3, 1e-1]; the core's
    output, N(0, 1) in heads of 128, and the output gate's product, N(0,
    0.22^2); all bf16, as the served model holds them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape, width = (KLIN_ROWS, seq, KLIN_HEADS * 128), KLIN_HEADS * 128

    def normal(std, size=shape):
        return (torch.randn(size, generator=gen, device="cuda") * std).bfloat16()

    x = normal(0.96)
    conv_w = torch.empty(width, 1, 4, device="cuda").uniform_(-0.5, 0.5, generator=gen)
    a_log = torch.empty(KLIN_HEADS, device="cuda").uniform_(1.0, 16.0, generator=gen).log_()
    dt = torch.empty(width, device="cuda").uniform_(np.log(1e-3), np.log(1e-1),
                                                    generator=gen).exp_()
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    o = normal(1.0, (KLIN_ROWS, seq, KLIN_HEADS, 128))
    norm_w = 1.0 + 0.1 * torch.randn(128, generator=gen, device="cuda")
    return (x, conv_w.bfloat16(), normal(0.22), a_log.bfloat16(), dt_bias.bfloat16(), o,
            normal(0.22), norm_w.bfloat16())


def kernel_kda_elementwise(bw, results):
    """Phase 3's ``short_conv``, ``kda_gate`` and ``gated_rms_norm`` (no TPU
    kernel: the JAX package runs no linear attention) at a served
    Kimi-Linear batch, 4 x 16,384 x 4,096 (``klin_elementwise_operands``):
    ``short_conv`` as q (L2 norm, scale 128^-1/2), k (norm, scale 1) and v
    (no norm), ``kda_gate``, and ``gated_rms_norm`` (eps 1e-5), each within
    ``ELEMENTWISE_TOL`` of its plain version and the same bits on a second
    run, timed beside its plain version and its bytes bound (each tensor
    read once and written once; the weights left out). Appends the three
    rows."""
    from multi_modal_early_exit_tpu_torch.ops import kda as kd

    x, conv_w, raw, a_log, dt_bias, o, gate, norm_w = klin_elementwise_operands(1)
    n = x.numel()

    def gated(name, what, fn, plain):
        got = fn()
        torch.cuda.synchronize()
        want = plain()
        err = elementwise_err(name, got, want)
        check(torch.equal(got, fn()), f"{name} ({what}): another result on a second run")
        max_abs = (got.float() - want.float()).abs().max().item()
        del got, want
        return dict(name=name, what=what, err=err, max_abs=max_abs, ms=time_ms(fn, iters=20),
                    plain_ms=time_ms(plain, iters=3, warmup=1))

    convs = {what: gated("short_conv", what, lambda: kd.short_conv(x, conv_w, scale),
                         lambda: kd.short_conv_plain(x, conv_w, scale))
             for what, scale in (("q", 128 ** -0.5), ("k", 1.0), ("v", None))}
    gates = gated("kda_gate", "f32 out", lambda: kd.kda_gate(raw, a_log, dt_bias, 128),
                  lambda: kd.kda_gate_plain(raw, a_log, dt_bias, 128))
    norms = gated("gated_rms_norm", "eps 1e-5", lambda: kd.gated_rms_norm(o, gate, norm_w, 1e-5),
                  lambda: kd.gated_rms_norm_plain(o, gate, norm_w, 1e-5))
    del x, raw, o, gate
    read = list(convs.values()) + [gates, norms]
    print("kda elementwise kernels, error from the plain versions: "
          + ", ".join(f"{r['name']} ({r['what']}) {r['err']:.3g}" for r in read))
    for r in read:
        tol = ELEMENTWISE_TOL[r["name"]]
        check(r["err"] <= tol, f"{r['name']} ({r['what']}): {r['err']:.3g} from its plain "
                               f"version (tol {tol:g})")
    q, v = convs["q"], convs["v"]
    rows = [
        (dict(name="short_conv", ms=q["ms"], plain_ms=q["plain_ms"], max_abs_err=q["max_abs"],
              err_over_scale=max(c["err"] for c in convs.values()), ms_no_norm=v["ms"],
              plain_ms_no_norm=v["plain_ms"]), 4 * n,
         ", ".join(f"{w} {c['err']:.3g} of scale, {c['ms']:.4f} ms (plain {c['plain_ms']:.3f})"
                   for w, c in convs.items())),
        (dict(name="kda_gate", ms=gates["ms"], plain_ms=gates["plain_ms"],
              max_abs_err=gates["max_abs"]), 6 * n,
         f"{gates['err']:.3g} over 1 + |value|"),
        (dict(name="gated_rms_norm", ms=norms["ms"], plain_ms=norms["plain_ms"],
              max_abs_err=norms["max_abs"], err_over_scale=norms["err"]), 6 * n,
         f"{norms['err']:.3g} of scale"),
    ]
    for row, n_bytes, note in rows:
        bound_ms, bound_by = bound(n_bytes, 0, bw, 1.0)
        results.append(dict(
            row, route="cuda", source="multi_modal_early_exit_tpu_torch/csrc/kda.cu",
            replaces="none: the JAX package runs no linear attention (multi_modal_early_exit_"
                     "tpu_torch/models/kimi_linear/modeling.py::kda_apply)",
            ok=True, bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        print(f"kernel {row['name']} ({KLIN_ROWS} x 16384 x {KLIN_HEADS * 128}, bf16): {note} "
              f"(tol {ELEMENTWISE_TOL[row['name']]:g}); kernel_ms {row['ms']:.4f}, plain_ms "
              f"{row['plain_ms']:.3f}, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{n_bytes / 1e6:.0f} MB), kernel {100 * bound_ms / row['ms']:.1f} % of it")


H128, D128 = 6, 128  # hidden 768 in heads of 128


def phase_kernels_d128(name, results):
    """Phase 3 at head dim 128: every kernel whose body depends on the head
    dim (the forwards #2, #3, #5, #7, the backwards #6, #8, #9 and the
    split pre-pass) against its plain version on the paths' bias inputs in
    H = 6 heads of 128 (hidden 768), bf16 and f32, at the 64-wide phase's
    tolerances, the same bits on a second run: untimed at S = 709 inside
    P = 768, then at S = P = 768, each timed by CUDA events beside SDPA at
    D = 128 and its bound. Adds ``ms_d128``, ``bound_d128`` (and the
    ``f32_`` twins, and ``library_ms_d128``) to the kernels' rows in
    ``results``."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    args, s_true = main_path_bias_inputs(dev, gen)
    scale = 1.0 / math.sqrt(D128)
    args = list(args[:4]) + [(torch.randn((a.shape[0], H128), generator=gen) * 0.02 * scale)
                             .to(dev) for a in args[4:]]
    unpadded = [a[:, :s_true].contiguous() for a in args[:4]] + args[4:]
    readings = compare_kernels_d128(name, unpadded, gen)
    print(f"kernels at D = 128 (H = {H128} x {D128}) at S {s_true} inside P 768 (untimed; "
          f"errors over scale, tol 2e-2 bf16 / {F32_BAR} f32, dT {TABLE_GRAD_LIMIT}; the same "
          f"bits on a second run; the fused kernel bit-equal to its pair): "
          f"{json.dumps(readings)}")
    readings = compare_kernels_d128(name, args, gen, {e["name"]: e for e in results})
    print(f"kernels at D = 128 (H = {H128} x {D128}, S = P = 768; the same tolerances and "
          f"checks): {json.dumps(readings)}")
    for e in results:
        if "ms_d128" in e or "f32_ms_d128" in e:
            parts = []
            for pre in ("", "f32_"):
                if f"{pre}ms_d128" in e:
                    lib = e.get(f"{pre}library_ms_d128")
                    parts.append(f"{pre or 'bf16_'}ms {e[f'{pre}ms_d128']:.4f} bound "
                                 f"{e[f'{pre}bound_d128'] * 1e3:.1f} us "
                                 f"({e[f'{pre}bound_d128_by']}) library "
                                 + ("null" if lib is None else f"{lib:.4f}"))
            print(f"kernel {e['name']} at D = 128: " + ", ".join(parts))


# phase 3's wide head dims, (D, H) at hidden 768, 768 and 640: the kernels'
# wide mode (score side streamed 64 columns at a time, outputs in 64-column
# groups)
WIDE_DIMS = ((192, 4), (256, 3), (320, 2))


def phase_kernels_wide(name, results):
    """Phase 3 in the kernels' wide mode: every kernel whose body depends on
    the head dim (#2, #3, #5, #7, #6, #8, #9 and the split pre-pass) against
    its plain version at each of ``WIDE_DIMS`` on the paths' bias inputs (B
    = 16), bf16 and f32, at the D = 128 run's tolerances and checks (the
    same bits twice; the fused kernel bit-equal to its pair; the training
    forward at rate 0 to the serving one): untimed at S = 709 inside P = 768
    at the first D, then at S = P = 768 at each, timed by CUDA events beside
    SDPA at the same D and the bound. Adds the ``*_wide`` fields (keyed by
    D) to the kernels' rows in ``results``."""
    dev = torch.device("cuda")
    by_name = {e["name"]: e for e in results}
    for i, (d, h) in enumerate(WIDE_DIMS):
        gen = torch.Generator().manual_seed(1)
        args, s_true = main_path_bias_inputs(dev, gen)
        scale = 1.0 / math.sqrt(d)
        args = list(args[:4]) + [(torch.randn((a.shape[0], h), generator=gen) * 0.02 * scale)
                                 .to(dev) for a in args[4:]]
        if i == 0:
            unpadded = [a[:, :s_true].contiguous() for a in args[:4]] + args[4:]
            readings = compare_kernels_d128(name, unpadded, gen, d=d, h=h)
            print(f"kernels at D = {d} (H = {h}, wide mode) at S {s_true} inside P 768 "
                  f"(untimed; the D = 128 tolerances and checks): {json.dumps(readings)}")
        readings = compare_kernels_d128(name, args, gen, by_name, d=d, h=h)
        print(f"kernels at D = {d} (H = {h}, wide mode, S = P = 768; the D = 128 tolerances "
              f"and checks): {json.dumps(readings)}")
    for e in results:
        for pre in ("", "f32_"):
            for d, wide_ms in sorted(e.get(f"{pre}ms_wide", {}).items(), key=lambda x: int(x[0])):
                lib = e[f"{pre}library_ms_wide"][d]
                print(f"kernel {e['name']} at D = {d} ({pre or 'bf16_'}): ms {wide_ms:.4f} bound "
                      f"{e[f'{pre}bound_wide'][d] * 1e3:.1f} us ({e[f'{pre}bound_wide_by'][d]}) "
                      f"library " + ("null" if lib is None else f"{lib:.4f}"))


def compare_kernels_d128(name, args, gen, by_name=None, d=D128, h=H128):
    """The kernels at head dim ``d`` (128, or a wide one) against their plain
    versions on the bias inputs ``args`` (tables of ``h`` heads), bf16 and
    f32; with ``by_name`` (the kernels' rows) each is also timed and its
    ``*_d128`` fields set (at a wide ``d``: the ``*_wide`` fields, keyed by
    ``d``). Raises on a disagreement; returns what each comparison read."""
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
    )

    bw, bf16_peak = peaks_for(name)[:2]
    dev, s = args[0].device, args[0].shape[1]
    timed = by_name is not None
    in_bytes = sum(a.numel() * a.element_size() for a in args)
    vec_table_bytes = sum(a.numel() * a.element_size() for a in args[:3]) + sum(
        a.shape[0] * h * 4 for a in args[4:])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    seed, rate = 1234, TRAIN_RATE
    readings = {}
    fwd_flops = 4 * B * h * s * s * d
    bwd_flops = 10 * B * h * s * s * d

    def heads(x):
        return x.view(B, s, h, d).transpose(1, 2)

    def put(row, pre, **fields):
        """A kernel row's fields at this head dim: ``{pre}ms_d128`` ... at
        128, ``{pre}ms_wide[d]`` ... at a wide d (bound_by after the name)."""
        for field, value in fields.items():
            base, by = (field[:-3], "_by") if field.endswith("_by") else (field, "")
            if d == D128:
                row[f"{pre}{base}_d128{by}"] = value
            else:
                row.setdefault(f"{pre}{base}_wide{by}", {})[str(d)] = value

    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        pre, tag = ("f32_", "f32") if f32 else ("", "bf16")
        bar = F32_BAR if f32 else 2e-2
        peak = bf16_peak / SPLIT_PASSES if f32 else bf16_peak
        esize = 4 if f32 else 2
        q, k, v, do = (torch.randn((B, s, h * d), generator=gen).to(dev, dtype)
                       for _ in range(4))
        do = do * 0.1
        bias = materialize_bias(*args, out_dtype=dtype)
        p = bias.shape[-1]
        check(p == 768, f"D = {d} inputs: S {s}, P {p}")
        qkv_bytes = B * s * h * d * esize
        block = B * h * s * s * esize
        plane = B * h * p * p * esize
        lse_bytes = B * h * p * 4
        mask4 = bias[:, :, :s, :s]

        def gate(kname, what, got, want, again=None, limit=bar):
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"D = {d} {tag} {kname} {what} layout (S {s})")
            check(bool(torch.isfinite(got.float()).all()), f"D = {d} {tag} {kname} {what} "
                  f"not finite (S {s})")
            err = scaled_err(got, want)
            check(err <= limit, f"D = {d} {tag} {kname} {what} (S {s}): error {err} > {limit} "
                  f"of its scale")
            if again is not None:
                check(torch.equal(got, again), f"D = {d} {tag} {kname} {what} differs between "
                      f"two runs (S {s})")
            readings.setdefault(f"{kname} {tag}", {})[what] = float(f"{err:.3e}")

        def record(kname, fn, bound_pair, library_ms, iters=20):
            if timed:
                put(by_name[kname], pre, ms=time_ms(fn, iters=iters), bound=bound_pair[0],
                    bound_by=bound_pair[1], library_ms=library_ms() if library_ms else None)

        def sdpa_ms():
            return time_ms(lambda: sdpa(heads(q), heads(k), heads(v), attn_mask=mask4))

        def sdpa_bwd_ms():
            qg, kg, vg = (heads(x).detach().requires_grad_() for x in (q, k, v))
            mask_g = mask4.detach().clone().requires_grad_()
            o_lib = sdpa(qg, kg, vg, attn_mask=mask_g)
            return time_ms(lambda: torch.autograd.grad(o_lib, (qg, kg, vg, mask_g), heads(do),
                                                       retain_graph=True), iters=10)

        # #2 flash_attention_packed
        out = flash_attention_packed(q, k, v, bias, h)
        gate("flash_attention_packed", "o", out, flash_attention_packed_plain(q, k, v, bias, h),
             flash_attention_packed(q, k, v, bias, h))
        record("flash_attention_packed", lambda: flash_attention_packed(q, k, v, bias, h),
               bound(block + 4 * qkv_bytes, fwd_flops, bw, peak), sdpa_ms)

        # #3 fused_bias_attention: within the bar, bit-equal to the pair
        qh, kh, vh = heads(q), heads(k), heads(v)
        fused = fused_bias_attention(qh, kh, vh, *args)
        gate("fused_bias_attention", "o", fused, fused_bias_attention_plain(qh, kh, vh, *args),
             fused_bias_attention(qh, kh, vh, *args))
        check(torch.equal(fused.transpose(1, 2).reshape(B, s, -1), out),
              f"D = {d} {tag} fused_bias_attention differs from materialize_bias + "
              f"flash_attention_packed (S {s})")
        record("fused_bias_attention", lambda: fused_bias_attention(qh, kh, vh, *args),
               bound(4 * qkv_bytes + in_bytes, fwd_flops, bw, peak), None)
        del fused

        # #7 the training forward at the path's rate; at rate 0 the serving bits
        t_out, lse = flash_attention_packed_train_fwd(q, k, v, bias, seed, h, rate)
        ref_o, ref_lse = flash_attention_packed_train_fwd_plain(q, k, v, bias, seed, h, rate)
        gate("flash_attention_packed_train", "o", t_out, ref_o,
             flash_attention_packed_train_fwd(q, k, v, bias, seed, h, rate)[0])
        lse_err = (lse[:, :, :s] - ref_lse[:, :, :s]).abs().max().item()
        check(lse_err <= 1e-3 and bool(torch.isinf(lse[:, :, s:]).all()),
              f"D = {d} {tag} train forward lse error {lse_err} (S {s})")
        check(torch.equal(flash_attention_packed_train_fwd(q, k, v, bias, seed, h, 0.0)[0],
                          out), f"D = {d} {tag} train forward at rate 0 differs from "
              f"flash_attention_packed (S {s})")
        record("flash_attention_packed_train",
               lambda: flash_attention_packed_train_fwd(q, k, v, bias, seed, h, rate),
               bound(block + 4 * qkv_bytes + lse_bytes, fwd_flops, bw, peak), sdpa_ms)
        del ref_o, ref_lse, out

        # #8 the training backward, plain and chained
        gbias = (torch.randn(bias.shape, generator=gen) * 1e-3).to(dev, dtype)
        bwd_args = (q, k, v, bias, seed, t_out, lse, do, h, rate)
        for chained in (False, True):
            extra = gbias if chained else None
            got = flash_attention_packed_train_bwd(*bwd_args, extra)
            again = flash_attention_packed_train_bwd(*bwd_args, extra)
            want = flash_attention_packed_train_bwd_plain(*bwd_args, extra)
            for what, a, w, a2 in zip(("dq", "dk", "dv", "dbias"), got, want, again):
                gate("flash_attention_packed_train_bwd", what + ("_chained" if chained else ""),
                     a, w, a2)
            del got, want, again
        lib_bwd = sdpa_bwd_ms() if timed else None
        record("flash_attention_packed_train_bwd",
               lambda: flash_attention_packed_train_bwd(*bwd_args, gbias),
               bound(block + 2 * plane + 8 * qkv_bytes + lse_bytes, bwd_flops, bw, peak),
               lambda: lib_bwd, iters=10)

        # #5/#6 the head form at the packed strides, rate 0
        views = [heads(x) for x in (q, k, v, do)]
        o_h, lse_h = flash_attention_fwd(*views[:3], bias, 0, 0.0, with_lse=True)
        gate("flash_attention_fwd", "o", o_h,
             flash_attention_fwd_plain(*views[:3], bias, 0, 0.0)[0],
             flash_attention_fwd(*views[:3], bias, 0, 0.0))
        record("flash_attention_fwd",
               lambda: flash_attention_fwd(*views[:3], bias, 0, 0.0, with_lse=True),
               bound(block + 4 * qkv_bytes + lse_bytes, fwd_flops, bw, peak), sdpa_ms)
        hbwd = (*views[:3], bias, 0, o_h, lse_h, views[3], 0.0)
        got, again, want = (flash_attention_bwd(*hbwd), flash_attention_bwd(*hbwd),
                            flash_attention_bwd_plain(*hbwd))
        for what, a, w, a2 in zip(("dq", "dk", "dv", "dbias"), got, want, again):
            gate("flash_attention_bwd", what, a, w, a2)
        del got, again, want
        record("flash_attention_bwd", lambda: flash_attention_bwd(*hbwd),
               bound(block + plane + 8 * qkv_bytes + lse_bytes, bwd_flops, bw, peak),
               lambda: lib_bwd, iters=10)

        # #9 the table-gradient backward
        tables_args = (q, k, v, bias, *args[:3], seed, t_out, lse, do, h, rate)
        got = flash_attention_packed_train_tables_bwd(*tables_args)
        again = flash_attention_packed_train_tables_bwd(*tables_args)
        want = flash_attention_packed_train_tables_bwd_plain(*tables_args)
        for what, a, w, a2 in zip(("dq", "dk", "dv", "dt1", "dtx", "dty"), got, want, again):
            gate("flash_attention_packed_train_tables_bwd", what, a, w, a2,
                 bar if what in ("dq", "dk", "dv") else TABLE_GRAD_LIMIT)
        del got, again, want
        record("flash_attention_packed_train_tables_bwd",
               lambda: flash_attention_packed_train_tables_bwd(*tables_args),
               bound(block + 8 * qkv_bytes + lse_bytes + vec_table_bytes, bwd_flops, bw, peak),
               None, iters=10)

        # the split pre-pass (f32 only): bit-equal to its plain version
        if f32:
            parts = split_bf16x3(*views)
            for i, x in enumerate(views):
                check(torch.equal(parts[i], split_bf16x3_plain(x)),
                      f"D = {d} split_bf16x3 differs from its plain version (operand {i}, S {s})")
            readings["split_bf16x3 f32"] = "bit-equal"
            if timed:  # f32 only: the row's plain fields are its f32 readings
                split_bound = bound(4 * qkv_bytes + 12 * qkv_bytes // 2, 0, bw, bf16_peak)
                put(by_name["split_bf16x3"], "", ms=time_ms(lambda: split_bf16x3(*views)),
                    bound=split_bound[0], bound_by=split_bound[1], library_ms=None)
        del views, o_h, lse_h, hbwd, tables_args, bwd_args, bias, q, k, v, do, t_out, lse
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return readings


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


def rescale_heads(model, cfg, chunks) -> None:
    """Rescale and re-centre each head's out_proj on the documents of
    ``chunks`` (tuples of ``ee_forward``'s inputs) so that its logits vary
    across them with std 1: random heads give every document nearly the
    same logits."""
    from multi_modal_early_exit_tpu_torch.models.ee.model import ee_forward

    heads = [*model.embedding_exits.values(), *model.encoder_exits, model.backbone.classifier]
    store = torch.cat([ee_forward(model, cfg, *c).policy_logits().float() for c in chunks], 1)
    with torch.no_grad():
        for head, logits in zip(heads, store):
            mean = logits.mean(dim=0)
            gain = 1.0 / (logits - mean).std().item()
            proj = head.out_proj
            proj.weight.mul_(gain)
            proj.bias.copy_(proj.bias * gain - gain * mean.to(proj.bias))


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
    from multi_modal_early_exit_tpu_torch.serving import Pipeline
    from multi_modal_early_exit_tpu_torch.utils.profiling import launch_counts

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
    rescale_heads(model, cfg, chunks)

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
    before = launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = pipe.predict_features(batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = launched(before, ("materialize_bias", "flash_attention_packed", "split_bf16x3",
                                 "add_layer_norm"))
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
    check(launches["add_layer_norm"] == V3_NORMS * N_BATCHES, f"LayerNorm launches {launches}")
    hist = {name: sum(r["exit_name"] == name for r in results) for name in order}
    forced = sum(r["capacity_exited"] for r in results)
    check(forced > 0 and hist["final"] > 0 and hist[order[0]] + hist[order[1]] > 0,
          f"expected early, forced and final exits: {hist}, forced {forced}")
    beside = "" if base is None else (
        f" (phase 4: {base['docs_per_sec']:.1f} docs/sec, {base['peak_mb']:.1f} MiB)")
    if dtype == torch.float32:  # the f32 attention's device time in one more call
        ms = device_ms(lambda: pipe.predict_features(batch),
                       {"attention": ("fwd_kernel<", "split_bf16x3_kernel"),
                        "split": ("split_bf16x3_kernel",)}, SERVE_KERNELS)
        traced = (f"; one more call traced: the f32 attention (split pre-pass and forward "
                  f"kernel) {ms['attention']:.3f} device ms (the pre-pass {ms['split']:.3f}) "
                  f"of {ms['all']:.3f}")
    else:  # phase 4b prints its own beside these
        ms = device_ms(lambda: pipe.predict_features(batch),
                       {"attention": ("fwd_kernel<",), "bias": ("materialize_bias_kernel",)},
                       SERVE_KERNELS)
        traced = (f"; one more call traced: {ms['all']:.3f} device ms, the attention "
                  f"{ms['attention']:.3f}, the bias build {ms['bias']:.3f}")
    # the traced call's batches replay the cascade's CUDA graphs, whose
    # kernels no wrapper counts as they run: the trace's count of each
    # kernel the card ran holds the same per-batch counts as the tallies
    want = {"attention": 12, "bias": 1, "norm": V3_NORMS,
            "split": 12 if dtype == torch.float32 else 0}
    ran = ms["kernels"]
    check(ran == {k: n * N_BATCHES for k, n in want.items()},
          f"the traced call of {N_BATCHES} batches ran the kernels {ran}")
    traced += f", its kernels {ran}"
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
    from multi_modal_early_exit_tpu_torch.utils.profiling import launch_counts

    s = served
    model, cfg, far = s["model"], s["cfg"], s["far"]
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
    before = launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = pipe.predict_features(s["batch"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    want = {"fused_bias_attention": 12, "materialize_bias": 0, "flash_attention_packed": 0,
            "add_layer_norm": V3_NORMS}
    launches = launched(before, want)
    for name, per_batch in want.items():
        check(launches[name] == per_batch * N_BATCHES,
              f"{name}: {launches[name]} launches in {N_BATCHES} batches")
    n_docs = N_BATCHES * B
    same = [a["exit_name"] == b["exit_name"] for a, b in zip(results, s["results"])]
    check(len(results) == n_docs and all(x for x, f in zip(same, far.tolist()) if f),
          "the fused-bias Pipeline's exits differ from phase 4's away from the thresholds")
    ms, base = device_ms(lambda: pipe.predict_features(s["batch"]),
                         {"attention": ("fwd_kernel<",)}, SERVE_KERNELS), s["device_ms"]
    # what the card ran in the traced call's replayed batches, by kernel name
    ran = ms["kernels"]
    want = {"attention": 12, "bias": 0, "norm": V3_NORMS, "split": 0}
    check(ran == {k: n * N_BATCHES for k, n in want.items()},
          f"the traced fused-bias call of {N_BATCHES} batches ran the kernels {ran}")
    print(f"served with MMEE_FUSED_BIAS=1: full-capacity exits equal phase 4's for "
          f"{int(far.sum())}/{n_docs} documents farther than 1e-2 from every threshold "
          f"({int(agree.sum())}/{n_docs} in all), logit max diff {logit_err:.3e}; Pipeline: "
          f"{n_docs / dt:.1f} docs/sec (phase 4: {s['docs_per_sec']:.1f}), exits equal "
          f"phase 4's for {sum(same)}/{n_docs} documents, launches {launches}, peak memory "
          f"{peak_mb:.1f} MiB (phase 4: {s['peak_mb']:.1f} MiB); one more call traced: "
          f"{ms['all']:.3f} device ms per {N_BATCHES} batches, the fused attention "
          f"{ms['attention']:.3f} (phase 4: {base['all']:.3f}, the attention "
          f"{base['attention']:.3f} + the bias build {base['bias']:.3f}), its kernels {ran}")
    return launches


# the tiny config's widths with wider heads, by head dim: hidden 384 in
# heads of 96 (padded to the kernels' 128) and 512 in heads of 128 (4 heads
# each), and in the kernels' wide mode hidden 384 in 2 heads of 192 and 512
# in 2 heads of 256; the layout embeddings' 4 coordinate + 2 shape widths
# sum to the hidden size
WIDE_HEADS = {96: dict(hidden_size=384, coordinate_size=64, shape_size=64),
              128: dict(hidden_size=512, coordinate_size=96, shape_size=64),
              192: dict(hidden_size=384, coordinate_size=64, shape_size=64,
                        num_attention_heads=2),
              256: dict(hidden_size=512, coordinate_size=96, shape_size=64,
                        num_attention_heads=2)}


MOON_LAYERS, MOON_BATCHES, MOON_B, MOON_S = 3, 2, 8, 2048
MOON_LENGTHS = (512, 2048)  # moonlight-serve-b32's documents: 1-3 OCR'd pages
# a batch's kernels: one swiglu_weigh a SwiGLU (layer 0's, and the shared
# and routed experts' of layers 1-2), one combine_pairs an expert layer (8
# documents' tokens fit one MLP pass)
MOON_BATCH_LAUNCHES = {"swiglu_weigh": 5, "combine_pairs": 2}
# the relative L2 distance of a served MLP call's output from the plain
# versions' on the same inputs: rounding moves it by tenths of a percent, a
# zeroed MLP by 1, the routed experts without their weights by more
MOON_TOL = 0.02


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def phase_moonlight():
    """Phase 4m: early-exit Moonlight at its published widths, depth cut to
    ``MOON_LAYERS`` (layer 0 dense, then expert layers), exits after layers
    1 and 2, random weights from a seed, bf16 on the card, served as
    ``moonlight-serve-b32`` serves it: ``Pipeline.predict_features``, whose
    cascade runs ``CascadeStages.layers``, over ``MOON_BATCHES`` batches of
    ``MOON_B`` documents of ``MOON_LENGTHS`` tokens (log-uniform, right-
    padded to ``MOON_S``), at a threshold no document meets, so every stage
    runs every row. Checks, on those batches alone: ``MOON_BATCH_LAUNCHES``
    a batch, every MLP row through the kernels (15 a token: layer 0's, then
    6 pairs and the shared experts' in each expert layer; no call of the
    composed chains), every answer from the final
    classifier; and each MLP call on the way (``experts_apply`` and
    ``mlp_apply``, recorded with their inputs and outputs) recomputed by the
    plain versions of ``ops.moe_pairs`` on the same inputs, within
    ``MOON_TOL`` (relative L2), which the routed experts recomputed without
    their weights must miss. Returns the launches."""
    from unittest import mock

    from multi_modal_early_exit_tpu_torch.models.ee.model import init_ee_params
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import EEModelConfig
    from multi_modal_early_exit_tpu_torch.models.moonlight import modeling as moon
    from multi_modal_early_exit_tpu_torch.models.moonlight.config import (
        MoonlightConfig,
        MoonlightExitConfig,
    )
    from multi_modal_early_exit_tpu_torch.ops import moe_pairs
    from multi_modal_early_exit_tpu_torch.serving import Pipeline
    from multi_modal_early_exit_tpu_torch.utils.profiling import launch_counts

    bb = MoonlightConfig.base().replace(num_hidden_layers=MOON_LAYERS)
    cfg = EEModelConfig(backbone=bb, exit=MoonlightExitConfig(exits=(1, 2)))
    model = init_ee_params(cfg, torch.Generator().manual_seed(0), device="cuda",
                           dtype=torch.bfloat16)
    pipe = Pipeline(model, cfg, threshold=2.0, batch_size=MOON_B, tokenizer=object(),
                    device="cuda")
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(MOON_BATCHES):
        lengths = np.exp(rng.uniform(*np.log(MOON_LENGTHS), MOON_B)).round().astype(np.int64)
        mask = (np.arange(MOON_S)[None, :] < lengths[:, None]).astype(np.int32)
        ids = rng.integers(0, bb.vocab_size, (MOON_B, MOON_S)).astype(np.int32) * mask
        batches.append({"input_ids": ids, "attention_mask": mask})
    tokens = sum(int(b["attention_mask"].sum()) for b in batches)

    calls = []  # (name, function, inputs, output) of each MLP call

    def recorded(fn, routed):
        def call(p, *args):
            out = fn(p, *args)
            if routed:
                name = "routed"
            else:
                width = p.down_proj.weight.numel() // bb.hidden_size
                name = "layer 0" if width == bb.intermediate_size else "shared"
            calls.append((name, fn, (p,) + args, out))
            return out
        return call

    composed = []  # the composed chains' calls, which the card must not make

    def refused(fn):
        def call(*args, **kwargs):
            composed.append(fn.__name__)
            return fn(*args, **kwargs)
        return call

    with mock.patch.object(moon, "experts_apply", recorded(moon.experts_apply, True)), \
            mock.patch.object(moon, "mlp_apply", recorded(moon.mlp_apply, False)), \
            mock.patch.object(moe_pairs, "swiglu_weigh_plain",
                              refused(moe_pairs.swiglu_weigh_plain)), \
            mock.patch.object(moe_pairs, "combine_pairs_plain",
                              refused(moe_pairs.combine_pairs_plain)):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers = [a for b in batches for a in pipe.predict_features(b)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launched(before, tuple(MOON_BATCH_LAUNCHES))
    check(launches == {k: n * MOON_BATCHES for k, n in MOON_BATCH_LAUNCHES.items()},
          f"Moonlight launched {launches}")
    per_token = 1 + (MOON_LAYERS - 1) * (bb.num_experts_per_tok + 1)
    # a routed call's rows are its token-expert pairs, any other's its tokens
    rows = sum(args[2].numel() if name == "routed" else args[1].shape[0]
               for name, _, args, _ in calls)
    check(rows == per_token * tokens and not composed,
          f"Moonlight's MLP rows {rows}, {tokens} tokens; composed calls {composed}")
    check(len(answers) == MOON_BATCHES * MOON_B
          and all(a["exit_name"] == "final" for a in answers),
          f"Moonlight's exits {[a['exit_name'] for a in answers]}")
    check(len(calls) == MOON_BATCHES * (1 + 2 * (MOON_LAYERS - 1)),
          f"{len(calls)} MLP calls recorded")

    errs, unweighted = {}, []
    with torch.inference_mode(), mock.patch.object(moon, "_fused", lambda *a: False):
        for name, fn, args, out in calls:
            err = rel_l2(out, fn(*args))
            check(torch.isfinite(out).all().item() and err <= MOON_TOL,
                  f"Moonlight's {name} MLP: {err:.3g} from the plain versions (at most "
                  f"{MOON_TOL})")
            errs[name] = max(errs.get(name, 0.0), err)
            if name == "routed":
                p, x, chosen, weights, offset = args
                unweighted.append(rel_l2(out, fn(p, x, chosen, torch.ones_like(weights),
                                                 offset)))
    check(min(unweighted) > MOON_TOL,
          f"the routed experts without their weights read {min(unweighted):.3g}, within "
          f"{MOON_TOL}: the check would not see them")
    del calls
    worst = {k: float(f"{v:.3g}") for k, v in errs.items()}
    print(f"moonlight (published widths, {MOON_LAYERS} layers, bf16): "
          f"{MOON_BATCHES} batches of {MOON_B} ({tokens} tokens) through Pipeline in "
          f"{seconds:.3f} s, all to the final classifier; launches {launches}, MLP rows {rows}; "
          f"relative L2 from the plain versions on each call's inputs, worst "
          f"{worst} (tol {MOON_TOL}; the routed "
          f"experts without their weights {min(unweighted):.3g} at least)")
    return launches


VL_LAYERS, VL_BATCHES = 3, 2  # phase 4v's depth (the tower's and the decoder's), its batches


def phase_vision():
    """Phase 4v: early-exit Kimi-VL, its vision tower and projector at their
    published widths (hidden 1152, 16 heads of 72, MLP 4,304, the projector
    to 2,048) and Moonlight's decoder at its own, both cut to ``VL_LAYERS``
    layers, exits after layers 1 and 2, random weights from a seed, bf16 on
    the card, served as ``kimivl-serve-b16`` serves it:
    ``Pipeline.predict_features`` with each row's ``pixel_values`` and
    ``image_grid_hws``, whose cascade runs the tower in
    ``KimiVLStages.embed``, over ``VL_BATCHES`` batches of ``VL_PAGES``
    pages (grids drawn as the cell's traffic draws them, random patch
    rows, the placeholder ids, prompt and padding of its traffic file), at
    a threshold no page meets, so every stage runs every row. Checks, on
    those batches alone: ``VL_LAYERS`` ``page_attention`` launches a batch,
    and Moonlight's MLP kernels as in phase 4m for the batch's tokens;
    every answer from the final classifier; and each ``page_attention`` call
    on the way, recorded with its inputs and output, against
    ``page_attention_plain`` on the same inputs within ``PAGE_ATTN_TOL``
    (error over scale), which the plain attention with each two
    neighbouring pages merged into one must miss. Returns the launches."""
    from unittest import mock

    from multi_modal_early_exit_tpu_torch.models.ee.model import init_ee_params
    from multi_modal_early_exit_tpu_torch.models.kimi_vl import modeling as kv
    from multi_modal_early_exit_tpu_torch.models.kimi_vl.config import (
        KimiVLConfig,
        MoonViTConfig,
    )
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import EEModelConfig
    from multi_modal_early_exit_tpu_torch.models.moonlight import modeling as moon
    from multi_modal_early_exit_tpu_torch.models.moonlight.config import MoonlightExitConfig
    from multi_modal_early_exit_tpu_torch.ops.page_attention import page_attention_plain
    from multi_modal_early_exit_tpu_torch.serving import Pipeline
    from multi_modal_early_exit_tpu_torch.utils.profiling import launch_counts

    vl = KimiVLConfig.base()
    vl = vl.replace(text=vl.text.replace(num_hidden_layers=VL_LAYERS),
                    vision=MoonViTConfig(num_hidden_layers=VL_LAYERS))
    cfg = EEModelConfig(backbone=vl, exit=MoonlightExitConfig(exits=(1, 2)))
    model = init_ee_params(cfg, torch.Generator().manual_seed(0), device="cuda",
                           dtype=torch.bfloat16)
    pipe = Pipeline(model, cfg, threshold=2.0, batch_size=VL_PAGES, tokenizer=object(),
                    device="cuda")
    mix = json.loads(pathlib.Path(VL_TRAFFIC).read_text())
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    placeholder, seq = vl.media_placeholder_token_id, mix["seq_len"]
    batches, want = [], {}
    for b in range(VL_BATCHES):
        grid = np.array(vl_grids(b + 1), np.int64)
        tokens = grid.prod(axis=1) // vl.vision.merged
        pos = np.arange(seq)[None, :]
        mask = (pos < (tokens + mix["prompt_tokens"])[:, None]).astype(np.int32)
        prompt = rng.integers(0, placeholder, (VL_PAGES, seq))
        ids = np.where(pos < tokens[:, None], placeholder, prompt).astype(np.int32) * mask
        pixels = torch.rand((VL_PAGES, mix["max_patches"], vl.vision.patch_dim), generator=gen,
                            device="cuda").mul_(2).sub_(1).bfloat16()
        batches.append({"input_ids": ids, "attention_mask": mask, "pixel_values": pixels,
                        "image_grid_hws": grid})
        # phase 4m's MLP kernels: a SwiGLU in layer 0, two and a combine in
        # each expert layer, each MLP pass of the batch's tokens
        passes = -(-int(mask.sum()) // moon.MLP_TOKENS)
        for k, n in (("page_attention", VL_LAYERS),
                     ("swiglu_weigh", passes * (1 + 2 * (VL_LAYERS - 1))),
                     ("combine_pairs", passes * (VL_LAYERS - 1))):
            want[k] = want.get(k, 0) + n
    patches = sum(int(b["image_grid_hws"].prod(axis=1).sum()) for b in batches)
    tokens = sum(int(b["attention_mask"].sum()) for b in batches)

    calls = []  # the inputs and output of each page_attention call
    served = kv.page_attention

    def recorded(q, k, v, starts, cu_seqlens, scale):
        out = served(q, k, v, starts, cu_seqlens, scale)
        calls.append(((q, k, v, list(starts), scale), out))
        return out

    with mock.patch.object(kv, "page_attention", recorded):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers = [a for b in batches for a in pipe.predict_features(b)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launched(before, tuple(want))
    check(launches == want, f"phase 4v: Kimi-VL launched {launches}, not {want}")
    check(len(answers) == VL_BATCHES * VL_PAGES
          and all(a["exit_name"] == "final" for a in answers),
          f"phase 4v: Kimi-VL's exits {[a['exit_name'] for a in answers]}")
    check(len(calls) == VL_BATCHES * VL_LAYERS, f"phase 4v: {len(calls)} page_attention calls")

    errs, across = [], []
    with torch.inference_mode():
        for (q, k, v, starts, scale), out in calls:
            check(bool(torch.isfinite(out).all()), "phase 4v: non-finite page_attention output")
            errs.append(scaled_err(out, page_attention_plain(q, k, v, starts, scale)))
            # each two neighbouring pages as one: attention across pages
            merged = starts[::2] + starts[-1:] * ((len(starts) - 1) % 2)
            across.append(scaled_err(out, page_attention_plain(q, k, v, merged, scale)))
    del calls
    check(max(errs) <= PAGE_ATTN_TOL, f"phase 4v: page_attention {max(errs):.3g} from the plain "
                                      f"version on its own inputs (tol {PAGE_ATTN_TOL})")
    check(min(across) > PAGE_ATTN_TOL, f"phase 4v: attention across neighbouring pages reads "
                                       f"{min(across):.3g}, within {PAGE_ATTN_TOL}: the check "
                                       f"would not see it")
    print(f"phase 4v: Kimi-VL (published widths, {VL_LAYERS} layers, bf16): {VL_BATCHES} "
          f"batches of {VL_PAGES} pages ({patches} patches, {tokens} tokens) through Pipeline in "
          f"{seconds:.3f} s, all to the final classifier; launches {launches}; each "
          f"page_attention call against the plain version on its inputs, error over scale at "
          f"most {max(errs):.3g} (tol {PAGE_ATTN_TOL}; neighbouring pages merged "
          f"{min(across):.3g} at least)")
    return launches


KLIN_LAYERS, KLIN_BATCHES = 4, 2  # one whole 3 : 1 period


def phase_kimi_linear():
    """Phase 4k: early-exit Kimi-Linear at its published widths (hidden
    2304, KDA in 32 heads of 128, MLA 32 heads without rotary, 128 of the
    256 routed experts of 1024 held, top 8), cut to one whole period of
    ``KLIN_LAYERS`` layers (KDA, KDA, KDA, MLA; layer 1's MLP dense),
    exits after layers 1 and 2, random weights from a seed, bf16 on the
    card, served as ``kimilinear-serve-b4`` serves it:
    ``Pipeline.predict_features`` over ``KLIN_BATCHES`` batches of 4
    documents drawn as its traffic draws them, right-padded to 16,384, at
    a threshold no document meets, so every stage runs every row. Checks,
    on those batches alone: a KDA layer's 2 ``kda``, 3 ``short_conv``, 1
    ``kda_gate`` and 1 ``gated_rms_norm`` launches, Moonlight's MLP kernels
    as in phase 4m for the batch's tokens; every answer from the final
    classifier; each ``kda`` call on the way, recorded with its inputs and
    output, against ``kda_chunked_plain`` on the same inputs within
    ``KDA_TOL`` (error over scale); each elementwise kernel's call against
    its plain version on the same inputs within ``ELEMENTWISE_TOL``; and
    each expert layer's held share (``experts_apply`` at the configuration's
    offset, ``swiglu_weigh`` and ``combine_pairs`` given ``held``) against
    the plain versions on its own inputs within ``MOON_TOL`` (relative L2),
    which the share without its weights must miss. Returns the launches."""
    from unittest import mock

    from multi_modal_early_exit_tpu_torch.models.ee.model import init_ee_params
    from multi_modal_early_exit_tpu_torch.models.kimi_linear import modeling as klm
    from multi_modal_early_exit_tpu_torch.models.kimi_linear.config import KimiLinearConfig
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import EEModelConfig
    from multi_modal_early_exit_tpu_torch.models.moonlight import modeling as moon
    from multi_modal_early_exit_tpu_torch.models.moonlight.config import MoonlightExitConfig
    from multi_modal_early_exit_tpu_torch.ops import kda as kd
    from multi_modal_early_exit_tpu_torch.ops.kda import kda_chunked_plain
    from multi_modal_early_exit_tpu_torch.serving import Pipeline
    from multi_modal_early_exit_tpu_torch.utils.profiling import launch_counts

    bb = KimiLinearConfig.base().replace(num_hidden_layers=KLIN_LAYERS, kda_layers=(1, 2, 3),
                                         full_attn_layers=(4,))
    cfg = EEModelConfig(backbone=bb, exit=MoonlightExitConfig(exits=(1, 2)))
    model = init_ee_params(cfg, torch.Generator().manual_seed(0), device="cuda",
                           dtype=torch.bfloat16)
    pipe = Pipeline(model, cfg, threshold=2.0, batch_size=KLIN_ROWS, tokenizer=object(),
                    device="cuda")
    seq = json.loads(pathlib.Path(KLIN_TRAFFIC).read_text())["seq_len"]
    rng = np.random.default_rng(0)
    batches, want = [], {}
    kda_layers = len(bb.kda_layers)
    for i in range(KLIN_BATCHES):
        lengths = np.array(klin_lengths(i + 1))
        mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
        ids = rng.integers(0, bb.vocab_size, (KLIN_ROWS, seq)).astype(np.int32) * mask
        batches.append({"input_ids": ids, "attention_mask": mask})
        passes = -(-int(mask.sum()) // moon.MLP_TOKENS)
        for k, n in (("kda", 2 * kda_layers), ("short_conv", 3 * kda_layers),
                     ("kda_gate", kda_layers), ("gated_rms_norm", kda_layers),
                     ("swiglu_weigh", passes * (1 + 2 * (KLIN_LAYERS - 1))),
                     ("combine_pairs", passes * (KLIN_LAYERS - 1))):
            want[k] = want.get(k, 0) + n
    tokens = sum(int(b["attention_mask"].sum()) for b in batches)

    calls = []  # the inputs and output of each kda call
    served = klm.kda

    def recorded(q, k, v, g, beta, lengths, lengths_host, chunk):
        out = served(q, k, v, g, beta, lengths, lengths_host, chunk)
        calls.append(((q, k, v, g, beta, lengths, chunk), out))
        return out

    # the elementwise kernels' and the held expert share's calls, each
    # compared with its plain version on its own inputs as it returns
    errs = {name: [] for name in ELEMENTWISE_TOL}
    routed, unweighted, offsets = [], [], []

    def compared(name):
        kernel, plain = getattr(klm, name), getattr(kd, f"{name}_plain")

        def call(*args):
            out = kernel(*args)
            errs[name].append(elementwise_err(name, out, plain(*args)))
            return out
        return call

    held_apply = moon.experts_apply

    def held_share(p, x, chosen, weights, offset=None):
        out = held_apply(p, x, chosen, weights, offset)
        offsets.append(offset)
        with mock.patch.object(moon, "_fused", lambda *a: False):
            routed.append(rel_l2(out, held_apply(p, x, chosen, weights, offset)))
            unweighted.append(rel_l2(out, held_apply(p, x, chosen, torch.ones_like(weights),
                                                     offset)))
        return out

    with mock.patch.object(klm, "kda", recorded), \
            mock.patch.object(klm, "short_conv", compared("short_conv")), \
            mock.patch.object(klm, "kda_gate", compared("kda_gate")), \
            mock.patch.object(klm, "gated_rms_norm", compared("gated_rms_norm")), \
            mock.patch.object(moon, "experts_apply", held_share):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers = [a for b in batches for a in pipe.predict_features(b)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launched(before, tuple(want))
    check(launches == want, f"phase 4k: Kimi-Linear launched {launches}, not {want}")
    check(len(answers) == KLIN_BATCHES * KLIN_ROWS
          and all(a["exit_name"] == "final" for a in answers),
          f"phase 4k: Kimi-Linear's exits {[a['exit_name'] for a in answers]}")
    check(len(calls) == KLIN_BATCHES * kda_layers, f"phase 4k: {len(calls)} kda calls")
    check({k: len(v) for k, v in errs.items()}
          == {"short_conv": 3 * len(calls), "kda_gate": len(calls), "gated_rms_norm": len(calls)},
          f"phase 4k: {({k: len(v) for k, v in errs.items()})} elementwise calls")
    for name, found in errs.items():
        check(max(found) <= ELEMENTWISE_TOL[name],
              f"phase 4k: {name} {max(found):.3g} from its plain version on its own inputs (tol "
              f"{ELEMENTWISE_TOL[name]:g})")
    check(len(offsets) == want["combine_pairs"] and set(offsets) == {bb.expert_offset},
          f"phase 4k: the expert layers ran the held share at offsets {offsets}")
    check(max(routed) <= MOON_TOL,
          f"phase 4k: the held share's routed experts {max(routed):.3g} from the plain versions "
          f"on their own inputs (tol {MOON_TOL})")
    check(min(unweighted) > MOON_TOL,
          f"phase 4k: the held share without its weights read {min(unweighted):.3g}, within "
          f"{MOON_TOL}: the check would not see them")
    core = []
    with torch.inference_mode():
        for (q, k, v, g, beta, lengths, chunk), out in calls:
            check(bool(torch.isfinite(out).all()), "phase 4k: non-finite kda output")
            core.append(scaled_err(out, kda_chunked_plain(q, k, v, g, beta, lengths, chunk)))
    del calls
    check(max(core) <= KDA_TOL, f"phase 4k: kda {max(core):.3g} from the plain version on its "
                                f"own inputs (tol {KDA_TOL})")
    worst = {k: float(f"{max(v):.3g}") for k, v in errs.items()}
    print(f"phase 4k: Kimi-Linear (published widths, {KLIN_LAYERS} layers, 128 of 256 experts "
          f"held, bf16): {KLIN_BATCHES} batches of {KLIN_ROWS} documents ({tokens} tokens, padded "
          f"to {seq}) through Pipeline in {seconds:.3f} s (the comparisons included), all to the "
          f"final classifier; launches {launches}; each call against its plain version on its "
          f"own inputs: kda at most {max(core):.3g} of scale (tol {KDA_TOL}), the elementwise "
          f"kernels {worst} (tol {ELEMENTWISE_TOL}), the held share's routed experts "
          f"{max(routed):.3g} relative L2 (tol {MOON_TOL}; without their weights "
          f"{min(unweighted):.3g} at least)")
    del model, pipe
    torch.cuda.empty_cache()
    return launches


def phase_tiny(card: str, head_dim: int = 16):
    """Phase 4t: the tiny config (4 heads of 16: the kernels take the head
    dim zero-padded to 64), or at the wider heads of ``WIDE_HEADS`` (96,
    padded to 128, 128, and the wide mode's 192 and 256), served and trained
    on the card, gated against the f32 plain path on the CPU."""
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
    from multi_modal_early_exit_tpu_torch.utils.profiling import launch_counts

    backbone = LayoutLMv3Config.tiny(num_labels=16)
    if head_dim != 16:
        widths = WIDE_HEADS[head_dim]
        backbone = backbone.replace(intermediate_size=2 * widths["hidden_size"], **widths)
    cfg = EEModelConfig(
        backbone=backbone,
        exit=ExitConfig(exits="text_avg,1", training_strategy="one_stage_subgraphs_weighted"),
    )
    bb = cfg.backbone
    layers = bb.num_hidden_layers
    check(bb.hidden_size // bb.num_attention_heads == head_dim, f"tiny config head dim "
          f"{bb.hidden_size // bb.num_attention_heads}, not {head_dim}")
    model32 = init_ee_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(2)
    tok = HashWordTokenizer(vocab_size=bb.vocab_size)
    n_batches, seq = 2, 32
    feats, pages = synthetic_pages(n_batches * B, rng, tok, seq)
    data = {k: torch.from_numpy(v) for k, v in feats.items()}
    data["pixel_values"] = preprocess_images(torch.from_numpy(pages).cuda(),
                                             size=bb.input_size).cpu()
    keys = ("input_ids", "bbox", "pixel_values", "attention_mask")
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
        ran = launched(before)
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
    ran = launched(before)
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


ANYTIME_DOCS = 256  # phase 6's test and validation documents each


def phase_anytime(card: str, served):
    """Phase 6: the anytime evaluation of the paper on the card. Phase 4's
    bf16 model (its heads as phase 4 re-centred them) harvests the exit
    logits of ``build_synthetic``'s test and validation splits (256
    documents each, 512 tokens, 224-pixel pages, 16 labels) with
    ``get_logits`` at batch 16; the f32 model harvests 8 documents against
    the f32 plain path on the CPU; ``calibrate`` fits the per-exit
    temperatures; ``full_test_iteration`` sweeps the global thresholds
    0.05-0.95 with the FLOPs analysis and ``evaluate_checkpoint`` reads the
    dumped store back; ``mixture_pareto_sweep`` evaluates a million per-exit
    threshold mixtures on the card and with the native backend, bit-equal.
    Every file goes to a temporary directory. Returns the harvest's launches
    (counts set to 0 just before it)."""
    import tempfile

    from multi_modal_early_exit_tpu_torch.data.datasets import build_synthetic
    from multi_modal_early_exit_tpu_torch.data.loader import iterate_batches
    from multi_modal_early_exit_tpu_torch.evaluation.analysis import Analysis
    from multi_modal_early_exit_tpu_torch.evaluation.pipeline import (
        SEQ_PAD_MULTIPLE,
        calibrate,
        evaluate_checkpoint,
        full_test_iteration,
        get_logits,
    )
    from multi_modal_early_exit_tpu_torch.evaluation.policy import Policy
    from multi_modal_early_exit_tpu_torch.evaluation.thresholds import mixture_pareto_sweep
    from multi_modal_early_exit_tpu_torch.models.ee.model import ee_forward
    from multi_modal_early_exit_tpu_torch.utils.profiling import launch_counts

    model, cfg = served["model"], served["cfg"]
    n_exits = len(cfg.exit.exits) + 1
    t0 = time.perf_counter()
    kw = dict(n_eval=ANYTIME_DOCS, num_labels=16, seq_len=S_TEXT, image_size=224)
    test, val = build_synthetic("test", **kw), build_synthetic("validation", **kw)
    print(f"anytime: build_synthetic, {ANYTIME_DOCS} test + {ANYTIME_DOCS} validation "
          f"documents, {time.perf_counter() - t0:.1f} s (host)")
    first = next(iterate_batches(test, B))
    cols = [torch.from_numpy(first[k]).cuda() for k in
            ("input_ids", "bbox", "pixel_values", "attention_mask")]
    with torch.inference_mode():  # warm-up batch
        ee_forward(model, cfg, *cols, seq_pad_multiple=SEQ_PAD_MULTIPLE)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as root:
        config = {"checkpoint": "chip-smoke-base", "test_dataset": "synthetic_rvl_cdip",
                  "labelset": "test", "exit_policy": "max_confidence_global_thresholding_policy"}
        before = launch_counts()
        store, refs, stats = get_logits(model, cfg, test, config, batch_size=B, root=root)
        n_batches = -(-ANYTIME_DOCS // B)
        want = {"materialize_bias": n_batches,
                "flash_attention_packed": cfg.backbone.num_hidden_layers * n_batches}
        launches = launched(before, want)
        check(launches == want, f"the harvest launched {launches}, not {want}")
        check(store.shape == (n_exits, ANYTIME_DOCS, 16) and store.dtype == np.float64
              and bool(np.isfinite(store).all()), f"the harvested store {store.shape}")
        with torch.inference_mode():  # two batches' rows against the direct forward
            for i, batch in enumerate(iterate_batches(test, B)):
                if i == 2:
                    break
                c = [torch.from_numpy(batch[k]).cuda() for k in
                     ("input_ids", "bbox", "pixel_values", "attention_mask")]
                direct = ee_forward(model, cfg, *c, seq_pad_multiple=SEQ_PAD_MULTIPLE)
                direct = direct.policy_logits().to(torch.float64).cpu().numpy()
                real = int(batch["sample_mask"].sum())
                check(np.array_equal(store[:, i * B:i * B + real], direct[:, :real]),
                      f"the store's batch {i} differs from ee_forward's policy logits")
        ms = device_ms(lambda: ee_forward(model, cfg, *cols, seq_pad_multiple=SEQ_PAD_MULTIPLE),
                       {"attention": ("fwd_kernel<",), "bias": ("materialize_bias_kernel",)})
        val_store, val_refs, _ = get_logits(model, cfg, val, dict(config, labelset="validation"),
                                            batch_size=B, root=root)
        print(f"anytime harvest: ({n_exits}, {ANYTIME_DOCS}, 16) f64 store, "
              f"{stats['docs_per_sec']:.1f} docs/sec (host clock, after a warm-up batch, "
              f"batch {B}), launches {launches} ({n_batches} batches), 2 batches bit-equal "
              f"to ee_forward; one batch traced: {ms['all']:.3f} device ms, the attention "
              f"{ms['attention']:.3f}, the bias build {ms['bias']:.3f}; on {card}")

        # the f32 model on 8 documents against the f32 plain path on the CPU
        model32 = copy.deepcopy(model).to(torch.float32)
        few = test.select(np.arange(8))
        got32 = get_logits(model32, cfg, few, {}, batch_size=8, use_cache=False)[0]
        cpu32 = get_logits(copy.deepcopy(model32).cpu(), cfg, few, {}, batch_size=8,
                           use_cache=False, device="cpu")[0]
        del model32
        err32 = float(np.abs(got32 - cpu32).max())
        check(f32_close(torch.from_numpy(got32), torch.from_numpy(cpu32)),
              f"f32 harvest vs the f32 plain path: {err32} (atol 2e-4, rtol 1e-3)")
        msp = lambda x: np.max(np.exp(x - x.max(-1, keepdims=True))
                               / np.exp(x - x.max(-1, keepdims=True)).sum(-1, keepdims=True), -1)
        thr = widest_gap_threshold(msp(cpu32[:-1]).ravel(), 0.3, 0.7)
        cfg_p = {"exit_threshold": thr}
        far = np.all(np.abs(msp(cpu32) - thr) > 1e-4, axis=0)
        gpu_exits = Policy(got32, cfg_p).max_confidence_global_thresholding_policy()[0]
        cpu_exits = Policy(cpu32, cfg_p).max_confidence_global_thresholding_policy()[0]
        check(bool((gpu_exits[far] == cpu_exits[far]).all()), f"f32 exits differ from the "
              f"CPU's: {gpu_exits.tolist()} vs {cpu_exits.tolist()}")

        # per-exit temperatures, the threshold sweep, the offline evaluation
        t0 = time.perf_counter()
        calibrated = calibrate(store, val_store, val_refs, config, root=root)
        temps = config["calibration_metrics"]["temperature"]
        check(len(temps) == n_exits and all(math.isfinite(t) and t > 0 for t in temps),
              f"temperatures {temps}")
        analysis = Analysis(model, cfg)
        sweep_cfg = dict(config, calibrate=True)
        logs = full_test_iteration(calibrated, refs, sweep_cfg, 0.05, 0.05, analysis, root=root)
        out_dir = os.path.join(root, "chip-smoke-base-synthetic_rvl_cdip", sweep_cfg["exit_policy"])
        check(len(logs) == 19 and os.path.exists(os.path.join(out_dir, "calibrated-metrics.json")),
              f"full_test_iteration wrote {len(logs)} entries")
        evaluate_checkpoint(os.path.join(root, "chip-smoke-base-synthetic_rvl_cdip"))
        check(os.path.exists(os.path.join(root, "chip-smoke-base-synthetic_rvl_cdip",
                                          "results.json")), "evaluate_checkpoint wrote nothing")
        eval_s = time.perf_counter() - t0
        best = max(logs, key=lambda r: r["accuracy"])

        # a million per-exit threshold mixtures: the card and the native
        # backend, bit-equal (sums of 0/1 and of exit ids over 256
        # documents are exact in f32)
        sweeps, secs = {}, {}
        for backend, dev in (("torch", "cuda"), ("native", None)):
            t0 = time.perf_counter()
            sweeps[backend] = mixture_pareto_sweep(store, refs, num_mixtures=1_000_000,
                                                   backend=backend, device=dev)
            secs[backend] = time.perf_counter() - t0
        for key in ("accuracy", "average_exit"):
            check(np.array_equal(sweeps["torch"][key], sweeps["native"][key]),
                  f"mixture sweep {key}: the torch backend differs from the native one")
    print(f"anytime evaluation: f32 harvest of 8 documents vs the CPU's max diff {err32:.3e} "
          f"(atol 2e-4 / rtol 1e-3), exits equal for {int(far.sum())}/8 documents farther "
          f"than 1e-4 from threshold {thr:.4f}; temperatures {[round(t, 4) for t in temps]}; "
          f"{len(logs)} thresholds swept and results.json written in {eval_s:.1f} s (host), "
          f"best accuracy {best['accuracy']:.4f} at {best['exit_threshold']:.2f} "
          f"({best['#GFLOPs used']:.1f} of {best['#GFLOPs total']:.1f} GFLOPs); 1,000,000 "
          f"mixtures: torch on the card {secs['torch']:.2f} s, native {secs['native']:.2f} s "
          f"(host clock, grid and mixtures included), accuracy and average exit bit-equal; "
          f"on {card}")
    return launches


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


# the kernels no training step runs: the serving-only fused attention and
# the no-grad path's LayerNorm (phases 4, 4b, 4f and 8a count that)
SERVING_ONLY = ("fused_bias_attention", "add_layer_norm")


def launched(before, kernels=None):
    """Each kernel's launches since ``before`` (a ``utils.profiling.
    launch_counts()``): of each of ``kernels`` (0 for one that did not
    launch), or without ``kernels`` of each that launched, but
    ``SERVING_ONLY``."""
    from multi_modal_early_exit_tpu_torch.utils.profiling import launch_counts

    now = launch_counts()
    if kernels is not None:
        return {k: now.get(k, 0) - before.get(k, 0) for k in kernels}
    return {k: n - before.get(k, 0) for k, n in now.items()
            if n > before.get(k, 0) and k not in SERVING_ONLY}


def train_steps(cfg, model32, batches, args, want, trace=None):
    """One warm-up ``EETrainer.train_step``, then one on each further batch,
    timed, with the launch counts per step checked against ``want`` (every
    kernel it does not name: 0). With ``trace`` (groups of kernel-name
    fragments, as ``device_ms`` takes them), one more step on the last batch
    under torch.profiler: the device ms by group and of all kernels. Returns
    the readings."""
    n_steps = len(batches) - 1
    from multi_modal_early_exit_tpu_torch.training.trainer import EETrainer
    from multi_modal_early_exit_tpu_torch.utils.profiling import launch_counts

    trainer = EETrainer(cfg, copy.deepcopy(model32), args, total_steps=1000, device="cuda")
    gen = torch.Generator().manual_seed(1)
    t0 = time.perf_counter()
    warm = trainer.train_step(batches[0], gen)[0]
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    probe = {n: p.detach().clone() for n, p in trainer.model.named_parameters()
             if n.endswith(("layers.0.attention.query.weight", "rel_pos_bias",
                            "classifier.out_proj.weight", "visual.patch_embed.weight"))}
    before = launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [trainer.train_step(b, gen)[0] for b in batches[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = launched(before)
    check(all(math.isfinite(x) for x in [warm] + losses), f"non-finite losses {losses}")
    moved = [n for n, before in probe.items()
             if not torch.equal(before, dict(trainer.model.named_parameters())[n].detach())]
    check(len(moved) == len(probe), f"parameters that did not move: {set(probe) - set(moved)}")
    for name in set(launches) | set(want):
        check(launches.get(name, 0) == want.get(name, 0) * n_steps,
              f"{name}: {launches.get(name, 0)} launches in {n_steps} steps")
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


def phase_train_default(card: str, trained):
    """Phase 5c: the JAX package's default schedule, ``scan_fold=1``, at
    attention dropout 0: the gradient check, whose launches show that it
    ran ``flash_attention_packed`` and the head-form pair in every layer,
    against phase 5's CPU reference and its chained gradients on the card,
    then 1 + 3 steps. Returns (launches, the check's (loss, gradients), the steps'
    readings)."""
    from multi_modal_early_exit_tpu_torch.utils.profiling import launch_counts

    t = trained
    cfg = t["cfg"].replace(backbone=t["cfg"].backbone.replace(
        scan_fold=1, attention_probs_dropout_prob=0.0))
    model32 = t["model32"]
    before = launch_counts()
    _, (loss, grads) = train_gradient_check(cfg, model32, t["batches"][0], t["weights"],
                                            t["reference"])
    ran = launched(before)
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
    from multi_modal_early_exit_tpu_torch.utils.profiling import launch_counts

    t = trained
    model32, batch, weights = t["model32"], t["batches"][0], t["weights"]
    total = {}
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
        ran = launched(before)
        check(ran == want, f"the f32 scan_fold={fold} gradient check launched {ran}, not {want}")
        for name, n in ran.items():
            total[name] = total.get(name, 0) + n
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
        total[name] = total.get(name, 0) + n
    ms = run["traced"]
    print(f"trained in f32 (TrainingArguments(bf16=False), scan_fold=1, dropout "
          f"{cfg.backbone.attention_probs_dropout_prob}): {beside_phase_5(run, base, '5c')}; "
          f"one more step traced: the f32 attention {ms['forward'] + ms['backward'] + ms['split']:.3f} "
          f"device ms of {ms['all']:.3f} (the forward kernel {ms['forward']:.3f}, the dq/dbias and "
          f"dk/dv kernels {ms['backward']:.3f}, the split pre-passes of both {ms['split']:.3f}), "
          f"on {card}")
    return total

# phase 7's run of cli.train: EE LayoutLMv3-base at __graft_entry__.py's
# widths, random weights, the synthetic RVL-CDIP splits (64 training, 32
# validation and 32 test documents of 512 tokens and 224-pixel pages)
CLI_TRAIN = ["with", "model_size=base", "dataset=synthetic_rvl_cdip", "model_weights=",
             "epochs=2", "batch_size=16", "eval_batch_size=16", "compute_dtype=bfloat16",
             "exits=text_avg,vision_avg,7", "training_strategy=one_stage_subgraphs_weighted",
             "lr=2e-5", "output_dir=save"]
CLI_STEP_LAUNCHES = {"materialize_bias": 1, "table_grads": 2, "flash_attention_packed_train": 12,
                     "flash_attention_packed_train_bwd": 24}
# cli.evaluate harvests with the checkpoint's f32 weights, as the JAX
# package's does: a batch splits k and v before every attention call
CLI_BATCH_LAUNCHES = {"materialize_bias": 1, "flash_attention_packed": 12, "split_bf16x3": 12}


def phase_cli(card: str):
    """Phase 7: the command-line path at full width, in a temporary
    directory that it removes. ``cli.train`` (``CLI_TRAIN``: 2 epochs of 4
    steps at the default schedule, a checkpoint per epoch), a resume from a
    checkpoint saved with its optimizer state (2 steps bit-equal to the
    same 2 steps without the save), 2 steps with the bf16 first moment,
    ``cli.evaluate`` on the best checkpoint (dump, then a full sweep with
    calibration), ``cli.research`` over the dump on the torch and the
    native backends (the Pareto fronts bit-equal) and
    ``Pipeline.from_checkpoint`` (bit-equal to a ``Pipeline`` over the same
    state dict in memory). Returns the launches of the kernels over the
    phase's train and evaluate calls."""
    import shutil
    import tempfile

    from multi_modal_early_exit_tpu_torch.cli import evaluate as cli_evaluate
    from multi_modal_early_exit_tpu_torch.cli import research as cli_research
    from multi_modal_early_exit_tpu_torch.cli import train as cli_train
    from multi_modal_early_exit_tpu_torch.config.experiment import parse_cli
    from multi_modal_early_exit_tpu_torch.data.datasets import build_dataset
    from multi_modal_early_exit_tpu_torch.data.loader import iterate_batches
    from multi_modal_early_exit_tpu_torch.models.ee.model import EEModel
    from multi_modal_early_exit_tpu_torch.serving import Pipeline
    from multi_modal_early_exit_tpu_torch.training import checkpoint as ckpt
    from multi_modal_early_exit_tpu_torch.training.trainer import EETrainer, TrainingArguments
    from multi_modal_early_exit_tpu_torch.utils.profiling import launch_counts

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    cwd = os.getcwd()
    os.chdir(tmp)
    start = launch_counts()
    try:
        # 1. train: each step timed, its launches counted, by wrapping the
        # trainer's step; each checkpoint's validation accuracy recorded
        steps, saves = [], []
        step_fn, save_fn = EETrainer.train_step, ckpt.CheckpointManager.save

        def timed_step(self, batch, rng):
            torch.cuda.synchronize()
            before = launch_counts()
            t0 = time.perf_counter()
            out = step_fn(self, batch, rng)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0, out[0], launched(before)))
            return out

        def recorded_save(self, epoch, state_dict, config=None, opt_state=None, metric=None,
                          **kwargs):
            saves.append((epoch, metric))
            return save_fn(self, epoch, state_dict, config, opt_state, metric, **kwargs)

        EETrainer.train_step, ckpt.CheckpointManager.save = timed_step, recorded_save
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            metrics = cli_train.main(list(CLI_TRAIN))
            t_train = time.perf_counter() - t0
        finally:
            EETrainer.train_step, ckpt.CheckpointManager.save = step_fn, save_fn
        train_peak = torch.cuda.max_memory_allocated() / 2 ** 20
        check(len(steps) == 8, f"cli.train took {len(steps)} steps, not 8")
        check(all(math.isfinite(loss) for _, loss, _ in steps),
              f"cli.train losses {[loss for _, loss, _ in steps]}")
        for _, _, ran in steps:
            check(ran == CLI_STEP_LAUNCHES, f"a cli.train step launched {ran}, not "
                  f"{CLI_STEP_LAUNCHES}")
        check(set(metrics) == {"accuracy", "exit_0_accuracy", "exit_1_accuracy",
                               "exit_2_accuracy", "exit_0_share", "exit_1_share",
                               "exit_2_share", "exit_3_share"},
              f"cli.train's test metrics {sorted(metrics)}")
        run_dir = os.path.join("save", cli_train.experiment_name(parse_cli(list(CLI_TRAIN))))
        ckpts = sorted(os.listdir(run_dir))
        check(ckpts == ["checkpoint-0", "checkpoint-1"] and all(
            os.path.exists(os.path.join(run_dir, c, "config.json")) for c in ckpts),
            f"cli.train wrote {ckpts}")
        best_epoch = max(saves, key=lambda x: (x[1], -x[0]))[0]  # the first best, as the manager
        best = os.path.join(run_dir, f"checkpoint-{best_epoch}")
        timed = [dt for dt, _, _ in steps]
        print(f"cli.train (EE LayoutLMv3-base, bf16, batch 16, scan_fold 1, dropout 0.1): 8 steps "
              f"of {[round(t, 4) for t in timed]} s, {16 * len(timed[1:]) / sum(timed[1:]):.1f} "
              f"train docs/sec after the first step (host clock), losses "
              f"{[round(x, 4) for _, x, _ in steps]}, launches per step {CLI_STEP_LAUNCHES}, "
              f"{t_train:.1f} s with evaluation and checkpoints, peak memory {train_peak:.1f} MiB, "
              f"test metrics {json.dumps({k: round(float(v), 4) for k, v in metrics.items()})}, "
              f"best {best}, on {card}")

        # 2. resume: a trainer built from a checkpoint saved with its optimizer
        # state takes the 2 steps that one which kept going takes, bit for bit
        cfg = parse_cli(list(CLI_TRAIN))
        train_ds = build_dataset(cfg.dataset, "train")
        batches = [{k: v[None] for k, v in b.items() if k != "sample_mask"}
                   for b in iterate_batches(train_ds, 16, drop_last=True)]
        model_cfg, model = cli_evaluate.load_assets(parse_cli(["-c", best] + CLI_TRAIN[1:]))[1:]
        args = TrainingArguments(learning_rate=cfg.lr, bf16=True)
        going = EETrainer(model_cfg, model, args, total_steps=8)
        gen = torch.Generator().manual_seed(3)
        for b in batches[:2]:
            going.train_step(b, gen)
        ckpt.save_checkpoint("resume", going.model.state_dict(), cfg.to_dict(),
                             going.optimizer.state_dict(), step=2)
        state, _, opt_state, step = ckpt.load_checkpoint("resume", with_opt_state=True)
        check(step == 2 and opt_state is not None, "the resume checkpoint lost its step or state")
        fresh = EEModel(model_cfg, device="cpu")
        fresh.load_state_dict(state, strict=True)
        resumed = EETrainer(model_cfg, fresh, args, total_steps=8)
        resumed.optimizer.load_state_dict(opt_state)
        gen_resumed = torch.Generator()
        gen_resumed.set_state(gen.get_state())
        for b in batches[2:4]:
            going.train_step(b, gen)
            resumed.train_step(b, gen_resumed)
        torch.cuda.synchronize()
        a, b_ = going.model.state_dict(), resumed.model.state_dict()
        differ = [k for k in a if not torch.equal(a[k], b_[k])]
        check(not differ, f"the resumed trainer's parameters differ in {differ[:5]}")
        del going, resumed, fresh, model, state, opt_state, a, b_

        # 3. the bf16 first moment: 2 steps beside the f32 moment's
        peaks, moments = {}, {}
        for bf16_momentum in (False, True):
            model = cli_evaluate.load_assets(parse_cli(["-c", best] + CLI_TRAIN[1:]))[2]
            trainer = EETrainer(model_cfg, model, TrainingArguments(
                learning_rate=cfg.lr, bf16=True, bf16_momentum=bf16_momentum), total_steps=8)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses = [trainer.train_step(b, torch.Generator().manual_seed(4))[0]
                      for b in batches[:2]]
            torch.cuda.synchronize()
            peaks[bf16_momentum] = torch.cuda.max_memory_allocated() / 2 ** 20
            check(all(math.isfinite(x) for x in losses), f"bf16_momentum={bf16_momentum} "
                  f"losses {losses}")
            mu = {st["exp_avg"].dtype for st in trainer.optimizer.adamw.state.values()}
            moments[bf16_momentum] = sum(st["exp_avg"].numel() * st["exp_avg"].element_size()
                                         for st in trainer.optimizer.adamw.state.values())
            want_mu = torch.bfloat16 if bf16_momentum else torch.float32
            check(mu == {want_mu}, f"bf16_momentum={bf16_momentum}: first moments in {mu}")
            del trainer, model
            torch.cuda.empty_cache()
        print(f"bf16_momentum: 2 steps, peak memory {peaks[True]:.1f} MiB against "
              f"{peaks[False]:.1f} MiB with the f32 first moment (moments "
              f"{moments[True] / 2 ** 20:.1f} against {moments[False] / 2 ** 20:.1f} MiB), "
              f"on {card}")

        # 4. evaluate the best checkpoint: dump, then a full sweep with calibration
        ev_args = ["-c", best, "-d", "synthetic_rvl_cdip", "with", "eval_batch_size=16"]
        readings = {}
        for mode, extra in (("dump", []), ("full_test", [
                "--full_test", "True", "--calibrate", "True", "--exit_threshold", "0.05",
                "--step", "0.05"])):
            before = launch_counts()
            t0 = time.perf_counter()
            out = cli_evaluate.main(ev_args[:4] + extra + ev_args[4:])
            dt = time.perf_counter() - t0
            ran = launched(before)
            # the dump harvests the 32 test documents, the sweep the 32
            # validation ones (the test store comes from the dump): 2 batches
            want = {n: 2 * c for n, c in CLI_BATCH_LAUNCHES.items()}
            check(out["mode"] == mode and ran == want, f"cli.evaluate {mode}: {out}, launched "
                  f"{ran}, not {want}")
            readings[mode] = round(dt, 3)
        root = os.path.join("results", f"{os.path.basename(best)}-synthetic_rvl_cdip")
        store = np.load(os.path.join(root, "exit_logits-test.npz"))["arr_0"]
        check(store.shape == (4, 32, 16) and store.dtype == np.float64
              and bool(np.isfinite(store).all()), f"dumped store {store.shape} {store.dtype}")
        with open(os.path.join(root, "config.json")) as f:
            temps = json.load(f)["calibration_metrics"]["temperature"]
        check(all(math.isfinite(t) and t > 0 for t in temps), f"temperatures {temps}")
        with open(os.path.join(root, "max_confidence_global_thresholding_policy",
                               "calibrated-metrics.json")) as f:
            results = json.load(f)
        thresholds = np.arange(0.05, 1, 0.05)
        check(len(results) == len(thresholds), f"{len(results)} sweep results for "
              f"{len(thresholds)} thresholds")

        # 5. research over the dump: torch on the card, then native
        fronts, seconds = {}, {}
        for backend in ("torch", "native"):
            t0 = time.perf_counter()
            cli_research.main(["--checkpoint-dir", root, "--num-mixtures", "1000000",
                               "--backend", backend])
            seconds[backend] = round(time.perf_counter() - t0, 3)
            with open(os.path.join(root, "mixture_search.json")) as f:
                fronts[backend] = json.load(f)["pareto"]
        check(fronts["torch"] == fronts["native"] and fronts["torch"],
              "the torch and native mixture searches' Pareto fronts differ")

        # 6. Pipeline.from_checkpoint against a Pipeline over the same state dict
        pipe = Pipeline.from_checkpoint(best, batch_size=16)
        state, _, _, _ = ckpt.load_checkpoint(best)
        in_memory = EEModel(model_cfg, device="cpu")
        in_memory.load_state_dict(state, strict=True)
        ref = Pipeline(in_memory, model_cfg, batch_size=16)
        check(pipe.cfg.backbone == model_cfg.backbone, "from_checkpoint's backbone config "
              "differs from the trained model's")
        test_ds = build_dataset(cfg.dataset, "test")
        feats = {k: test_ds.arrays[k] for k in ("input_ids", "bbox", "attention_mask",
                                                "pixel_values")}
        got, want = pipe.predict_features(feats), ref.predict_features(feats)
        check(len(got) == 32 and got == want, "Pipeline.from_checkpoint's predictions differ "
              "from the in-memory Pipeline's")
        print(f"cli.evaluate on {best}: dump {readings['dump']} s, full sweep with calibration "
              f"{readings['full_test']} s ({len(results)} thresholds), store {store.shape} "
              f"float64, temperatures {[round(t, 4) for t in temps]}, launches per harvested "
              f"batch {CLI_BATCH_LAUNCHES}; cli.research, 10^6 mixtures: torch "
              f"{seconds['torch']} s, native {seconds['native']} s, Pareto fronts bit-equal "
              f"({len(fronts['torch'])} points); Pipeline.from_checkpoint bit-equal to the "
              f"in-memory Pipeline on 2 batches; on {card}")
        return launched(start)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)


# phase 8a: LayoutLMv2-base at full width through the user's entry points
V2_DOCS = 64  # the harvest's synthetic documents (4 batches of 16)
V2_TRAIN = ["with", "model=layoutlmv2", "model_size=base", "dataset=synthetic_rvl_cdip",
            "model_weights=", "epochs=1", "batch_size=16", "eval_batch_size=16",
            "compute_dtype=bfloat16", "lr=2e-5", "output_dir=save"]
# v2 takes the plain bias tensor in every layer: the training forward, the
# unchained backward (2 kernels a call) and the tables' backward (2)
V2_STEP_LAUNCHES = {"materialize_bias": 1, "table_grads": 2, "flash_attention_packed_train": 12,
                    "flash_attention_packed_train_bwd": 24}
# a batch's LayerNorms (add_layer_norm): the text and visual norms and two
# in each of the 12 layers
V2_BATCH_LAUNCHES = {"materialize_bias": 1, "flash_attention_packed": 12, "add_layer_norm": 26}


def v2_loss_grads(model, cfg, batch, device, dtype):
    """(loss, gradients) of ``sequence_classification_loss`` on the first 2
    documents of a training batch, at dropout 0 (deterministic), on
    ``device`` in the compute dtype ``dtype``."""
    from multi_modal_early_exit_tpu_torch.models.layoutlmv2.modeling import (
        sequence_classification_loss,
    )

    small = {k: v[:2].to(device) for k, v in batch.items()}
    loss, _ = sequence_classification_loss(model, cfg, small, deterministic=True,
                                           compute_dtype=dtype, device=device)
    params = [p for _, p in model.named_parameters()]
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.item(), [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]


def compare_path_kernels(args, gen, training: bool, heads: int = HEADS) -> str:
    """The kernels of a phase-8 or phase-9 path against their plain versions
    at that path's shapes (``args``: its seven bias inputs, B x S, P = S
    rounded up to 128, the tables' columns one per head; bf16 q/k/v of
    ``heads`` heads of 64 from ``gen``), at phase 3's
    tolerances: ``materialize_bias`` bit-equal, ``flash_attention_packed``
    within 1e-2; with ``training``, also the training forward at dropout
    ``TRAIN_RATE`` (out within 2e-2, lse within 1e-3), its plain (unchained)
    backward (dq/dk/dv/dbias within 2e-2 of each output's scale, dbias 0 in
    the pad rows) and ``table_grads`` on that dbias (within 1e-4 of the
    largest table gradient). Returns a summary of the readings."""
    from multi_modal_early_exit_tpu_torch.ops.flash_attention import (
        flash_attention_packed,
        flash_attention_packed_plain,
        flash_attention_packed_train_bwd,
        flash_attention_packed_train_bwd_plain,
        flash_attention_packed_train_fwd,
        flash_attention_packed_train_fwd_plain,
    )
    from multi_modal_early_exit_tpu_torch.ops.fused_bias_attention import (
        materialize_bias,
        materialize_bias_plain,
        table_grads,
        table_grads_plain,
    )

    dev, (b, s) = args[0].device, args[0].shape
    bias = materialize_bias(*args)
    check(torch.equal(bias, materialize_bias_plain(*args)),
          f"materialize_bias differs from its plain version (B {b}, S {s})")
    check(bias.shape[1] == heads, f"materialize_bias built {bias.shape[1]} heads, not {heads}")
    q, k, v = (torch.randn((b, s, heads * HEAD_DIM), generator=gen).to(dev, torch.bfloat16)
               for _ in range(3))
    err = (flash_attention_packed(q, k, v, bias, heads).float()
           - flash_attention_packed_plain(q, k, v, bias, heads).float()).abs().max().item()
    check(err <= 1e-2, f"flash_attention_packed max error {err} > 1e-2 (B {b}, S {s})")
    read = (f"B {b}, H {heads}, S {s} inside P {bias.shape[-1]}: materialize_bias bit-equal, "
            f"flash_attention_packed max error {err:.3e} (tol 1e-2)")
    if not training:
        return read
    out, lse = flash_attention_packed_train_fwd(q, k, v, bias, 1234, heads, TRAIN_RATE)
    ref_out, ref_lse = flash_attention_packed_train_fwd_plain(q, k, v, bias, 1234, heads,
                                                              TRAIN_RATE)
    out_err = (out.float() - ref_out.float()).abs().max().item()
    lse_err = (lse[:, :, :s] - ref_lse[:, :, :s]).abs().max().item()
    check(out_err <= 2e-2 and lse_err <= 1e-3, f"train forward out {out_err} (tol 2e-2), lse "
          f"{lse_err} (tol 1e-3) (B {b}, S {s})")
    do = (torch.randn(out.shape, generator=gen) * 0.1).to(dev, torch.bfloat16)
    bwd_args = (q, k, v, bias, 1234, out, lse, do, heads, TRAIN_RATE)
    got = flash_attention_packed_train_bwd(*bwd_args)
    want = flash_attention_packed_train_bwd_plain(*bwd_args)
    errs = {}
    for what, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        check(bool(torch.isfinite(a.float()).all()), f"train backward {what} not finite")
        errs[what] = scaled_err(a, w)
        check(errs[what] <= 2e-2, f"train backward {what} {errs[what]} of its scale > 2e-2 "
              f"(B {b}, S {s})")
    check(not got[3][:, :, s:, :].any(), "train backward: dbias is not 0 in the pad rows")
    tg = max(scaled_err(a, w) for a, w in zip(table_grads(*args[:3], got[3]),
                                              table_grads_plain(*args[:3], got[3])))
    check(tg <= 1e-4, f"table_grads error {tg} > 1e-4 of its scale (B {b}, S {s})")
    return (f"{read}; flash_attention_packed_train out {out_err:.3e} (tol 2e-2), lse "
            f"{lse_err:.3e} (tol 1e-3); its backward "
            + ", ".join(f"{w} {e:.3e}" for w, e in errs.items())
            + f" of scale (tol 2e-2), dbias 0 in the pad; table_grads {tg:.3e} of scale "
            f"(tol 1e-4)")


def phase_v2(card: str):
    """Phase 8a: LayoutLMv2-base at full width (12 layers, hidden 768, 12
    heads of 64, the ResNeXt-101 32x8d FPN tower at 224 pixels, 512 text
    tokens + 49 visual, 16 labels; random weights from ``build_model``'s
    seed). Its kernels against their plain versions at its shapes
    (``compare_path_kernels``); ``get_logits`` harvests ``V2_DOCS`` synthetic documents in bf16
    at batch 16 (a (1, N, 16) store, rows bit-equal to
    ``forward_sequence_classification``'s, 1 #1 and 12 #2 a batch); the f32
    model's logits on 4 documents against the f32 plain path on the CPU;
    ``cli.train.main`` with ``model=layoutlmv2`` (1 + 3 steps at dropout
    0.1, batch 16, the launches of each step); the gradients of one loss on
    2 documents at dropout 0 against the f32 plain path on the CPU (bf16:
    the relative L2 bar over every tensor, ``GRAD_LIMITS`` outside the
    visual tower; f32: ``F32_GRAD_LIMITS`` outside the tower). Returns the launches of the harvest and of the steps
    by kernel (counts set to 0 before each)."""
    import shutil
    import tempfile

    from multi_modal_early_exit_tpu_torch.cli import train as cli_train
    from multi_modal_early_exit_tpu_torch.config.experiment import parse_cli
    from multi_modal_early_exit_tpu_torch.data.datasets import build_dataset, build_synthetic
    from multi_modal_early_exit_tpu_torch.data.loader import iterate_batches
    from multi_modal_early_exit_tpu_torch.evaluation.pipeline import SEQ_PAD_MULTIPLE, get_logits
    from multi_modal_early_exit_tpu_torch.models.layoutlmv2.modeling import (
        forward_sequence_classification,
        sequence_layout,
        visual_backbone_apply,
    )
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import (
        bias_tables,
        bias_vectors,
    )
    from multi_modal_early_exit_tpu_torch.models.registry import build_model
    from multi_modal_early_exit_tpu_torch.training.trainer import EETrainer
    from multi_modal_early_exit_tpu_torch.utils.profiling import launch_counts

    exp = parse_cli(V2_TRAIN)
    t0 = time.perf_counter()
    cfg, model32 = build_model(exp.replace(device="cpu"), num_labels=16, image_size=224,
                               seq_len=S_TEXT)
    n_params = sum(p.numel() for p in model32.parameters())
    tower = sum(p.numel() for p in model32.visual_backbone.parameters())
    check((cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads,
           cfg.backbone_depths, cfg.backbone_groups) == (768, 12, 12, (3, 4, 23, 3), 32),
          f"not LayoutLMv2-base: {cfg}")
    model = copy.deepcopy(model32).to("cuda", torch.bfloat16)
    print(f"LayoutLMv2-base: {n_params / 1e6:.1f}M params ({tower / 1e6:.1f}M in the "
          f"ResNeXt-101 32x8d FPN tower), vocab {cfg.vocab_size}, init "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- serving: get_logits over V2_DOCS documents, bf16, batch 16 ------
    docs = build_synthetic("test", n_eval=V2_DOCS, num_labels=16, seq_len=S_TEXT,
                           image_size=224)
    keys = ("input_ids", "bbox", "pixel_values", "attention_mask")
    first = next(iterate_batches(docs, B))
    cols = [torch.from_numpy(first[k]).cuda() for k in keys]
    # the path's kernels at its shapes: the first batch's sequence, S = 561
    # (P = 640), the model's unscaled tables
    full_bbox, pos, full_mask = sequence_layout(cfg, cols[1], cols[3], cfg.num_visual_tokens)
    enc_cfg = cfg.encoder_cfg()
    bias_args = (*bias_vectors(pos, full_bbox, full_mask),
                 *bias_tables(model32, enc_cfg, "cpu"))
    read = compare_path_kernels([a.cuda() for a in bias_args], torch.Generator().manual_seed(8),
                                training=True)
    print(f"v2 kernels against their plain versions at the path's shapes: {read}")
    with torch.inference_mode():  # warm-up batch
        forward_sequence_classification(model, cfg, *cols, seq_pad_multiple=SEQ_PAD_MULTIPLE)
    torch.cuda.synchronize()
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats()
    store, refs, stats = get_logits(model, cfg, docs, {}, batch_size=B, use_cache=False)
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    harvest = launched(before)
    harvest["add_layer_norm"] = launched(before, ("add_layer_norm",))["add_layer_norm"]
    n_batches = -(-V2_DOCS // B)
    want = {n: c * n_batches for n, c in V2_BATCH_LAUNCHES.items()}
    check(harvest == want, f"the v2 harvest launched {harvest}, not {want}")
    check(store.shape == (1, V2_DOCS, 16) and store.dtype == np.float64
          and bool(np.isfinite(store).all()), f"the v2 store {store.shape} {store.dtype}")
    with torch.inference_mode():  # two batches' rows against the direct forward
        for i, batch in enumerate(iterate_batches(docs, B)):
            if i == 2:
                break
            c = [torch.from_numpy(batch[k]).cuda() for k in keys]
            direct = forward_sequence_classification(model, cfg, *c,
                                                     seq_pad_multiple=SEQ_PAD_MULTIPLE)
            direct = direct.logits[None].to(torch.float64).cpu().numpy()
            check(np.array_equal(store[:, i * B:(i + 1) * B], direct),
                  f"the v2 store's batch {i} differs from forward_sequence_classification's")
        tower_ms = device_ms(lambda: visual_backbone_apply(model.visual_backbone, cfg, cols[2]),
                             {})
        ms = device_ms(lambda: forward_sequence_classification(
            model, cfg, *cols, seq_pad_multiple=SEQ_PAD_MULTIPLE),
            {"attention": ("fwd_kernel<",), "bias": ("materialize_bias_kernel",)})
    rest = ms["all"] - tower_ms["all"] - ms["attention"]
    print(f"v2 harvest: (1, {V2_DOCS}, 16) f64 store, {stats['docs_per_sec']:.1f} docs/sec "
          f"(host clock, after a warm-up batch, batch {B}, 561 tokens padded to 640), "
          f"launches {harvest} ({n_batches} batches), 2 batches bit-equal to "
          f"forward_sequence_classification, peak memory {serve_peak:.1f} MiB; one batch "
          f"traced: {ms['all']:.3f} device ms: the visual tower {tower_ms['all']:.3f} (traced "
          f"alone), the attention {ms['attention']:.3f}, the rest {rest:.3f} (the bias build "
          f"{ms['bias']:.3f}); on {card}")

    # the f32 model on 4 documents against the f32 plain path on the CPU
    few = [torch.from_numpy(first[k][:4]) for k in keys]
    with torch.inference_mode():
        t0 = time.perf_counter()
        cpu32 = forward_sequence_classification(model32, cfg, *few).logits
        t_cpu = time.perf_counter() - t0
        gpu_model32 = copy.deepcopy(model32).cuda()
        got32 = forward_sequence_classification(gpu_model32, cfg,
                                                *(x.cuda() for x in few)).logits.cpu()
        del gpu_model32
    err32 = (got32 - cpu32).abs().max().item()
    check(f32_close(got32, cpu32), f"v2 f32 kernel path vs f32 plain path: {err32} "
          f"(atol 2e-4, rtol 1e-3)")
    print(f"v2 reference: f32 kernel path vs f32 plain path (CPU, {t_cpu:.1f} s), 4 documents: "
          f"logit max diff {err32:.3e} at logit scale {cpu32.abs().max().item():.3f} "
          f"(atol 2e-4 / rtol 1e-3)")
    del model
    torch.cuda.empty_cache()

    # ---- training: cli.train, 1 epoch of 4 steps, bf16 forward ----------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_v2_")
    cwd = os.getcwd()
    os.chdir(tmp)
    steps, probe = [], {}
    step_fn = EETrainer.train_step
    probed = ("encoder.layers.0.attention.query.weight", "encoder.rel_pos_bias",
              "classifier.weight", "visual_backbone.stem_conv",
              "visual_backbone.stages.2.22.bn2.weight")

    def timed_step(self, batch, rng):
        if not probe:
            params = dict(self.model.named_parameters())
            probe.update({n: params[n].detach().clone() for n in probed})
        torch.cuda.synchronize()
        before = launch_counts()
        t0 = time.perf_counter()
        out = step_fn(self, batch, rng)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0, out[0], launched(before)))
        if len(steps) == 4:
            params = dict(self.model.named_parameters())
            probe.update({n: torch.equal(t, params[n].detach()) for n, t in probe.items()})
        return out

    EETrainer.train_step = timed_step
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        metrics = cli_train.main(list(V2_TRAIN))
        t_train = time.perf_counter() - t0
    finally:
        EETrainer.train_step = step_fn
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    trained = {n: sum(s[2].get(n, 0) for s in steps) for n in V2_STEP_LAUNCHES}
    check(len(steps) == 4, f"cli.train took {len(steps)} steps of v2, not 4")
    check(all(math.isfinite(loss) for _, loss, _ in steps),
          f"v2 losses {[loss for _, loss, _ in steps]}")
    for _, _, ran in steps:
        check(ran == V2_STEP_LAUNCHES, f"a v2 step launched {ran}, not {V2_STEP_LAUNCHES}")
    still = [n for n, same in probe.items() if same is True]
    check(not still, f"v2 parameters that did not move in 4 steps: {still}")
    check(set(metrics) == {"accuracy", "exit_0_share"}, f"v2 test metrics {sorted(metrics)}")
    timed = [dt for dt, _, _ in steps]
    print(f"v2 cli.train (bf16, batch {B}, dropout {cfg.hidden_dropout_prob}, lr 2e-5): 4 steps "
          f"of {[round(t, 4) for t in timed]} s, {B * 3 / sum(timed[1:]):.1f} train docs/sec "
          f"after the first step (host clock), losses {[round(x, 4) for _, x, _ in steps]}, "
          f"launches per step {V2_STEP_LAUNCHES}, {t_train:.1f} s with the validation, the "
          f"test evaluation and a checkpoint, peak memory {train_peak:.1f} MiB, test metrics "
          f"{json.dumps({k: round(float(v), 4) for k, v in metrics.items()})}, on {card}")

    # ---- gradients of one loss on 2 documents, dropout 0 ----------------
    # against the f32 plain path on the CPU: bf16 on the card within phase
    # 5's relative L2 bar over every gradient and GRAD_LIMITS over every
    # tensor outside the visual tower (the tensors that the attention
    # kernels' backward feeds), f32 on the card within F32_GRAD_LIMITS over
    # the same tensors. The tower's bias gradients sum terms that cancel:
    # rounding moves them far more than the other tensors' (bf16 on the
    # plain path alone, and f32 cuDNN against the CPU), so its worst tensor
    # is printed for bf16 on the card, bf16 on the CPU and f32 on the card.
    train = build_dataset("synthetic_rvl_cdip", "train")
    tb = next(iterate_batches(train, B))
    batch = {k: torch.from_numpy(tb[k]) for k in keys + ("labels",)}
    cfg0 = cfg.replace(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = v2_loss_grads(model32, cfg0, batch, "cpu", None)
    t_cpu = time.perf_counter() - t0
    names = [n for n, _ in model32.named_parameters()]
    outside = [i for i, n in enumerate(names) if not n.startswith("visual_backbone.")]
    big = max(g.abs().max().item() for g in cpu_grads)
    tower_worst, summaries = {}, {}
    for where, dtype in (("card", torch.bfloat16), ("cpu", torch.bfloat16), ("card", None)):
        device = "cuda" if where == "card" else "cpu"
        grad_model = copy.deepcopy(model32).to(device)
        loss, grads = v2_loss_grads(grad_model, cfg0, batch, device, dtype)
        del grad_model
        grads = [g.cpu() for g in grads]
        tag = f"{'f32' if dtype is None else 'bf16'} on the {where}"
        tower_worst[tag] = max((scaled_err(a, b), n) for n, a, b in zip(names, grads, cpu_grads)
                               if n.startswith("visual_backbone.")
                               and b.abs().max().item() >= 1e-2 * big)
        if where == "cpu":
            continue
        if dtype is not None:
            diff = sum((a - b).square().sum() for a, b in zip(grads, cpu_grads))
            rel_l2 = math.sqrt(diff.item() / sum(b.square().sum() for b in cpu_grads).item())
            check(rel_l2 <= 5e-2, f"v2 bf16 gradients: relative L2 {rel_l2} over every tensor")
        summaries[tag] = gradient_gate(
            [names[i] for i in outside], loss, [grads[i] for i in outside], cpu_loss,
            [cpu_grads[i] for i in outside],
            f"v2 {tag} kernel-path gradients vs the f32 plain path",
            GRAD_LIMITS if dtype is not None else F32_GRAD_LIMITS)
    print(f"v2 train reference (f32 plain path on the CPU, {t_cpu:.1f} s), 2 documents, "
          f"dropout 0: bf16 on the card: relative L2 over every tensor {rel_l2:.3e} (tol "
          f"5e-2); outside the visual tower: {summaries['bf16 on the card']}; f32 on the card, "
          f"outside the tower (F32_GRAD_LIMITS): {summaries['f32 on the card']}; the tower's "
          f"worst tensor above 1e-2 of the largest gradient: "
          + ", ".join(f"{tag} {n} {e:.3e}" for tag, (e, n) in tower_worst.items()))
    del cpu_grads
    torch.cuda.empty_cache()
    return harvest, trained


ENGINE_BATCH = 32  # phase 8b's batch; buckets (8, 16, 32)


@torch.no_grad()
def phase_engine(card: str, kept):
    """Phase 8b: ``AnytimeEngine`` on phase 4's EE LayoutLMv3-base bf16
    model (its heads as phase 4 re-centred them) over phase 4's 64
    documents in 2 batches of 32, buckets (8, 16, 32), one global
    max-confidence threshold in the widest gap of the exits' criteria.
    Its two kernels against their plain versions at the largest bucket
    (``compare_path_kernels``). Checks: the exits equal ``decide_exits(ee_forward())`` for the
    documents 1e-2 away from the threshold, their logits within the bf16
    tolerance; the ``collect_store`` store against ``ee_forward``'s policy
    logits; patience at t = 2 equal to the offline ``patience_policy`` of
    the engine's own store; per stage 1 #1 and one #2 per layer, on the
    bucket of the stage's survivors. Prints the engine's docs/sec beside
    the full-capacity cascade ``Pipeline``'s on the same batches. Returns
    the launches of the timed run (counts set to 0 just before it)."""
    import dataclasses

    from multi_modal_early_exit_tpu_torch.evaluation.policy import Policy
    from multi_modal_early_exit_tpu_torch.models.ee.engine import AnytimeEngine, _round_bucket
    from multi_modal_early_exit_tpu_torch.models.ee.model import decide_exits, ee_forward
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import (
        bias_tables,
        bias_vectors,
        sequence_layout,
    )
    from multi_modal_early_exit_tpu_torch.serving import Pipeline
    from multi_modal_early_exit_tpu_torch.utils.profiling import launch_counts

    model, cfg = kept["model"].to("cuda"), kept["cfg"]
    keys = ("input_ids", "bbox", "pixel_values", "attention_mask")
    data = {k: kept["batch"][k].cuda() for k in keys}
    n_docs = data["input_ids"].shape[0]
    chunks = [[data[k][i:i + ENGINE_BATCH] for k in keys]
              for i in range(0, n_docs, ENGINE_BATCH)]
    refs = [ee_forward(model, cfg, *c) for c in chunks]
    crit = torch.cat([r.exit_criteria for r in refs], 1).float().cpu().numpy()
    thr = widest_gap_threshold(crit[:-1].ravel(), 0.6, 0.9)
    far = torch.from_numpy(np.abs(crit[:-1] - thr).min(axis=0) > 1e-2)
    check(int(far.sum()) >= n_docs // 4, f"only {int(far.sum())} documents lie 1e-2 away "
          f"from the engine's threshold {thr}")
    engine = AnytimeEngine(model, cfg, threshold=thr, max_batch=ENGINE_BATCH, min_bucket=8)
    check(engine.buckets == (8, 16, 32), f"buckets {engine.buckets}")
    # the path's kernels at its largest bucket: 32 documents, S = 709 (P = 768)
    full_bbox, pos, full_mask = sequence_layout(cfg.backbone, chunks[0][1], chunks[0][3],
                                                cfg.backbone.num_visual_tokens)
    read = compare_path_kernels(
        [*bias_vectors(pos, full_bbox, full_mask), *bias_tables(model.backbone, cfg.backbone,
                                                                 "cuda")],
        torch.Generator().manual_seed(9), training=False)
    print(f"engine kernels against their plain versions at the path's shapes: {read}")
    counted_kernels = ("materialize_bias", "flash_attention_packed")

    # per stage: 1 bias build and one attention call per layer, on the
    # bucket of the stage's survivors
    stage_fn, stages = engine._stage, []

    def counted(idx, hidden, *rest):
        before = launch_counts()
        out = stage_fn(idx, hidden, *rest)
        a, b_layer = engine.stage_bounds[idx]
        ran = launched(before, counted_kernels)
        check(ran == {"materialize_bias": 1, "flash_attention_packed": b_layer - a},
              f"engine stage {idx} launched {ran}")
        stages.append((idx, hidden.shape[0]))
        return out

    engine._stage = counted
    engine.infer(*chunks[0])  # warm-up
    stages.clear()
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [engine.infer(*c) for c in chunks]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launched(before, counted_kernels)
    got_logits = torch.from_numpy(np.concatenate([o[0] for o in outs]))
    got_ids = torch.from_numpy(np.concatenate([o[1] for o in outs]))
    want_ids = torch.cat([decide_exits(r, cfg.exit, thr).cpu() for r in refs])
    store = torch.cat([r.policy_logits().float().cpu() for r in refs], 1)
    want_logits = store[want_ids.long(), torch.arange(n_docs)]
    agree = got_ids == want_ids
    check(bool(agree[far].all()), f"engine exits differ from decide_exits(ee_forward()): "
          f"{got_ids.tolist()} vs {want_ids.tolist()}")
    logit_err = (got_logits - want_logits)[agree].abs().max().item()
    check(bool(torch.isfinite(got_logits).all()) and bf16_close(logit_err, want_logits),
          f"engine logits differ from ee_forward's by {logit_err}")
    # each stage ran on the bucket of the rows still running
    alive = [[(ids >= 2 + s).sum() for s in range(2)] for ids in
             (got_ids[i:i + ENGINE_BATCH] for i in range(0, n_docs, ENGINE_BATCH))]
    want_stages = [(s, _round_bucket(int(n), engine.buckets))
                   for per_batch in alive for s, n in enumerate(per_batch) if n]
    check(stages == want_stages, f"engine stages {stages}, not {want_stages}")
    hist = np.bincount(got_ids.numpy(), minlength=4).tolist()

    # collect_store: every stage on every document, the whole store
    engine_store = [engine.infer(*c, collect_store=True)[2] for c in chunks]
    engine_store = torch.from_numpy(np.concatenate(engine_store, 1))
    store_err = (engine_store - store).abs().max().item()
    check(engine_store.shape == store.shape and bf16_close(store_err, store),
          f"the engine's store differs from ee_forward's policy logits by {store_err}")

    # patience at t = 2 against the offline policy of the engine's own store
    pcfg = cfg.replace(exit=dataclasses.replace(cfg.exit, inference_strategy="patience"))
    patient = AnytimeEngine(model, pcfg, threshold=2, max_batch=ENGINE_BATCH, min_bucket=8)
    p_ids, p_store = [], []
    for c in chunks:
        _, ids, st = patient.infer(*c, collect_store=True)
        p_ids.append(ids)
        p_store.append(st)
    p_ids = np.concatenate(p_ids)
    offline = Policy(np.concatenate(p_store, 1).astype(np.float64),
                     {"exit_threshold": 2}).patience_policy()[0]
    check(np.array_equal(p_ids, offline), f"patience t=2 exits {p_ids.tolist()} differ from "
          f"the offline policy's {offline.tolist()}")
    p_offline_fwd = Policy(store.numpy().astype(np.float64),
                           {"exit_threshold": 2}).patience_policy()[0]

    # the cascade Pipeline at full capacity on the same batches
    pipe = Pipeline(model, cfg, threshold=thr, batch_size=ENGINE_BATCH, tokenizer=kept["tok"])
    pipe.predict_features({k: v[:ENGINE_BATCH] for k, v in data.items()})  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = pipe.predict_features(data)
    torch.cuda.synchronize()
    dt_pipe = time.perf_counter() - t0
    pipe_ids = torch.tensor([r["exit"] for r in served])
    check(bool((pipe_ids == got_ids)[far].all()), "the cascade's exits differ from the engine's")
    print(f"engine: {n_docs} documents in {len(chunks)} batches of {ENGINE_BATCH}, threshold "
          f"{thr:.4f}, exits {hist}, stages (stage, bucket) {stages}, launches {launches}: "
          f"{n_docs / dt:.1f} docs/sec (host clock, after a warm-up batch) beside the "
          f"full-capacity cascade Pipeline's {n_docs / dt_pipe:.1f} on the same batches; "
          f"exits equal decide_exits(ee_forward()) for {int(far.sum())}/{n_docs} documents "
          f"farther than 1e-2 from the threshold ({int(agree[~far].sum())} of {int((~far).sum())} "
          f"nearer agree), logit max diff {logit_err:.3e}; collect_store vs ee_forward's policy "
          f"logits max diff {store_err:.3e} (bit-equal: {bool(store_err == 0.0)}); patience "
          f"t=2 equal to the offline policy of its own store, {int((p_ids == p_offline_fwd).sum())}"
          f"/{n_docs} equal to that of ee_forward's store, exits "
          f"{np.bincount(p_ids, minlength=4).tolist()}; on {card}")
    return launches


# phase 9: the parallel layer on one card (several ranks share it)
MESH_TIMEOUT = 300  # seconds for each world of ranks and the torchrun launch
MESH_COLLECTIVE_TIMEOUT = 60  # seconds for each collective of cli.train's ranks
# phase 9b's cases: (mesh, dtype); the (4, 1) mesh's blocks differ from
# (2, 2)'s in the batch alone, which the bf16 cases cover
MESH_CASES = (((2, 2), "bfloat16"), ((2, 2), "float32"), ((4, 1), "bfloat16"))
MESH_KERNELS = ("materialize_bias", "flash_attention_packed", "table_grads", "flash_attention_fwd",
                "flash_attention_bwd", "flash_attention_packed_train",
                "flash_attention_packed_train_bwd")
CLI_MESH = ["with", "model_size=base", "dataset=synthetic_rvl_cdip", "model_weights=",
            "batch_size=16", "eval_batch_size=16", "compute_dtype=bfloat16",
            "exits=text_avg,vision_avg,7", "training_strategy=one_stage_subgraphs_weighted",
            "lr=2e-5", "output_dir=save", "mesh_shape=2,2", "device=cuda:0"]
# per rank and step of cli.train under (2, 2): 6 heads of 64 in 12 layers
CLI_MESH_STEP = {"table_grads": 2, "flash_attention_packed_train": 12,
                 "flash_attention_packed_train_bwd": 24}
# what each rank of 9c's launch runs, in turn: 9b's sharded head-form
# attention and (2, 2) steps, then the gradient gate, cli.train and its resume
CLI_MESH_PARTS = ("9b", "9b-steps", "gate", "train", "resume")
SERVE_CAPACITIES = (8, 4)  # phase 9d's per-shard capacities (shards of 8)


def rank_launches(directory: str) -> dict:
    """The kernel launch counts the ranks wrote into ``directory``
    (``launches-rank<R>.json``), by rank."""
    out = {}
    for name in sorted(os.listdir(directory)):
        if name.startswith("launches-rank") and name.endswith(".json"):
            with open(os.path.join(directory, name)) as f:
                out[int(name[len("launches-rank"):-len(".json")])] = json.load(f)
    return out


def summed(counts: dict) -> dict:
    total = {}
    for per_rank in counts.values():
        for k, n in per_rank.items():
            total[k] = total.get(k, 0) + n
    return total


def mesh_cli_rank(directory: str, argv) -> int:
    """One rank of phase 9's torchrun launch (``chip_smoke.py --mesh-cli-rank
    DIR with ...``, from the directory the run writes into). On the world
    and mesh that ``cli.train`` sets up (``setup_mesh``) it runs, in turn:
    9b, the jobs of ``DIR/9b.pkl`` (``dryrun.run_jobs``: the sharded
    head-form attention cases), their results into ``DIR/9b-out-rank<R>.pkl``;
    9b-steps, ``dryrun.job_step_timing`` at (2, 2) on ``DIR/9b.pkl``'s config
    and batches, its reading into ``DIR/9b-steps-out-rank<R>.pkl``; gate,
    phase 5's gradient check (``DIR/gate.pkl``: the dropout-0 config, 2
    documents) through the CLI's batch glue (``step_batch``) and
    ``EETrainer``'s step with the optimizer's update replaced by a capture,
    the gathered gradients, loss and exit weights into ``DIR/gate-out.pkl``
    (rank 0); train, ``cli.train.main(argv + ["epochs=1"])``; resume, the
    same from its checkpoint-0 with ``epochs=2``. The base model is built
    once, from seed 0, for 9b-steps and the gate. Each part's launch counts
    go to ``DIR/<part>/launches-rank<R>.json``, and rank 0 writes the
    wall-clock time at each part's end into ``DIR/times.json``."""
    import glob
    import pickle

    import torch.distributed as dist

    from multi_modal_early_exit_tpu_torch.cli import train
    from multi_modal_early_exit_tpu_torch.models.ee.model import init_ee_params
    from multi_modal_early_exit_tpu_torch.parallel import dryrun
    from multi_modal_early_exit_tpu_torch.parallel.sharding import gather_params
    from multi_modal_early_exit_tpu_torch.training.trainer import EETrainer, TrainingArguments
    from multi_modal_early_exit_tpu_torch.utils.profiling import launch_counts, write_launch_counts

    times = {"start": time.time()}
    mesh, device = train.setup_mesh(train.parse_cli(argv))
    times["world"] = time.time()

    def done(part, result=None):
        os.makedirs(os.path.join(directory, part), exist_ok=True)
        write_launch_counts(os.path.join(directory, part), mesh.rank)
        launch_counts(reset=True)
        if result is not None:
            with open(os.path.join(directory, f"{part}-out-rank{mesh.rank}.pkl"), "wb") as f:
                pickle.dump(result, f)
        times[part] = time.time()

    with open(os.path.join(directory, "9b.pkl"), "rb") as f:
        sharded = pickle.load(f)
    done("9b", dryrun.run_jobs(device, sharded["jobs"]))
    with open(os.path.join(directory, "gate.pkl"), "rb") as f:
        gate = pickle.load(f)
    model = init_ee_params(gate["cfg"], torch.Generator().manual_seed(0), device="cpu")
    done("9b-steps", dryrun.job_step_timing(device, (2, 2), sharded["cfg"], sharded["args"],
                                            sharded["batches"], state=model.state_dict()))
    torch.cuda.empty_cache()
    trainer = EETrainer(gate["cfg"], model, TrainingArguments(bf16=True, learning_rate=2e-5), 10,
                        device=device, mesh=mesh)
    grads = {}
    trainer.optimizer.apply = grads.update  # the reduced gradients, not applied
    loss = trainer.train_step(train.step_batch(gate["batch"], 1, mesh), None)[0]
    full = gather_params(grads, mesh)
    if mesh.rank == 0:
        with open(os.path.join(directory, "gate-out.pkl"), "wb") as f:
            weights = trainer.exit_weights
            pickle.dump({"loss": loss, "grads": dryrun.numpy_state(full),
                         "weights": None if weights is None else weights.cpu().numpy()}, f)
    del model, trainer, grads, full
    torch.cuda.empty_cache()
    done("gate")
    train.main(list(argv) + ["epochs=1"])
    done("train")
    first = glob.glob(os.path.join("save", "*", "checkpoint-0"))
    check(len(first) == 1, f"cli.train wrote {first}")
    train.main(list(argv) + ["epochs=2", f"checkpoint={first[0]}"])
    done("resume")
    if mesh.rank == 0:
        with open(os.path.join(directory, "times.json"), "w") as f:
            json.dump(times, f)
    dist.destroy_process_group()
    return 0


def run_cli_mesh(workdir: str, directory: str) -> float:
    """``mesh_cli_rank`` under torchrun: 4 ranks on this card (gloo), mesh
    (2, 2), from ``workdir``. Returns the wall-clock time it was launched;
    a failed rank fails the phase."""
    env = dict(os.environ, MMEE_DIST_BACKEND="gloo",
               MMEE_DIST_TIMEOUT=str(MESH_COLLECTIVE_TIMEOUT), OMP_NUM_THREADS="2")
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
           os.path.join(root, "chip_smoke.py"), "--mesh-cli-rank", directory] + CLI_MESH
    launched = time.time()
    proc = subprocess.run(cmd, cwd=workdir, env=env, capture_output=True, text=True,
                          timeout=MESH_TIMEOUT)
    check(proc.returncode == 0, f"torchrun cli.train exited {proc.returncode}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    return launched


def mesh_rank_bias_inputs(cfg, model32, rows, rank: int, mesh_shape=(2, 2)):
    """The seven bias inputs that rank ``rank`` of ``mesh_shape`` builds for
    ``rows`` (B x 512 text tokens on the card): its documents' position,
    box and mask vectors (709 positions) and its heads' columns of
    ``model32``'s three tables (``bias_tables`` under that rank's mesh)."""
    import types

    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import (
        bias_tables,
        bias_vectors,
        sequence_layout,
    )
    from multi_modal_early_exit_tpu_torch.parallel.mesh import Mesh

    bb = cfg.backbone
    full_bbox, pos, full_mask = sequence_layout(bb, rows["bbox"], rows["attention_mask"],
                                                bb.num_visual_tokens)
    enc = model32.backbone.encoder
    rank_enc = types.SimpleNamespace(
        mesh=Mesh(mesh_shape, rank, torch.device("cuda")),
        **{n: getattr(enc, n).detach().cuda() for n in REL_POS_TABLES})
    with torch.no_grad():
        tables = bias_tables(types.SimpleNamespace(encoder=rank_enc), bb, "cuda")
    return [*bias_vectors(pos, full_bbox, full_mask), *tables]


def phase_mesh(card: str, trained):
    """Phase 9: the parallel layer at full width, ranks sharing this card.
    First the kernels of the meshes' paths against their plain versions at
    the shapes a rank gives them (``compare_path_kernels``, in this process):
    a (2, 2) rank's training batch (8 documents, 6 heads, its tables'
    columns) and 9d's second stage (4 documents, 12 heads). 9a a world of
    one on NCCL: ``EETrainer`` steps under a (1, 1) mesh bit-equal to those
    with no mesh; then one torchrun launch of 4 gloo ranks
    (``mesh_cli_rank``) for 9b and 9c: 9b the sharded head-form attention at
    (2, 2) in bf16 and f32 and at (4, 1) in bf16: rate 0 bit-equal to the
    unsharded kernels' blocks (#5 and #6), rate 0.1 against the plain
    version at each shard's seed; the (2, 2) steps' seconds; 9c the (2, 2)
    gradients of 2 documents, through ``cli.train``'s mesh and batch glue, against phase
    5's f32 CPU reference (``GRAD_LIMITS``), then ``cli.train`` under (2, 2),
    1 + 3 steps, and its resume from checkpoint-0, whose checkpoint loads on
    one device; 9d (2 gloo ranks) the cascade per shard at capacities (8,
    4), exits bit-equal to the single-device cascade run shard by shard,
    and the (2, 1) steps' seconds. Returns the kernels' launches summed over
    every rank of the phase (the comparisons uncounted)."""
    import dataclasses
    import pickle
    import shutil
    import tempfile

    from multi_modal_early_exit_tpu_torch.models.ee.cascade import make_cascade_forward
    from multi_modal_early_exit_tpu_torch.models.ee.model import EEModel, ee_forward
    from multi_modal_early_exit_tpu_torch.parallel import dryrun
    from multi_modal_early_exit_tpu_torch.serving import Pipeline
    from multi_modal_early_exit_tpu_torch.training.checkpoint import load_checkpoint
    from multi_modal_early_exit_tpu_torch.utils.profiling import uncounted

    t_phase = time.perf_counter()
    seconds = {}
    torch.cuda.empty_cache()
    cfg, model32, args = trained["cfg"], trained["model32"], dataclasses.asdict(trained["args"])
    batches = [{k: v.cpu().numpy() for k, v in b.items()} for b in trained["batches"][:3]]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    dirs = {k: os.path.join(tmp, k) for k in ("9a", "9c", "9d")}
    for d in dirs.values():
        os.makedirs(d)
    try:
        # the meshes' kernels at a rank's shapes
        t0 = time.perf_counter()
        first = {k: v[0] for k, v in trained["batches"][0].items()}
        with uncounted():
            rank_rows = {k: v[:B // 2] for k, v in first.items()}
            read_tp = compare_path_kernels(
                mesh_rank_bias_inputs(cfg, model32, rank_rows, rank=1),
                torch.Generator().manual_seed(10), training=True, heads=HEADS // 2)
            stage_rows = {k: v[:SERVE_CAPACITIES[1]] for k, v in first.items()}
            read_stage = compare_path_kernels(
                mesh_rank_bias_inputs(cfg, model32, stage_rows, rank=0, mesh_shape=(1, 1)),
                torch.Generator().manual_seed(11), training=False)
        seconds["kernels"] = time.perf_counter() - t0
        print(f"9 kernels against their plain versions at a (2, 2) rank's training shapes "
              f"(model rank 1's heads 6-11 and table columns, phase 5's first 8 documents): "
              f"{read_tp}; at 9d's second stage (12 heads): {read_stage}; on {card}")

        # 9a: a world of one on NCCL
        t0 = time.perf_counter()
        r = dryrun.spawn_world(1, dryrun.run_jobs, [
            ("unit", "job_unit_mesh", dict(cfg=cfg, args=args, batches=batches[:2])),
            ("launches", "job_launches", dict(directory=dirs["9a"]))],
            backend="nccl", device="cuda:0", timeout=MESH_TIMEOUT, threads=8)[0]["unit"]
        seconds["9a"] = time.perf_counter() - t0
        check(r["backend"] == "nccl" and r["all_reduce"] == 1.0, f"9a's world: {r}")
        check(not r["differ"], f"9a: the (1, 1) mesh's parameters differ in {r['differ'][:5]}")
        unit_s = r["seconds"]["mesh"]
        print(f"9a: 2 EETrainer steps under a (1, 1) mesh on NCCL bit-equal to 2 with no mesh "
              f"(EE LayoutLMv3-base, bf16, dropout 0.1, batch 16): {unit_s} s under the mesh, "
              f"{r['seconds']['single']} s without, on {card}")

        # 9b and 9c: one torchrun launch of 4 gloo ranks on this card: 9b's
        # sharded head-form attention and (2, 2) steps, then the gradient
        # check through cli.train's mesh and batch glue, cli.train, and its
        # resume
        jobs = [(f"hf-{shape[0]}x{shape[1]}-{dt}-{rate}", "job_sharded_headform",
                 dict(shape=shape, dtype=dt, rate=rate))
                for shape, dt in MESH_CASES for rate in (0.0, TRAIN_RATE)]
        with open(os.path.join(dirs["9c"], "9b.pkl"), "wb") as f:
            pickle.dump({"jobs": jobs, "cfg": cfg, "args": args, "batches": batches}, f)
        rates0 = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                      classifier_dropout=0.0)
        with open(os.path.join(dirs["9c"], "gate.pkl"), "wb") as f:
            pickle.dump({"cfg": cfg.replace(backbone=cfg.backbone.replace(**rates0)),
                         "batch": {k: v[0, :2] for k, v in batches[0].items()}}, f)
        work = os.path.join(tmp, "cli")
        os.makedirs(work)
        launched = run_cli_mesh(work, dirs["9c"])
        ended = time.time()
        with open(os.path.join(dirs["9c"], "times.json")) as f:
            at = json.load(f)
        marks = [("start-up", launched, at["start"]), ("world", at["start"], at["world"])]
        marks += [(p, at[a], at[p]) for a, p in zip(("world",) + CLI_MESH_PARTS, CLI_MESH_PARTS)]
        marks.append(("exit", at["resume"], ended))
        seconds["9b+9c"] = ended - launched
        seconds.update({f"9c {name}": b - a for name, a, b in marks})

        def rank_outputs(part):
            out = []
            for rank in range(4):
                with open(os.path.join(dirs["9c"], f"{part}-out-rank{rank}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out

        ranks = rank_outputs("9b")
        read = {}
        for key, _, kw in jobs:
            f32 = kw["dtype"] == "float32"
            for rank, res in enumerate(ranks):
                got = res[key]
                if kw["rate"] == 0.0:
                    check(all(got["equal"].values()), f"9b {key} rank {rank}: not bit-equal "
                          f"to the unsharded kernels: {got['equal']}")
                else:
                    limit = F32_BAR if f32 else 2e-2
                    check(all(e <= limit for e in got["errors"].values()),
                          f"9b {key} rank {rank}: errors over scale {got['errors']} > {limit}")
                    read[key] = max(read.get(key, 0.0), max(got["errors"].values()))
        hf = {k: v for k, v in summed(rank_launches(os.path.join(dirs["9c"], "9b"))).items()
              if v}
        check(hf.get("flash_attention_fwd", 0) > 0 and hf.get("flash_attention_bwd", 0) > 0,
              f"9b launched {hf}")
        steps = rank_outputs("9b-steps")
        steps22 = steps[0]
        losses = [res["loss"] for res in steps]
        check(all(x == losses[0] and math.isfinite(x) for x in losses),
              f"9b: the (2, 2) ranks' losses {losses}")
        errors = json.dumps({k: f"{v:.2e}" for k, v in read.items()})
        print(f"9b, in the torchrun launch's ranks before 9c: sharded_flash_attention (B 16, H "
              f"12, S = P 768, D 64, f32 bias) in cases "
              f"{[(list(s), d) for s, d in MESH_CASES]}: at rate 0 every rank's output, dq, dk, "
              f"dv and dbias bit-equal to the unsharded kernels' block; at rate {TRAIN_RATE} the "
              f"largest error over scale by case {errors} "
              f"(tol 2e-2 bf16, {F32_BAR} f32) against the plain version at each shard's seed; "
              f"launches over the 4 ranks before the steps {hf}; "
              f"{seconds['9c 9b']:.1f} s, then 3 steps at (2, 2) {seconds['9c 9b-steps']:.1f} s, "
              f"on {card}")
        del ranks, steps

        with open(os.path.join(dirs["9c"], "gate-out.pkl"), "rb") as f:
            gate = pickle.load(f)
        check(np.array_equal(gate["weights"], trained["weights"].numpy()),
              f"9c: the mesh trainer's exit weights {gate['weights']} are not phase 5's "
              f"{trained['weights'].numpy()}")
        names = [n for n, _ in model32.named_parameters()]
        ref_loss, ref_grads, _ = trained["reference"]
        grads = [torch.from_numpy(gate["grads"][n]) for n in names]
        summary = gradient_gate(names, gate["loss"], grads, ref_loss, ref_grads,
                                "(2, 2) mesh bf16 gradients vs the f32 plain path")
        print(f"9c gradient check, in the torchrun launch's ranks before cli.train: 2 documents "
              f"through cli.train's setup_mesh and step_batch (one a data shard) and "
              f"EETrainer.train_step (6 heads a model shard), bf16 kernel path, the reduced "
              f"gradients gathered, vs phase 5's f32 plain path on the CPU: {summary}; exit "
              f"weights equal to phase 5's")
        del gate, grads
        run_dir = os.path.join(work, "save", os.listdir(os.path.join(work, "save"))[0])
        check(sorted(os.listdir(run_dir)) == ["checkpoint-0", "checkpoint-1"],
              f"cli.train under (2, 2) wrote {sorted(os.listdir(run_dir))}")
        for part in ("train", "resume"):
            per_rank = rank_launches(os.path.join(dirs["9c"], part))
            check(sorted(per_rank) == [0, 1, 2, 3], f"launch counts of ranks {sorted(per_rank)}")
            for rank, counts in per_rank.items():
                for k, n in CLI_MESH_STEP.items():
                    check(counts.get(k, 0) == 4 * n, f"cli.train {part} rank {rank}: {k} "
                          f"{counts.get(k, 0)} launches in 4 steps, not {4 * n}")
                check(counts.get("materialize_bias", 0) > 4
                      and counts.get("flash_attention_packed", 0) > 0,
                      f"cli.train {part} rank {rank} launched {counts}")
        state, saved, _, step = load_checkpoint(os.path.join(run_dir, "checkpoint-1"))
        check(step == 1, f"the resumed run's checkpoint is of step {step}")
        one = EEModel(cfg, device="cpu")
        one.load_state_dict(state, strict=True)
        check(all(bool(torch.isfinite(p).all()) for p in one.parameters()),
              "the mesh checkpoint holds non-finite parameters")
        pipe = Pipeline.from_checkpoint(os.path.join(run_dir, "checkpoint-1"), batch_size=B)
        served = pipe.predict_features({k: batches[0][k][0] for k in (
            "input_ids", "bbox", "attention_mask", "pixel_values")})
        check(len(served) == B and all(math.isfinite(x["confidence"]) for x in served),
              "the mesh checkpoint's Pipeline served malformed results")
        split = ", ".join(f"{k[3:]} {v:.1f}" for k, v in seconds.items() if k.startswith("9c "))
        print(f"9c: torchrun --nproc-per-node 4 chip_smoke.py --mesh-cli-rank (gloo, 4 ranks on "
              f"cuda:0): 9b's parts, then cli.train with mesh_shape=2,2 (EE LayoutLMv3-base, "
              f"bf16, batch 16, 8 documents a data shard, 6 heads a model shard), 1 + 3 steps, "
              f"then its resume from checkpoint-0 (4 more steps) in the same ranks; per rank and "
              f"step {CLI_MESH_STEP}; checkpoint-1 loads on one device (strict) and serves "
              f"through Pipeline.from_checkpoint; the launch {seconds['9b+9c']:.1f} s ({split}); "
              f"on {card}")
        del one, state, pipe

        # 9d: the cascade per shard, 2 ranks, capacities (8, 4), and the (2, 1) steps
        t0 = time.perf_counter()
        model = copy.deepcopy(model32).to("cuda", torch.bfloat16)
        rows = {k: torch.from_numpy(v[0]).cuda() for k, v in batches[0].items()}
        chunk = [(rows["input_ids"], rows["bbox"], rows["pixel_values"].to(torch.bfloat16),
                  rows["attention_mask"])]
        with torch.no_grad():  # as phase 4 does
            rescale_heads(model, cfg, chunk)
            crit = ee_forward(model, cfg, *chunk[0]).exit_criteria.float().cpu().numpy()
        thr = [widest_gap_threshold(row, 0.88, 0.97) for row in crit[:-1]]
        state = dryrun.numpy_state(model.state_dict())
        serve = {k: batches[0][k][0] for k in ("input_ids", "bbox", "attention_mask",
                                                 "pixel_values")}
        r2 = dryrun.spawn_world(2, dryrun.run_jobs, [
            ("serve", "job_cascade", dict(cfg=cfg, state=state, batch=serve,
                                          capacities=SERVE_CAPACITIES, threshold=thr,
                                          dtype="bfloat16")),
            ("steps", "job_step_timing", dict(shape=(2, 1), cfg=cfg, args=args,
                                              batches=batches)),
            ("launches", "job_launches", dict(directory=dirs["9d"]))],
            backend="gloo", device="cuda:0", timeout=MESH_TIMEOUT, threads=4)
        cascade = make_cascade_forward(cfg, capacities=SERVE_CAPACITIES, threshold=thr)
        want = {"logits": [], "exit_ids": [], "capacity_exited": []}
        with torch.no_grad(), uncounted():
            for half in (slice(0, B // 2), slice(B // 2, B)):
                res = cascade(model, *(torch.from_numpy(serve[k][half]).cuda() for k in (
                    "input_ids", "bbox", "pixel_values", "attention_mask")))
                for k in want:
                    want[k].append(getattr(res, k).cpu().numpy())
        want = {k: np.concatenate(v) for k, v in want.items()}
        got = r2[0]["serve"]
        check(np.array_equal(got["exit_ids"], want["exit_ids"])
              and np.array_equal(got["capacity_exited"], want["capacity_exited"]),
              f"9d: per-shard exits {got['exit_ids']} / {got['capacity_exited']} differ from the "
              f"single-device cascade's shard by shard")
        logit_err = float(np.abs(got["logits"] - want["logits"]).max())
        check(logit_err <= 1e-4, f"9d: logits differ by {logit_err}")
        check(got["capacity_exited"].sum() > 0 and len(set(got["exit_ids"].tolist())) > 1,
              f"9d: no capacity exits or a single exit: {got}")
        steps21 = r2[0]["steps"]
        seconds["9d"] = time.perf_counter() - t0
        print(f"9d: the cascade per data shard (make_cascade_forward, as Pipeline runs it; 2 "
              f"ranks, 8 documents each, capacities {SERVE_CAPACITIES}, thresholds "
              f"{[round(t, 4) for t in thr]}): exits {got['exit_ids'].tolist()} and capacity "
              f"exits {int(got['capacity_exited'].sum())} bit-equal to the single-device "
              f"cascade run shard by shard, logits within {logit_err:.1e}; on {card}")
        del model

        # the step seconds by mesh; the ranks share one card, so these are
        # not scaling numbers
        def share(run):
            return [round(c / s, 3) for c, s in zip(run["collective_seconds"], run["seconds"])]

        def secs(times):
            return [round(t, 4) for t in times]

        seconds["phase 9"] = time.perf_counter() - t_phase
        print(f"9 step seconds (EE LayoutLMv3-base, bf16, global batch 16, first step first; "
              f"all ranks share ONE card, so these are not scaling numbers): (1, 1) NCCL "
              f"{secs(unit_s)}; (2, 1) gloo {secs(steps21['seconds'])}, collectives' host "
              f"share {share(steps21)}; (2, 2) gloo {secs(steps22['seconds'])}, collectives' "
              f"host share {share(steps22)}; phase 9's seconds by part "
              f"{json.dumps({k: round(v, 1) for k, v in seconds.items()})}, on {card}")
        counts = {i: summed(rank_launches(os.path.join(dirs["9c"], p)))
                  for i, p in enumerate(CLI_MESH_PARTS)}
        counts.update({k: summed(rank_launches(dirs[k])) for k in ("9a", "9d")})
        total = summed(counts)
        for name in MESH_KERNELS:
            check(total.get(name, 0) > 0, f"{name} was never launched under a mesh in phase 9")
        return total
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 10: the rest of the public surface, at phase 4's configuration
SURFACE_PAD = 128  # 10a's seq_pad_multiple: 709 tokens padded to 768
HIDDEN_BAR = (5e-4, 1e-3)  # the north star's hidden-state bar (tests/test_golden_base.py:78)
# phase 5's settings as bench.py:250 passes them, every field given, the
# eight the train step does not read away from their defaults
SURFACE_ARGS = dict(learning_rate=2e-5, num_epochs=3, train_batch_size=B, eval_batch_size=4,
                    gradient_accumulation_steps=1, weight_decay=0.0, warmup_ratio=0.0,
                    max_grad_norm=0.0, alpha=0.5, temperature=2.0, gamma=0.3, seed=7,
                    log_every=1, bf16=True, bf16_momentum=False)
SINGLE_TOWER = ("dit", "dit_rvl", "bert")


def hidden_err(got, want):
    """(max abs error, whether every element is within ``HIDDEN_BAR``)."""
    atol, rtol = HIDDEN_BAR
    diff = (got - want).abs()
    return diff.max().item(), bool((diff <= atol + rtol * want.abs()).all())


def phase_surface(card: str, trained):
    """Phase 10: the rest of the JAX package's public surface at full width,
    imported only through the package root and the sub-packages'
    ``__init__``s, on phase 5's EE LayoutLMv3-base (phase 4's configuration:
    12 layers, hidden 768, 12 x 64 heads, exits text_avg, vision_avg, 7,
    random weights from seed 0) and documents. 10a ``collect_hidden``: bf16,
    batch 16, ``ee_forward(collect_hidden=True, seq_pad_multiple=128)`` bit-equal
    in its logits, exit logits and criteria to the same call without it, and
    ``backbone_apply(collect_hidden=True).hidden_per_layer[-1]`` bit-equal
    to its ``last_hidden_state``, each call launching 1 ``materialize_bias``
    and 12 ``flash_attention_packed``; then the f32 model on 2 documents
    against the f32 plain path on the CPU: the last hidden state and every
    layer's within atol 5e-4 / rtol 1e-3, the policy logits within atol
    2e-4 / rtol 1e-3. 10b ``TrainingArguments``: one bf16 step of two
    ``EETrainer``s from one state (phase 5's settings), one given every
    field (``SURFACE_ARGS``) and one without the eight the step does not
    read: the same loss and parameters, bit for bit, and phase 5's launches.
    10c the exporter: ``jax_params_to_torch_state_dict(to_jax_params(...))``
    of 10a's bf16 backbone, imported back (``convert_torch_state_dict``,
    which reads exactly the keys the exporter wrote) and loaded into a copy
    filled with NaN, bit-equal on every parameter. 10d
    ``prefetch_to_device(buffer_size=k)`` for k = 1, 2, 3, the same batches
    in order; ``native.sweep.available()``; ``cli.train`` and ``EETrainer``
    refuse ``dit``, ``dit_rvl`` and ``bert``, named, before any launch.
    Prints one ``{"public_surface": ...}`` line."""
    import dataclasses

    import multi_modal_early_exit_tpu_torch as mmee
    from multi_modal_early_exit_tpu_torch.cli import train as cli_train
    from multi_modal_early_exit_tpu_torch.config import parse_cli
    from multi_modal_early_exit_tpu_torch.data import prefetch_to_device
    from multi_modal_early_exit_tpu_torch.models import build_model
    from multi_modal_early_exit_tpu_torch.models.ee import ee_forward
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3 import (
        backbone_apply,
        convert_torch_state_dict,
        jax_params_to_torch_state_dict,
        load_jax_params,
        to_jax_params,
    )
    from multi_modal_early_exit_tpu_torch.native import sweep
    from multi_modal_early_exit_tpu_torch.training import EETrainer, TrainingArguments
    from multi_modal_early_exit_tpu_torch.utils.profiling import launch_counts

    t_phase = time.perf_counter()
    seconds, read = {}, {}
    cfg, model32 = trained["cfg"], trained["model32"]
    check(isinstance(cfg.exit, mmee.ExitConfig) and mmee.Pipeline.__name__ == "Pipeline",
          "the package root's exports")
    keys = ("input_ids", "bbox", "pixel_values", "attention_mask")
    first = [trained["batches"][0][k][0] for k in keys]  # 16 documents on the card

    def counted(fn):
        before = launch_counts()
        out = fn()
        return out, launched(before)

    # 10a: collect_hidden, bf16 at batch 16, then f32 against the CPU
    t0 = time.perf_counter()
    model = copy.deepcopy(model32).to("cuda", torch.bfloat16)
    cols = first[:2] + [first[2].to(torch.bfloat16)] + first[3:]
    pad = dict(seq_pad_multiple=SURFACE_PAD)
    with torch.no_grad():
        hid, n_hid = counted(lambda: ee_forward(model, cfg, *cols, collect_hidden=True, **pad))
        ref, n_ref = counted(lambda: ee_forward(model, cfg, *cols, **pad))
        bb, n_bb = counted(lambda: backbone_apply(model.backbone, cfg.backbone, *cols,
                                                  collect_hidden=True, **pad))
    want = {"materialize_bias": 1, "flash_attention_packed": 12}
    check(n_hid == n_ref == n_bb == want, f"10a launches per call {n_hid}, {n_ref}, {n_bb}, "
          f"not {want}")
    for name in ("logits", "exit_logits", "exit_criteria"):
        check(torch.equal(getattr(hid, name), getattr(ref, name)),
              f"10a: collect_hidden moved the {name}")
    layers, width = cfg.backbone.num_hidden_layers, cfg.backbone.hidden_size
    s_pad = -(-(S_TEXT + cfg.backbone.num_visual_tokens) // SURFACE_PAD) * SURFACE_PAD
    check(ref.last_hidden_state is None and hid.last_hidden_state.shape == (B, s_pad, width)
          and bb.hidden_per_layer.shape == (layers, B, s_pad, width),
          f"10a shapes {tuple(hid.last_hidden_state.shape)}, {tuple(bb.hidden_per_layer.shape)}")
    check(bool(torch.isfinite(bb.hidden_per_layer).all()), "10a: non-finite hidden states")
    check(torch.equal(bb.hidden_per_layer[-1], hid.last_hidden_state),
          "10a: the last layer's state is not ee_forward's last_hidden_state")
    del hid, ref, bb
    small = [c[:2] for c in first]
    gpu32 = copy.deepcopy(model32).cuda()
    with torch.no_grad():
        g_out = ee_forward(gpu32, cfg, *small, collect_hidden=True, **pad)
        g_bb = backbone_apply(gpu32.backbone, cfg.backbone, *small, collect_hidden=True, **pad)
        cpu = [c.cpu() for c in small]
        c_out = ee_forward(model32, cfg, *cpu, collect_hidden=True, **pad)
        c_bb = backbone_apply(model32.backbone, cfg.backbone, *cpu, collect_hidden=True, **pad)
    last_err, last_ok = hidden_err(g_out.last_hidden_state.cpu(), c_out.last_hidden_state)
    layer_errs = [hidden_err(g.cpu(), c) for g, c in zip(g_bb.hidden_per_layer,
                                                         c_bb.hidden_per_layer)]
    a, b = g_out.policy_logits().cpu(), c_out.policy_logits()
    logit_err = (a - b).abs().max().item()
    check(last_ok, f"10a f32: last_hidden_state {last_err} off the CPU's (atol 5e-4, rtol 1e-3)")
    check(all(ok for _, ok in layer_errs),
          f"10a f32: hidden_per_layer off the CPU's: {[e for e, _ in layer_errs]}")
    check(f32_close(a, b), f"10a f32: policy logits {logit_err} off the CPU's")
    read["10a"] = dict(launches_per_call=n_hid, hidden_shape=[layers, B, s_pad, width],
                       f32_last_hidden_err=last_err,
                       f32_worst_layer_err=max(e for e, _ in layer_errs),
                       f32_logit_err=logit_err)
    del gpu32, g_out, g_bb, c_out, c_bb
    seconds["10a"] = time.perf_counter() - t0

    # 10b: TrainingArguments: every field given, or the step's alone
    t0 = time.perf_counter()
    check(set(SURFACE_ARGS) == {f.name for f in dataclasses.fields(TrainingArguments)},
          f"TrainingArguments' fields {[f.name for f in dataclasses.fields(TrainingArguments)]}")
    step_want = {"materialize_bias": 1, "table_grads": 2, "flash_attention_packed_train": 12,
                 "flash_attention_packed_train_bwd": 24}
    runs = []
    for args in (TrainingArguments(learning_rate=2e-5, bf16=True),
                 TrainingArguments(**SURFACE_ARGS)):
        trainer = EETrainer(cfg, copy.deepcopy(model32), args, total_steps=1000, device="cuda")
        (loss, _), n = counted(lambda: trainer.train_step(trained["batches"][0],
                                                          torch.Generator().manual_seed(1)))
        check(n == step_want and math.isfinite(loss), f"10b: loss {loss}, launches {n}")
        runs.append((loss, {k: p.detach().clone() for k, p in trainer.model.named_parameters()},
                     n))
        del trainer
    (loss_a, params_a, n_a), (loss_b, params_b, n_b) = runs
    check(loss_a == loss_b, f"10b: losses {loss_a} and {loss_b}")
    differ = [k for k in params_a if not torch.equal(params_a[k], params_b[k])]
    check(not differ, f"10b: parameters differ after one step: {differ[:5]}")
    read["10b"] = dict(loss=loss_a, launches_per_step=[n_a, n_b], parameters=len(params_a))
    del runs, params_a, params_b
    seconds["10b"] = time.perf_counter() - t0

    # 10c: the exporter, round trip on the card model
    t0 = time.perf_counter()
    state = jax_params_to_torch_state_dict(to_jax_params(model.backbone), cfg.backbone)
    check(all(k.startswith(("layoutlmv3.", "classifier.")) for k in state),
          f"10c: keys outside the HF model's prefixes: {list(state)[:5]}")
    reads = set()

    class Reading(dict):
        def __getitem__(self, key):
            reads.add(key)
            return super().__getitem__(key)

    back = convert_torch_state_dict(Reading(state), cfg.backbone)
    check(reads == set(state), f"10c: exported but not read {sorted(set(state) - reads)[:5]}, "
          f"read but not exported {sorted(reads - set(state))[:5]}")
    fresh = copy.deepcopy(model.backbone)
    with torch.no_grad():
        for p in fresh.parameters():
            p.fill_(float("nan"))
    load_jax_params(fresh, back, dtype=torch.bfloat16)
    mine, theirs = model.backbone.state_dict(), fresh.state_dict()
    differ = [k for k in mine if not torch.equal(mine[k], theirs[k])]
    check(not differ, f"10c: the round trip moved {differ[:5]}")
    read["10c"] = dict(keys=len(state), parameters=len(mine))
    del model, fresh, state, back
    seconds["10c"] = time.perf_counter() - t0

    # 10d: prefetch_to_device(buffer_size=), sweep.available, the refusals
    t0 = time.perf_counter()
    host = [{k: v[0].cpu().numpy() for k, v in b.items()} for b in trained["batches"]]
    fetched = {k: list(prefetch_to_device(iter(host), "cuda", buffer_size=k)) for k in (1, 2, 3)}
    for k, got in fetched.items():
        check(len(got) == len(host), f"10d: buffer_size {k} gave {len(got)} batches")
        for g, w, h in zip(got, fetched[1], host):
            check(all(g[n].is_cuda and torch.equal(g[n], w[n])
                      and np.array_equal(g[n].cpu().numpy(), h[n]) for n in h),
                  f"10d: buffer_size {k} gave other batches than buffer_size 1")
    del fetched
    check(sweep.available(), "10d: the native sweep is not available")
    refused = {}
    for name in SINGLE_TOWER:
        for where in ("cli.train", "EETrainer"):
            def attempt():
                try:
                    if where == "cli.train":
                        cli_train.main(["with", "debugEE", f"model={name}", "device=cuda"])
                    else:
                        exp = parse_cli(["with", "debugEE", f"model={name}", "device=cuda",
                                         "model_weights="])
                        mcfg, built = build_model(exp, num_labels=16)
                        EETrainer(mcfg, built, TrainingArguments(), 1, device="cuda")
                except NotImplementedError as e:  # the refusal this checks for
                    return str(e)
                return None

            message, n = counted(attempt)
            check(message is not None and repr(name) in message and not n,
                  f"10d: {where} with model={name}: {message!r}, launches {n}")
            refused[f"{where} {name}"] = message.split(":")[0]
    read["10d"] = dict(buffer_sizes=[1, 2, 3], batches=len(host), sweep_available=True,
                       refused=refused)
    seconds["10d"] = time.perf_counter() - t0
    seconds["phase 10"] = time.perf_counter() - t_phase
    print(json.dumps({"public_surface": {
        **read, "seconds": {k: round(v, 2) for k, v in seconds.items()}, "card": card}}))


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
        phase_kernels_d128(name, kernels)
        phase_kernels_wide(name, kernels)
    with bias_modes():
        serve_launches, served = phase_main_path()
    with bias_modes(fused="1"):
        fused_launches = phase_serve_fused(served)
    with bias_modes():
        anytime_launches = phase_anytime(card, served)
    moon_launches = phase_moonlight()
    vl_launches = phase_vision()
    klin_launches = phase_kimi_linear()
    base4 = {k: served[k] for k in ("docs_per_sec", "peak_mb")}
    # phase 8b's engine runs on phase 4's model and documents: kept on the host
    kept = dict(model=served["model"].to("cpu"), cfg=served["cfg"], tok=served["pipe"].tokenizer,
                batch={k: v.cpu() for k, v in served["batch"].items()})
    del served
    with bias_modes():
        serve32_launches = phase_main_path(torch.float32, base4)[0]
    for head_dim in (16, 96, 128, 192, 256):
        with bias_modes():
            phase_tiny(card, head_dim)
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
    with bias_modes():
        cli_launches = phase_cli(card)
    with bias_modes():
        v2_harvest, v2_train = phase_v2(card)
    with bias_modes():
        engine_launches = phase_engine(card, kept)
    del kept
    with bias_modes():
        mesh_launches = phase_mesh(card, trained)
    with bias_modes():
        phase_surface(card, trained)
    default_path = f"{TRAIN_STEPS} training steps, scan_fold=1, attention dropout 0"
    # the split pre-pass runs before every f32 forward and backward
    f32_split = {"split_bf16x3": serve32_launches["split_bf16x3"]
                 + train32_launches.get("split_bf16x3", 0)}
    f32_split_in = (f"phase 4f, {N_BATCHES} batches ({serve32_launches['split_bf16x3']}), and "
                    f"phase 5f, 2 gradient checks and {F32_TRAIN_STEPS} steps "
                    f"({train32_launches.get('split_bf16x3', 0)})")
    moon_in = (f"phase 4m, {MOON_BATCHES} Moonlight batches of {MOON_B} through Pipeline, "
               f"published widths, {MOON_LAYERS} layers")
    # each kernel's launches on the path that runs it
    paths = {
        "flash_attention_fwd": (default_launches, default_path),
        "flash_attention_bwd": (default_launches, default_path),
        "materialize_bias": (serve_launches, f"{N_BATCHES} served batches"),
        "flash_attention_packed": (serve_launches, f"{N_BATCHES} served batches"),
        "add_layer_norm": (serve_launches, f"{N_BATCHES} served batches"),
        "fused_bias_attention": (fused_launches,
                                 f"{N_BATCHES} served batches, MMEE_FUSED_BIAS=1"),
        "flash_attention_packed_train": (train_launches, f"{TRAIN_STEPS} training steps"),
        "flash_attention_packed_train_bwd": (train_launches, f"{TRAIN_STEPS} training steps"),
        "table_grads": (train_launches, f"{TRAIN_STEPS} training steps"),
        "flash_attention_packed_train_tables_bwd": (
            tables_launches, f"{TRAIN_STEPS} training steps, MMEE_TABLE_GRADS=1"),
        # f32 only: the paths that run it are phases 4f's and 5f's
        "split_bf16x3": (f32_split, f32_split_in),
        "swiglu_weigh": (moon_launches, moon_in),
        "combine_pairs": (moon_launches, moon_in),
        "page_attention": (vl_launches, f"phase 4v, {VL_BATCHES} Kimi-VL batches of {VL_PAGES} "
                                        f"pages through Pipeline, published widths, "
                                        f"{VL_LAYERS} layers"),
        **{name: (klin_launches, f"phase 4k, {KLIN_BATCHES} Kimi-Linear batches of {KLIN_ROWS} "
                                 f"documents through Pipeline, published widths, {KLIN_LAYERS} "
                                 f"layers")
           for name in ("kda", "short_conv", "kda_gate", "gated_rms_norm")},
    }
    check(len(kernels) == len(paths), f"{len(kernels)} kernels timed, {len(paths)} paths")
    # each kernel's f32 launches: on phase 4f's served batches or in phase
    # 5f (its two gradient checks and its steps); #3 and #9 run in f32 only
    # in phase 3
    f32_paths = {"materialize_bias": (serve32_launches, f"phase 4f, {N_BATCHES} batches"),
                 "flash_attention_packed": (serve32_launches, f"phase 4f, {N_BATCHES} batches"),
                 "add_layer_norm": (serve32_launches, f"phase 4f, {N_BATCHES} batches"),
                 "split_bf16x3": (f32_split, f32_split_in)}
    f32_train = (train32_launches, f"phase 5f, 2 gradient checks and {F32_TRAIN_STEPS} steps")
    for k in kernels:
        launches, where = paths[k["name"]]
        k["launches"], k["launches_in"] = launches.get(k["name"], 0), where
        check(k["launches"] > 0, f"{k['name']} was never launched on its path")
        launches32, where32 = f32_paths.get(k["name"], f32_train)
        k["f32_launches"], k["f32_launches_in"] = launches32.get(k["name"], 0), where32
        # #3 and #9 run in f32 only in phase 3; Moonlight serves in bf16
        no_f32_path = k["name"] in ("fused_bias_attention",
                                    "flash_attention_packed_train_tables_bwd", "swiglu_weigh",
                                    "combine_pairs", "page_attention", "kda", "short_conv",
                                    "kda_gate", "gated_rms_norm")
        check((k["f32_launches"] == 0) == no_f32_path,
              f"{k['name']}: {k['f32_launches']} f32 launches in {where32}")
    # the command-line path (phase 7): cli.train's steps, evaluations and
    # checkpoints, the resume and bf16-moment steps, cli.evaluate's harvests
    # and the Pipeline.from_checkpoint batches
    cli_in = "phase 7, the command-line path"
    for k in kernels:
        if k["name"] in CLI_STEP_LAUNCHES or k["name"] in CLI_BATCH_LAUNCHES:
            k["cli_launches"], k["cli_launches_in"] = cli_launches.get(k["name"], 0), cli_in
            check(k["cli_launches"] > 0, f"{k['name']} was never launched in phase 7")
    # the anytime harvest (phase 6) runs the serving forward's two kernels
    anytime_in = f"phase 6, get_logits over {ANYTIME_DOCS} documents"
    for k in kernels:
        if k["name"] in anytime_launches:
            k["anytime_launches"] = anytime_launches[k["name"]]
            k["anytime_launches_in"] = anytime_in
            check(k["anytime_launches"] > 0, f"{k['name']} was never launched in phase 6")
    # phase 8: LayoutLMv2-base's harvest and training steps, and the engine
    v2 = {n: v2_harvest.get(n, 0) + v2_train.get(n, 0) for n in set(v2_harvest) | set(v2_train)}
    v2_in = (f"phase 8a, LayoutLMv2-base: get_logits over {V2_DOCS} documents and 4 "
             f"cli.train steps")
    engine_in = f"phase 8b, AnytimeEngine over 64 documents in batches of {ENGINE_BATCH}"
    for k in kernels:
        if k["name"] in v2:
            k["v2_launches"], k["v2_launches_in"] = v2[k["name"]], v2_in
            check(k["v2_launches"] > 0, f"{k['name']} was never launched in phase 8a")
        if k["name"] in engine_launches:
            k["engine_launches"], k["engine_launches_in"] = engine_launches[k["name"]], engine_in
            check(k["engine_launches"] > 0, f"{k['name']} was never launched in phase 8b")
    check(set(v2) == {"materialize_bias", "flash_attention_packed", "flash_attention_packed_train",
                      "flash_attention_packed_train_bwd", "table_grads", "add_layer_norm"},
          f"phase 8a ran {v2}")
    # phase 9: every rank's launches under the meshes (the comparisons uncounted)
    mesh_in = ("phase 9, summed over the ranks: 9a 2 steps under (1, 1) (NCCL), 9b "
               "sharded_flash_attention at (2, 2) and (4, 1) and 3 steps under (2, 2), 9c the "
               "(2, 2) gradient check and torchrun cli.train under (2, 2) (8 steps and their "
               "evaluations), 9d the cascade per shard (2 ranks) and 3 steps under (2, 1)")
    for k in kernels:
        if k["name"] in MESH_KERNELS:
            k["mesh_launches"], k["mesh_launches_in"] = mesh_launches[k["name"]], mesh_in
    keys = ("name", "route", "source", "replaces", "launches", "launches_in", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "f32_ms", "f32_bound_ms",
            "f32_bound_by", "f32_library_ms", "f32_max_abs_err", "f32_launches",
            "f32_launches_in", "ok")
    # the fused kernel's rows also carry the pair it replaces; the
    # head-dim-dependent kernels their readings at D = 128
    extra = ("anytime_launches", "anytime_launches_in", "pair_ms", "f32_pair_ms", "ms_d128",
             "bound_d128", "bound_d128_by", "library_ms_d128", "f32_ms_d128", "f32_bound_d128",
             "f32_bound_d128_by", "f32_library_ms_d128", "ms_wide", "bound_wide",
             "bound_wide_by", "library_ms_wide", "f32_ms_wide", "f32_bound_wide",
             "f32_bound_wide_by", "f32_library_ms_wide", "cli_launches", "cli_launches_in",
             "v2_launches", "v2_launches_in", "engine_launches", "engine_launches_in",
             "mesh_launches", "mesh_launches_in", "ms_long", "bound_long_ms", "bound_long_by",
             "library_ms_long", "plain_ms_long", "err_over_scale", "library_err_over_scale",
             "ms_no_norm", "plain_ms_no_norm", "tokens", "intra_ms", "state_ms", "ms_35k",
             "bound_35k_ms", "bound_35k_by", "tokens_35k", "intra_ms_35k", "state_ms_35k")
    print(json.dumps({"kernels": [{key: k[key] for key in keys + extra if key in k}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-cli-rank"]:  # a rank of phase 9c's torchrun launch
        sys.exit(mesh_cli_rank(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
