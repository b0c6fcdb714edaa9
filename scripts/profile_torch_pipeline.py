#!/usr/bin/env python3
"""Where the PyTorch port spends its time on one GPU: serving or training.

    python3 scripts/profile_torch_pipeline.py [--mode serve|train]
        [--scan-fold N] [--remat] [--attn-dropout RATE] [--f32]

``serve`` (the default) builds EE LayoutLMv3-base (bf16, random weights from
seed 0, exits text_avg, vision_avg, 7) and a ``Pipeline`` at batch 16 with
capacities (16, 8), the configuration ``chip_smoke.py`` serves. With static
capacities a batch costs the same whatever its exits, so the threshold only
needs to be valid. After a warm-up it traces ``predict_features`` over 4
batches. ``train`` builds the training path of ``chip_smoke.py`` (f32 master
weights, bf16 forward, dropout 0.1, batch 16) and, after 2 warm-up steps,
traces 2 ``EETrainer.train_step``s; ``--scan-fold`` (default 12: the
chained bias cotangent), ``--remat`` (``gradient_checkpointing``) and
``--attn-dropout`` (default 0.1) set its schedule, so that ``--scan-fold 1
--attn-dropout 0`` profiles ``chip_smoke.py`` phase 5c and ``--scan-fold 1
--remat`` phase 5d. ``MMEE_FUSED_BIAS=1`` (serve) and ``MMEE_TABLE_GRADS=1``
(train) in the environment profile the bias modes. ``--f32`` serves an f32
model (``chip_smoke.py`` phase 4f) or trains without mixed precision
(``TrainingArguments(bf16=False)``, phase 5f with ``--scan-fold 1``).

Each mode traces with ``torch.profiler`` and prints the device time by kernel
group (the port's kernels, cuBLAS GEMMs, everything else), the wall time,
and the device's busy share (kernel time over wall time; one stream, so
kernels do not overlap). The next-to-last line is the per-kernel table as
JSON, the last the summary.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import B, N_BATCHES, S_TEXT, synthetic_pages, train_setup  # noqa: E402
from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig  # noqa: E402
from multi_modal_early_exit_tpu_torch.data.features import HashWordTokenizer  # noqa: E402
from multi_modal_early_exit_tpu_torch.data.images import preprocess_images  # noqa: E402
from multi_modal_early_exit_tpu_torch.models.ee.model import init_ee_params  # noqa: E402
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import (  # noqa: E402
    EEModelConfig,
    LayoutLMv3Config,
)
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import (  # noqa: E402
    use_table_grad_attention,
)
from multi_modal_early_exit_tpu_torch.serving import Pipeline  # noqa: E402
from multi_modal_early_exit_tpu_torch.training.trainer import EETrainer  # noqa: E402

TRAIN_TRACED_STEPS = 2
ATTN_BWD = "flash_attention_bwd / flash_attention_packed_train_bwd"
GROUPS = (
    ("materialize_bias", ("materialize_bias_kernel",)),
    ("fused_bias_attention", ("fused_bias_attention_kernel",)),
    # flash_attention_packed, the training forward and the head-form
    # forward launch one kernel
    ("flash_attention_packed / _train / flash_attention_fwd", ("fwd_kernel",)),
    ("flash_attention_packed_train_tables_bwd", ("table_partials_sum_kernel",)),
    # every backward launches the dq and the dk/dv kernel (the tables
    # backward the dq kernel's tables mode): see group_of
    # every f32 forward and backward first splits its operands
    ("split_bf16x3 (f32 attention forwards and backwards)", ("split_bf16x3_kernel",)),
    ("table_grads", ("table_grads_kernel",)),
    ("gemm", ("nvjet", "gemm", "xmma", "cutlass", "cublas")),
    ("optimizer", ("multi_tensor_apply", "adam")),
)


def group_of(name: str) -> str:
    low = name.lower()
    if "bwd_dq_kernel" in low or "bwd_dkv_kernel" in low:  # in the mode in effect's
        return "flash_attention_packed_train_tables_bwd" if use_table_grad_attention() else ATTN_BWD
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def serve_workload(dtype=torch.bfloat16):
    """(documents, a call that serves them once)."""
    cfg = EEModelConfig(
        backbone=LayoutLMv3Config.base(num_labels=16),
        exit=ExitConfig(exits="text_avg,vision_avg,7"),
    )
    model = init_ee_params(cfg, torch.Generator().manual_seed(0), dtype=dtype)
    tok = HashWordTokenizer(vocab_size=cfg.backbone.vocab_size)
    feats, pages = synthetic_pages(N_BATCHES * B, np.random.default_rng(0), tok, S_TEXT)
    batch = {k: torch.from_numpy(v).cuda() for k, v in feats.items()}
    batch["pixel_values"] = preprocess_images(torch.from_numpy(pages).cuda(), size=224)
    pipe = Pipeline(model, cfg, threshold=0.5, batch_size=B, tokenizer=tok,
                    exit_distribution={0: 0.05, 1: 0.05, 2: 0.8, 3: 0.1})
    if pipe.capacities != (16, 8):
        raise RuntimeError(f"capacities {pipe.capacities}, expected (16, 8)")
    return N_BATCHES * B, lambda: pipe.predict_features(batch)


def train_workload(scan_fold: int, remat: bool, attn_dropout: float, f32: bool = False):
    """(documents, a call that takes TRAIN_TRACED_STEPS training steps)."""
    cfg, model32, batches, args = train_setup(TRAIN_TRACED_STEPS, scan_fold, remat, attn_dropout)
    if f32:
        args = dataclasses.replace(args, bf16=False)
    trainer = EETrainer(cfg, copy.deepcopy(model32), args, total_steps=1000, device="cuda")
    gen = torch.Generator().manual_seed(1)

    def steps():
        for b in batches:
            trainer.train_step(b, gen)

    return TRAIN_TRACED_STEPS * B, steps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mode", choices=("serve", "train"), default="serve")
    parser.add_argument("--scan-fold", type=int, default=12,
                        help="train: layers per encoder step (12 chains the bias cotangent)")
    parser.add_argument("--remat", action="store_true",
                        help="train: gradient_checkpointing of each group of layers")
    parser.add_argument("--attn-dropout", type=float, default=0.1,
                        help="train: the attention-probability dropout rate")
    parser.add_argument("--f32", action="store_true",
                        help="an f32 model served, or trained without mixed precision")
    opts = parser.parse_args()
    mode = opts.mode
    if not torch.cuda.is_available():
        print("profile_torch_pipeline: no CUDA device", file=sys.stderr)
        return 1
    documents, run = (serve_workload(torch.float32 if opts.f32 else torch.bfloat16)
                      if mode == "serve" else
                      train_workload(opts.scan_fold, opts.remat, opts.attn_dropout, opts.f32))
    for _ in range(2):
        run()  # warm-up
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0.0)
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = {"device_ms": dev_us / 1e3, "count": evt.count}
    device_ms = sum(k["device_ms"] for k in kernels.values())
    groups = {}
    for name, k in kernels.items():
        g = groups.setdefault(group_of(name), {"device_ms": 0.0, "count": 0})
        g["device_ms"] += k["device_ms"]
        g["count"] += k["count"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    result = {
        "mode": mode, "device": smi, "dtype": "f32" if opts.f32 else "bf16",
        "schedule": None if mode == "serve" else {
            "scan_fold": opts.scan_fold, "remat": opts.remat, "attn_dropout": opts.attn_dropout},
        "documents": documents, "wall_ms": wall_ms,
        "docs_per_sec": documents / (wall_ms / 1e3),
        "device_ms": device_ms,
        "busy_share": device_ms / wall_ms if device_ms else None,
        "groups": groups,
        "launches": sum(k["count"] for k in kernels.values()),
    }
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["device_ms"])[:12]
    for name, k in top:
        print(f"{k['device_ms']:9.3f} ms  {k['count']:5d}x  {name[:100]}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
