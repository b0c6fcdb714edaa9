#!/usr/bin/env python3
"""Where the served path of the PyTorch port spends its time, on one GPU.

    python3 scripts/profile_torch_pipeline.py

Builds EE LayoutLMv3-base (bf16, random weights from seed 0, exits text_avg,
vision_avg, 7) and a ``Pipeline`` at batch 16 with capacities (16, 8), the
configuration ``chip_smoke.py`` serves. With static capacities a batch costs
the same whatever its exits, so the threshold only needs to be valid. After
a warm-up it traces ``predict_features`` over 4 batches with
``torch.profiler`` and prints the device time by kernel group (the port's two
kernels, cuBLAS GEMMs, everything else), the wall time, and the device's busy
share (kernel time over wall time; one stream, so kernels do not overlap).
The next-to-last line is the per-kernel table as JSON, the last the summary.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import B, N_BATCHES, S_TEXT, synthetic_pages  # noqa: E402
from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig  # noqa: E402
from multi_modal_early_exit_tpu_torch.data.features import HashWordTokenizer  # noqa: E402
from multi_modal_early_exit_tpu_torch.data.images import preprocess_images  # noqa: E402
from multi_modal_early_exit_tpu_torch.models.ee.model import init_ee_params  # noqa: E402
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import (  # noqa: E402
    EEModelConfig,
    LayoutLMv3Config,
)
from multi_modal_early_exit_tpu_torch.serving import Pipeline  # noqa: E402

GROUPS = (
    ("materialize_bias", ("materialize_bias_kernel",)),
    ("flash_attention_packed", ("flash_attention_packed_kernel",)),
    ("gemm", ("nvjet", "gemm", "xmma", "cutlass", "cublas")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_pipeline: no CUDA device", file=sys.stderr)
        return 1
    cfg = EEModelConfig(
        backbone=LayoutLMv3Config.base(num_labels=16),
        exit=ExitConfig(exits="text_avg,vision_avg,7"),
    )
    model = init_ee_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    tok = HashWordTokenizer(vocab_size=cfg.backbone.vocab_size)
    feats, pages = synthetic_pages(N_BATCHES * B, np.random.default_rng(0), tok, S_TEXT)
    batch = {k: torch.from_numpy(v).cuda() for k, v in feats.items()}
    batch["pixel_values"] = preprocess_images(torch.from_numpy(pages).cuda(), size=224)
    pipe = Pipeline(model, cfg, threshold=0.5, batch_size=B, tokenizer=tok,
                    exit_distribution={0: 0.05, 1: 0.05, 2: 0.8, 3: 0.1})
    if pipe.capacities != (16, 8):
        raise RuntimeError(f"capacities {pipe.capacities}, expected (16, 8)")
    for _ in range(2):
        pipe.predict_features(batch)  # warm-up
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pipe.predict_features(batch)
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
        "device": smi,
        "documents": N_BATCHES * B, "wall_ms": wall_ms,
        "docs_per_sec": N_BATCHES * B / (wall_ms / 1e3),
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
