#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each reported on its own line:

1. device: the card's name and power limit (nvidia-smi) and capability;
2. build: the hand-written CUDA kernels, from ``csrc/`` in this checkout;
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes (batch 16, 709 tokens padded to 768, 12 heads x 64, bf16):
   ``materialize_bias`` bit-equal, ``flash_attention_packed`` within 1e-2;
   times by CUDA events after warm-up, beside the least time the card could
   take and one PyTorch library call where one computes the same function;
4. main path: EE LayoutLMv3-base (exits text_avg, vision_avg, 7; random
   weights from a seed, bf16) served through ``Pipeline.predict_features``
   at batch 16 with capacities (16, 8), from word features and uint8 page
   images normalised on the card. Checks: well-formed results and finite
   logits; launch counts of one bias build and 12 attention calls per batch;
   at full capacity the cascade's exits equal ``decide_exits(ee_forward())``
   away from the thresholds; the bf16 kernel path agrees with the f32 plain
   path (on the CPU) on a small input.

The next-to-last line is a JSON object with one entry per kernel, the last
``{"ok": true, "device": {...}}``. Every failed check raises, so the script
exits non-zero; it needs a CUDA device and the repository's package.
"""

from __future__ import annotations

import copy
import json
import math
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
B, S_TEXT, HEADS, HEAD_DIM = 16, 512, 12, 64
N_BATCHES = 4


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


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
    return name


def phase_build():
    from multi_modal_early_exit_tpu_torch.ops import cuda_build

    secs = cuda_build.build_all()
    print(f"build: {len(cuda_build.SOURCES)} kernel libraries in {secs:.1f} s "
          f"({cuda_build.find_nvcc()})")


def main_path_bias_inputs(dev, gen):
    """The main path's bias inputs: text positions then visual ones,
    x0/y1 of word boxes and of the visual patch grid, ragged text masks."""
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import LayoutLMv3Config
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import (
        sequence_layout,
    )

    cfg = LayoutLMv3Config.base()
    lengths = torch.randint(50, S_TEXT + 1, (B,), generator=gen)
    mask = (torch.arange(S_TEXT)[None] < lengths[:, None]).to(torch.int32)
    bbox = torch.sort(torch.randint(0, 1000, (B, S_TEXT, 4), generator=gen), -1).values
    full_bbox, pos, full_mask = sequence_layout(
        cfg, bbox.to(dev), mask.to(dev), cfg.num_visual_tokens
    )
    scale = 1.0 / math.sqrt(HEAD_DIM)
    tables = [(torch.randn((n, HEADS), generator=gen) * 0.02 * scale).to(dev)
              for n in (cfg.rel_pos_bins, cfg.rel_2d_pos_bins, cfg.rel_2d_pos_bins)]
    vecs = [pos, full_bbox[:, :, 0].contiguous(), full_bbox[:, :, 3].contiguous(), full_mask]
    return vecs + tables


def phase_kernels(name):
    from multi_modal_early_exit_tpu_torch.ops.flash_attention import (
        flash_attention_packed,
        flash_attention_packed_plain,
    )
    from multi_modal_early_exit_tpu_torch.ops.fused_bias_attention import (
        materialize_bias,
        materialize_bias_plain,
    )

    bw, bf16_peak, f32_peak = peaks_for(name)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    args = main_path_bias_inputs(dev, gen)
    s = args[0].shape[1]  # 709
    results = []

    # ---- materialize_bias: bit-equal to its plain version ---------------
    bias = materialize_bias(*args)
    plain = materialize_bias_plain(*args)
    torch.cuda.synchronize()
    p = bias.shape[-1]
    check(bias.shape == (B, HEADS, p, p) and p == 768, f"bias shape {tuple(bias.shape)}")
    check(torch.equal(bias, plain), "materialize_bias differs from its plain version")
    err = (bias.float() - plain.float()).abs().max().item()
    out_bytes = B * HEADS * p * p * 2
    in_bytes = sum(a.numel() * a.element_size() for a in args)
    adds = 3 * B * HEADS * p * p  # two table sums and the mask, f32
    bound_bytes, bound_ops = (out_bytes + in_bytes) / bw, adds / f32_peak
    entry = dict(
        name="materialize_bias", route="cuda",
        source="multi_modal_early_exit_tpu_torch/csrc/materialize_bias.cu",
        replaces="multi_modal_early_exit_tpu/ops/fused_bias_attention.py:244",
        ms=time_ms(lambda: materialize_bias(*args)),
        plain_ms=time_ms(lambda: materialize_bias_plain(*args), iters=5),
        bound_ms=max(bound_bytes, bound_ops) * 1e3,
        bound_by="bytes" if bound_bytes >= bound_ops else "operations",
        library_ms=None, max_abs_err=err, ok=True,
    )
    results.append(entry)
    print(f"kernel materialize_bias: bit-equal, kernel_ms {entry['ms']:.4f}, "
          f"plain_ms {entry['plain_ms']:.4f}, library_ms null, "
          f"bound {entry['bound_ms'] * 1e3:.1f} us ({entry['bound_by']}), max_err {err}")

    # ---- flash_attention_packed: within 1e-2 of its plain version -------
    q, k, v = (torch.randn((B, s, HEADS * HEAD_DIM), generator=gen)
               .to(dev, torch.bfloat16) for _ in range(3))
    out = flash_attention_packed(q, k, v, bias, HEADS)
    ref = flash_attention_packed_plain(q, k, v, bias, HEADS)
    torch.cuda.synchronize()
    check(torch.isfinite(out.float()).all().item(), "flash_attention_packed gave non-finite values")
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= 1e-2, f"flash_attention_packed max error {err} > 1e-2")

    def heads(x):
        return x.view(B, s, HEADS, HEAD_DIM).transpose(1, 2)

    mask4 = bias[:, :, :s, :s]
    library = torch.nn.functional.scaled_dot_product_attention
    lib_out = library(heads(q), heads(k), heads(v), attn_mask=mask4)
    lib_err = (lib_out.transpose(1, 2).reshape(B, s, -1).float() - ref.float()).abs().max().item()
    check(lib_err <= 5e-2, f"the library attention disagrees with the plain one by {lib_err}")
    # the function needs the S x S bias block, q/k/v and writes o
    att_bytes = B * HEADS * s * s * 2 + 4 * B * s * HEADS * HEAD_DIM * 2
    flops = 4 * B * s * s * HEADS * HEAD_DIM
    bound_bytes, bound_ops = att_bytes / bw, flops / bf16_peak
    entry = dict(
        name="flash_attention_packed", route="cuda",
        source="multi_modal_early_exit_tpu_torch/csrc/flash_attention_packed.cu",
        replaces="multi_modal_early_exit_tpu/ops/flash_attention.py:446",
        ms=time_ms(lambda: flash_attention_packed(q, k, v, bias, HEADS)),
        plain_ms=time_ms(lambda: flash_attention_packed_plain(q, k, v, bias, HEADS), iters=5),
        bound_ms=max(bound_bytes, bound_ops) * 1e3,
        bound_by="bytes" if bound_bytes >= bound_ops else "operations",
        library_ms=time_ms(lambda: library(heads(q), heads(k), heads(v), attn_mask=mask4)),
        max_abs_err=err, ok=True,
    )
    results.append(entry)
    print(f"kernel flash_attention_packed: max_err {err:.3e} (tol 1e-2), "
          f"kernel_ms {entry['ms']:.4f}, plain_ms {entry['plain_ms']:.4f}, "
          f"library_ms {entry['library_ms']:.4f} (SDPA, max diff {lib_err:.3e}), "
          f"bound {entry['bound_ms'] * 1e3:.1f} us ({entry['bound_by']})")
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


def phase_main_path():
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
    from multi_modal_early_exit_tpu_torch.ops.flash_attention import flash_attention_packed
    from multi_modal_early_exit_tpu_torch.ops.fused_bias_attention import materialize_bias
    from multi_modal_early_exit_tpu_torch.serving import Pipeline

    cfg = EEModelConfig(
        backbone=LayoutLMv3Config.base(num_labels=16),
        exit=ExitConfig(exits="text_avg,vision_avg,7"),
    )
    t0 = time.perf_counter()
    model32 = init_ee_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    n_params = sum(p.numel() for p in model32.parameters())
    model = copy.deepcopy(model32).to("cuda", torch.bfloat16)
    print(f"main path: EE LayoutLMv3-base, {n_params / 1e6:.1f}M params, bf16, "
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

    # the bf16 kernel path against the f32 plain path on the CPU, 2 documents,
    # with the heads as initialised
    small = [a[:2] for a in chunks[0]]
    cpu_out = ee_forward(model32, cfg, *[a.cpu() for a in small])
    gpu_out = ee_forward(model, cfg, *small)
    a, b = gpu_out.policy_logits().float().cpu(), cpu_out.policy_logits()
    ref_err = (a - b).abs().max().item()
    check(bool(torch.isfinite(a).all()), "non-finite logits on the kernel path")
    check(bf16_close(ref_err, b), f"kernel path vs f32 plain path: {ref_err}")
    print(f"reference: bf16 kernel path vs f32 plain path (CPU), 2 documents: "
          f"policy-logit max diff {ref_err:.3e} at logit scale {b.abs().max().item():.2f}")

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
    materialize_bias.launches = 0
    flash_attention_packed.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = pipe.predict_features(batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"materialize_bias": materialize_bias.launches,
                "flash_attention_packed": flash_attention_packed.launches}
    check(len(results) == n_docs, f"{len(results)} results for {n_docs} documents")
    order = [str(e) for e in pipe.order] + ["final"]
    for r in results:
        check(r["exit_name"] in order and 0.0 <= r["confidence"] <= 1.0
              and math.isfinite(r["confidence"]) and r["label_id"] in range(16),
              f"malformed result {r}")
    check(launches["materialize_bias"] == N_BATCHES, f"bias launches {launches}")
    check(launches["flash_attention_packed"] == 12 * N_BATCHES, f"attention launches {launches}")
    hist = {name: sum(r["exit_name"] == name for r in results) for name in order}
    forced = sum(r["capacity_exited"] for r in results)
    check(forced > 0 and hist["final"] > 0 and hist[order[0]] + hist[order[1]] > 0,
          f"expected early, forced and final exits: {hist}, forced {forced}")
    print(f"served {n_docs} documents in {N_BATCHES} batches of {B}: "
          f"{n_docs / dt:.1f} docs/sec (predict_features, host clock), "
          f"exits {hist}, capacity-exited {forced}, launches {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # fails here, before any output, when run outside the repository
    import multi_modal_early_exit_tpu_torch  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_device()
    phase_build()
    kernels = phase_kernels(name)
    launches = phase_main_path()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "ok")
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
