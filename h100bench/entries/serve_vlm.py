"""serve_vlm: ``serving.Pipeline.predict_features`` over scanned pages, each
read by a vision-language backbone (early-exit Kimi-VL) at its own
resolution, one caller in a closed loop, back-to-back requests of one batch
of pages each.

A page is a patch grid h x w, h w log-uniform on ``patches`` and h / w on
``aspect``, both even (the 2 x 2 merge), h w at most ``max_patches``; its
pixels a white sheet with dark lines of text-like strokes, normalised to
[-1, 1] and cut into 14 x 14 x 3 patch rows of 588 values, row-major,
padded with zeros to ``max_patches`` rows. Its row of tokens is the page's
h w / 4 placeholder ids, then ``prompt_tokens`` prompt ids uniform over the
vocabulary (the placeholder excluded), right-padded to ``seq_len``. Pages
and ids come from the seed; the pool's pixels live on the card in the
serving type.

Set-up makes the pool and the weights (``h100bench.kimi_vl``), builds the
port's ``EEModel``, runs its batched forward over the whole pool to point
each head at the directions in which pages differ and to set the
thresholds (as ``entries/serve_lm.py`` does), builds the ``Pipeline`` and
serves ``warmup_calls`` requests. The traced slice serves requests of pool
pages drawn from the seed alone, so what it reads does not follow the
window's length.

The check, as ``serve_lm``'s: each of ``check_calls`` sampled requests of
the window is served once more through the same ``Pipeline``, recording
each stage's rows, every expert layer's choices and the projector's output;
the program is freed, and the f32 reference (``reference/kimi_vl.py``) runs
with those expert choices forced. ``vision_err`` is the largest relative L2
error of a checked page's projector output against the reference's. The
control puts the reference in float8, routing for itself, in the program's
place.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100bench import kimi_vl, moonlight, port, traffic
from h100bench.entries import serve_lm
from h100bench.entries.serve import answers_of, compact, judge, mismatch_pct, thresholds_for
from h100bench.reference import cascade as ref_cascade
from h100bench.reference import kimi_vl as ref
from h100bench.reference import moonlight as moon_ref

KEYS = ("input_ids", "attention_mask", "pixel_values", "image_grid_hws")


def page_grids(rng: np.random.Generator, n: int, mix: dict) -> np.ndarray:
    """(n, 2) patch grids: h w log-uniform on ``patches``, h / w uniform on
    ``aspect``, each side rounded to an even count, the longer side then
    stepped down (the shorter up) by 2 while h w leaves the range."""
    lo, hi = mix["patches"]
    cap = min(hi, mix["max_patches"])
    area = np.exp(rng.uniform(np.log(lo), np.log(hi), n))
    ratio = rng.uniform(*mix["aspect"], n)
    grids = []
    for a, r in zip(area, ratio):
        h, w = (max(2, 2 * int(round(s / 2))) for s in (np.sqrt(a * r), np.sqrt(a / r)))
        while h * w > cap:
            h, w = (h - 2, w) if h >= w else (h, w - 2)
        while h * w < lo:
            h, w = (h, w + 2) if h >= w else (h + 2, w)
        grids.append((h, w))
    return np.array(grids, np.int64)


def page_pixels(grid, gen: torch.Generator, cfg: dict, max_patches: int, device,
                dtype) -> torch.Tensor:
    """(len(grid), max_patches, 588) patch rows: each page white, with a
    line of dark strokes every 20 pixel rows (6 to 9 rows thick, random
    start, end and shade a line), in [-1, 1]."""
    v = kimi_vl.vision(cfg)
    p, c = v["patch_size"], v["num_channels"]
    out = torch.zeros((len(grid), max_patches, c * p * p), device=device, dtype=dtype)
    for i, (h, w) in enumerate(grid):
        height, width = h * p, w * p
        lines = max(height // 20, 1)
        y = torch.arange(height, device=device)
        x = torch.arange(width, device=device)
        thick = torch.randint(6, 10, (lines,), generator=gen, device=device)
        x0 = torch.randint(0, max(width // 4, 1), (lines,), generator=gen, device=device)
        x1 = torch.randint(width // 2, width, (lines,), generator=gen, device=device)
        shade = torch.rand((lines,), generator=gen, device=device) * 0.5
        line, off = y // 20, y % 20
        rows_in = (line < lines) & (off < thick[line.clamp(max=lines - 1)])
        lid = line.clamp(max=lines - 1)
        cols_in = (x[None, :] >= x0[lid, None]) & (x[None, :] < x1[lid, None])
        img = torch.where(rows_in[:, None] & cols_in, shade[lid, None], 1.0)
        img = img * 2 - 1
        patches = img.reshape(h, p, w, p).permute(0, 2, 1, 3).reshape(h * w, 1, p, p)
        out[i, :h * w] = patches.expand(h * w, c, p, p).reshape(h * w, -1).to(dtype)
    return out


def make_pool(seed: int, cfg: dict, mix: dict, device, dtype) -> dict:
    """The pool: host ids, mask and grids, the pages' patch rows on
    ``device``."""
    rng = np.random.default_rng([seed, 1])
    n, s = mix["pool"], mix["seq_len"]
    v = kimi_vl.vision(cfg)
    grids = page_grids(rng, n, mix)
    tokens = grids.prod(axis=1) // (v["merge_kernel_size"][0] * v["merge_kernel_size"][1])
    lengths = tokens + mix["prompt_tokens"]
    if lengths.max() > s:
        raise ValueError(f"a page's {lengths.max()} tokens exceed seq_len {s}")
    placeholder = cfg["media_placeholder_token_id"]
    prompt = rng.integers(0, cfg["vocab_size"] - 1, (n, s))
    prompt = (prompt + (prompt >= placeholder)).astype(np.int32)  # never the placeholder
    pos = np.arange(s)[None, :]
    ids = np.where(pos < tokens[:, None], placeholder, prompt).astype(np.int32)
    mask = (pos < lengths[:, None]).astype(np.int32)
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    return {"input_ids": ids * mask, "attention_mask": mask, "image_grid_hws": grids,
            "pixel_values": page_pixels(grids, gen, cfg, mix["max_patches"], device, dtype)}


class Entry(serve_lm.Entry):
    """``serve_lm``'s Entry over pages: its window, sample and ``free_program``
    as they are; the pool, the weights, the calibration, the requests, the
    slice, the replay and the check's comparison its own."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, log):
        from multi_modal_early_exit_tpu_torch.serving import Pipeline
        from multi_modal_early_exit_tpu_torch.utils import profiling

        self.cfg, self.mix, self.seed, self.device, self.log = cfg, mix, seed, device, log
        # a program without the Kimi-VL model raises here, before any work
        self.model_cfg = kimi_vl.port_config(cfg)
        self.batch = mix["batch"]
        self.dist = {int(k): v for k, v in mix["exit_distribution"].items()}
        n_exits = len(moonlight.encoder_exits(cfg))
        self.caps = ref_cascade.capacities(self.dist, self.batch, 0, n_exits + 1,
                                           mix["capacity_tail"])
        t0 = time.perf_counter()
        self.dtype = port.DTYPES[cfg["serve_dtype"]]
        self.pool = make_pool(seed, cfg, mix, device, self.dtype)
        lengths = self.pool["attention_mask"].sum(axis=1)
        patches = self.pool["image_grid_hws"].prod(axis=1)
        self.doc_flops = np.array([[kimi_vl.doc_flops_to_exit(cfg, e, int(p), int(n))
                                    for e in range(n_exits + 1)]
                                   for p, n in zip(patches, lengths)])
        # one copy of the weights: the program's parameters and the reference's
        self.w = kimi_vl.make(cfg, seed, device, self.dtype)
        model = kimi_vl.port_model(cfg, self.w, device)
        self.calibrate(model)
        profiling.counters(reset=True)
        self.pipe = Pipeline(model, self.model_cfg, threshold=self.thresholds,
                             batch_size=self.batch, exit_distribution=self.dist,
                             tokenizer=object(), capacity_tail=mix["capacity_tail"],
                             device=device)
        self.batches = traffic.Batches(seed, mix["pool"], self.batch)
        self.slice_rng = np.random.default_rng([seed, 4])
        self.slice_counts = []  # (patches, patch pairs) the program counted a slice batch
        self.calls = []
        log.write(f"serve_vlm: set-up {time.perf_counter() - t0:.2f} s (pool, weights, "
                  f"program, calibration); capacities {self.pipe.capacities} (reference "
                  f"{self.caps}), thresholds {[round(t, 5) for t in self.thresholds]}, "
                  f"patches a page {float(patches.mean()):.1f} (mean), tokens "
                  f"{float(lengths.mean()):.1f}\n")

    def calibrate(self, model) -> None:
        """``serve_lm.Entry.calibrate``'s heads and thresholds, from the
        program's batched forward over the pages."""
        from multi_modal_early_exit_tpu_torch.models.kimi_vl.modeling import last_token_states

        n, bb_cfg = self.mix["calibration_docs"], self.model_cfg.backbone
        layers = moonlight.encoder_exits(self.cfg) + [self.cfg["num_hidden_layers"]]
        taps = [[] for _ in layers]
        with torch.no_grad():
            for a in range(0, n, self.batch):
                req = self.request(np.arange(a, min(a + self.batch, n)))
                states = last_token_states(model.backbone, bb_cfg, req["input_ids"],
                                           req["attention_mask"], req["pixel_values"],
                                           req["image_grid_hws"])
                for j, layer in enumerate(layers):
                    taps[j].append(states[layer - 1].float())
        k = self.cfg["num_labels"]
        ref_model = moon_ref.Model(self.w, self.cfg)
        logits = []
        with torch.no_grad(), moon_ref.full_f32():
            x_final = ref_model.rms(torch.cat(taps[-1]), self.w["backbone.norm.weight"].float())
            inputs = [torch.cat(t) for t in taps[:-1]] + [x_final]
            for name, x in zip(moonlight.head_names(self.cfg), inputs):
                z = ref_model.features(x, name)
                mean = z.mean(dim=0)
                _, sv, vh = torch.linalg.svd(z - mean, full_matrices=False)
                proj = vh[:k] / (sv[:k, None] / (n - 1) ** 0.5)
                self.w[f"{name}.out_proj.weight"].copy_(proj)
                self.w[f"{name}.out_proj.bias"].copy_(-(proj @ mean))
                logits.append(ref_model.head(x, name))
        self.thresholds = thresholds_for(moon_ref.max_confidence(torch.stack(logits)),
                                         self.dist, self.mix["threshold_window"])

    def request(self, rows) -> dict:
        """The pool's ``rows`` as tensors on the device: the reference's input."""
        return {k: (v if torch.is_tensor(v) else torch.from_numpy(v)).to(self.device)
                for k, v in traffic.gather(self.pool, rows, KEYS).items()}

    def serve_one(self):
        rows = self.batches.next()
        req = traffic.gather(self.pool, rows, KEYS)
        t0 = time.perf_counter()
        answers = self.pipe.predict_features(req)
        return rows, answers, time.perf_counter() - t0

    def slice(self, n: int) -> int:
        """``n`` requests of pool pages drawn from the seed alone, each
        request's counted patches and patch pairs kept for the attention's
        bound."""
        from multi_modal_early_exit_tpu_torch.utils import profiling

        for _ in range(n):
            rows = self.slice_rng.choice(self.mix["pool"], self.batch, replace=False)
            before = profiling.counters()
            self.pipe.predict_features(traffic.gather(self.pool, rows, KEYS))
            after = profiling.counters()
            if "vit.patch_pairs" in after:
                self.slice_counts.append(tuple(
                    after[k] - before.get(k, 0) for k in ("vit.patches", "vit.patch_pairs")))
        return n

    def attention_calls(self, units: int) -> list:
        """(patches, patch pairs) of each request the slice served, as the
        program counted them (none from a program without the counters)."""
        return list(self.slice_counts)

    def replay(self, rows):
        """Serve the request of ``rows`` once more through the ``Pipeline``,
        recording each stage's rows and mask, each expert layer's choices
        and the projector's output: (its answers, per expert layer the
        (tokens, k) experts each real token ran in row order, -1 where its
        row had left; each page's (h w / 4, H) projector output in f32)."""
        from multi_modal_early_exit_tpu_torch.models.kimi_vl import modeling as vlm
        from multi_modal_early_exit_tpu_torch.models.moonlight import modeling

        stages, chosen, pages = [], [], []
        route, layers, vision = modeling.route, modeling.CascadeStages.layers, vlm.vision_apply

        def recording_route(p, cfg, x):
            c, w = route(p, cfg, x)
            chosen.append(c.cpu())
            return c, w

        def recording_layers(stages_obj, model, state, sel, a, b, rope):
            stages.append((sel.cpu(), state[1][sel].cpu(), a, b))
            return layers(stages_obj, model, state, sel, a, b, rope)

        def recording_vision(bb, cfg, pixel_values, grid):
            out = vision(bb, cfg, pixel_values, grid)
            pages.append((out.float().cpu(), list(grid)))
            return out

        modeling.route, modeling.CascadeStages.layers = recording_route, recording_layers
        vlm.vision_apply = recording_vision
        try:
            answers = self.pipe.predict_features(traffic.gather(self.pool, rows, KEYS))
        finally:
            modeling.route, modeling.CascadeStages.layers = route, layers
            vlm.vision_apply = vision
        (features, grid), = pages
        merged = np.prod(kimi_vl.vision(self.cfg)["merge_kernel_size"])
        features = list(features.split([h * w // merged for h, w in grid]))[:len(rows)]
        lengths = self.pool["attention_mask"][rows].sum(axis=1)
        starts = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)[:-1]]))
        first = self.cfg["first_k_dense_replace"]
        k = self.cfg["num_experts_per_tok"]
        routes = [torch.full((int(lengths.sum()), k), -1, dtype=torch.int64)
                  for _ in range(self.cfg["num_hidden_layers"] - first)]
        calls = iter(chosen)
        for sel, mask, a, b in stages:
            flat = mask.reshape(-1).nonzero().squeeze(1)  # the program's token order
            dest = starts[sel[flat // mask.shape[1]]] + flat % mask.shape[1]
            for layer in range(max(a, first), b):
                parts = []  # a layer routes its tokens in one call a pass
                while sum(len(c) for c in parts) < len(dest):
                    parts.append(next(calls))
                routes[layer - first][dest] = torch.cat(parts)
        return compact(answers), routes, features

    def reference(self, rows, fp8_products: bool = False, routes=None):
        out = ref.infer(self.w, self.cfg, self.request(rows), self.mix["reference_block"],
                        fp8_products, routes)
        decisions = ref_cascade.decide(moon_ref.max_confidence(out["logits"]), self.thresholds,
                                       self.caps, 0)
        return out, decisions

    def compared(self, served: list, label: str) -> dict:
        """The check's numbers for ``served``, one (rows, answers, routes,
        page features) a request: the answers judged against the f32
        reference forced to the routes, ``route_margin`` and
        ``vision_err``."""
        t0 = time.perf_counter()
        answers, logits, exits, forced = [], [], [], []
        margin, unlike, pairs, vision_err = 0.0, 0, 0, 0.0
        for rows, got, routes, features in served:
            out, (e, f) = self.reference(rows, routes=routes)
            answers.append(got)
            logits.append(out["logits"])
            exits += e
            forced += f
            margin = max(margin, out["routes"]["margin"])
            unlike += out["routes"]["unlike"]
            pairs += out["routes"]["pairs"]
            for mine, want in zip(features, out["vision"]):
                want = want.cpu()
                vision_err = max(vision_err, float((mine - want).norm() / want.norm()))
        answers = np.concatenate(answers)
        numbers, conf = judge(answers, torch.cat(logits, dim=1), self.thresholds,
                              len(self.thresholds))
        numbers["route_margin"] = margin
        numbers["vision_err"] = vision_err
        self.log.write(f"serve_vlm: {label}: {len(answers)} pages checked in "
                       f"{time.perf_counter() - t0:.1f} s; decisions unlike the reference's "
                       f"{mismatch_pct(answers, (exits, forced))} %, confidence error {conf}, "
                       f"forced expert choices the reference would not make "
                       f"{100.0 * unlike / max(pairs, 1)} % of {pairs}\n")
        return numbers

    def check(self) -> dict:
        caps = tuple(self.pipe.capacities)
        replayed, unlike = [], 0
        for rows, answers in self.sample():
            again, routes, features = self.replay(rows)
            unlike += int((again != answers).any(axis=1).sum())
            replayed.append((rows, answers, routes, features))
        self.log.write(f"serve_vlm: replayed answers unlike the window's: {unlike}\n")
        self.free_program()
        numbers = self.compared(replayed, "program")
        numbers["capacity_mismatch"] = float(caps != tuple(self.caps))
        return numbers

    def control(self) -> dict:
        """The same numbers for the reference in float8, routing for itself
        and reading its own float8 pages, in the program's place."""
        played = []
        for rows, _ in self.sample():
            out8, decisions8 = self.reference(rows, True)
            played.append((rows, answers_of(out8["logits"], decisions8),
                           [c.cpu() for c in out8["chosen"]], [p.cpu() for p in out8["vision"]]))
        return self.compared(played, "control")
