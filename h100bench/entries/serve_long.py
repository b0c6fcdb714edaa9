"""serve_long: ``serving.Pipeline.predict_features`` over long OCR text (whole
filings and contracts) for a long-context hybrid backbone (early-exit
Kimi-Linear), one caller in a closed loop, back-to-back requests of one
batch of documents each.

A document is its token ids, right-padded to ``seq_len``, and its attention
mask: lengths log-uniform on ``lengths``, ids uniform over the vocabulary,
all from the seed (``serve_lm.make_pool``). Set-up makes the pool and the
weights (``h100bench.kimi_linear``: the card's share of the experts), builds
the port's ``EEModel`` on them, points each head at the directions in
which the pool's documents differ and sets the thresholds from the
program's batched forward (as ``serve_lm`` does), builds the ``Pipeline``
and serves ``warmup_calls`` requests. The traced slice serves requests of
pool documents drawn from the seed alone, each request's ``kda.tokens``
kept for the KDA core's bound.

The check, as ``serve_lm``'s: each of ``check_calls`` sampled requests of
the window is served once more through the same ``Pipeline``, recording
each stage's rows and every expert layer's choices, and every KDA core
call's output is held against the reference's f32 chunked core on the
same inputs, row by row over its real tokens (``kda_err``, the largest
error over the reference's largest value); the program is freed, and the
f32 reference (``reference/kimi_linear.py``) runs with the expert choices
forced. The control puts the reference in float8, routing for itself, in
the program's place; its ``kda_err`` holds each float8 core against the
f32 core on the same inputs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100bench import kimi_linear, moonlight, port, traffic
from h100bench.entries import serve_lm
from h100bench.entries.serve import answers_of, compact, judge, mismatch_pct, thresholds_for
from h100bench.reference import cascade as ref_cascade
from h100bench.reference import kimi_linear as ref
from h100bench.reference import moonlight as moon_ref

KEYS = serve_lm.KEYS


class Entry(serve_lm.Entry):
    """``serve_lm``'s Entry over long documents: its window, sample,
    request, serve_one and ``free_program`` as they are; the weights, the
    calibration, the slice, the replay and the check's comparison its
    own."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, log):
        from multi_modal_early_exit_tpu_torch.serving import Pipeline
        from multi_modal_early_exit_tpu_torch.utils import profiling

        self.cfg, self.mix, self.seed, self.device, self.log = cfg, mix, seed, device, log
        # a program without the Kimi-Linear model raises here, before any work
        self.model_cfg = kimi_linear.port_config(cfg)
        self.batch = mix["batch"]
        self.dist = {int(k): v for k, v in mix["exit_distribution"].items()}
        n_exits = len(moonlight.encoder_exits(cfg))
        self.caps = ref_cascade.capacities(self.dist, self.batch, 0, n_exits + 1,
                                           mix["capacity_tail"])
        t0 = time.perf_counter()
        self.pool = serve_lm.make_pool(seed, cfg, mix)
        lengths = self.pool["attention_mask"].sum(axis=1)
        self.doc_flops = np.array([[kimi_linear.doc_flops_to_exit(cfg, e, int(n))
                                    for e in range(n_exits + 1)] for n in lengths])
        self.dtype = port.DTYPES[cfg["serve_dtype"]]
        # one copy of the weights: the program's parameters and the reference's
        self.w = kimi_linear.make(cfg, seed, device, self.dtype)
        model = kimi_linear.port_model(cfg, self.w, device)
        self.calibrate(model)
        profiling.counters(reset=True)
        self.pipe = Pipeline(model, self.model_cfg, threshold=self.thresholds,
                             batch_size=self.batch, exit_distribution=self.dist,
                             tokenizer=object(), capacity_tail=mix["capacity_tail"],
                             device=device)
        self.batches = traffic.Batches(seed, mix["pool"], self.batch)
        self.slice_rng = np.random.default_rng([seed, 4])
        self.slice_tokens = []  # kda.tokens the program counted a slice request
        self.calls = []
        log.write(f"serve_long: set-up {time.perf_counter() - t0:.2f} s (pool, weights, "
                  f"program, calibration); capacities {self.pipe.capacities} (reference "
                  f"{self.caps}), thresholds {[round(t, 5) for t in self.thresholds]}, tokens "
                  f"a document {float(lengths.mean()):.1f} (mean)\n")

    def calibrate(self, model) -> None:
        """``serve_lm.Entry.calibrate``'s heads and thresholds, from the
        program's batched forward over the pool."""
        from multi_modal_early_exit_tpu_torch.models.kimi_linear.modeling import last_token_states

        n, bb_cfg = self.mix["calibration_docs"], self.model_cfg.backbone
        layers = moonlight.encoder_exits(self.cfg) + [self.cfg["num_hidden_layers"]]
        taps = [[] for _ in layers]
        with torch.no_grad():
            for a in range(0, n, self.batch):
                req = self.request(np.arange(a, min(a + self.batch, n)))
                states = last_token_states(model.backbone, bb_cfg, req["input_ids"],
                                           req["attention_mask"])
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

    def slice(self, n: int) -> int:
        """``n`` requests of pool documents drawn from the seed alone, each
        request's counted ``kda.tokens`` kept for the core's bound."""
        from multi_modal_early_exit_tpu_torch.utils import profiling

        for _ in range(n):
            rows = self.slice_rng.choice(self.mix["pool"], self.batch, replace=False)
            before = profiling.counters().get("kda.tokens", 0)
            self.pipe.predict_features(traffic.gather(self.pool, rows, KEYS))
            after = profiling.counters().get("kda.tokens")
            if after is not None:
                self.slice_tokens.append(after - before)
        return n

    def attention_calls(self, units: int) -> list:
        """The KDA core's real tokens of each request the slice served, as
        the program counted them (none from a program without the
        counter)."""
        return list(self.slice_tokens)

    def replay(self, rows):
        """Serve the request of ``rows`` once more through the ``Pipeline``,
        recording each stage's rows and mask and each expert layer's
        choices, and holding each KDA core call against the reference's f32
        core: (its answers, per expert layer the (tokens, k) experts each
        real token ran in row order, -1 where its row had left; the largest
        core error over scale)."""
        from multi_modal_early_exit_tpu_torch.models.kimi_linear import modeling as klm
        from multi_modal_early_exit_tpu_torch.models.moonlight import modeling

        stages, chosen, errs = [], [], [0.0]
        route, layers, core = modeling.route, klm.KimiLinearStages.layers, klm.kda

        def recording_route(p, cfg, x):
            c, w = route(p, cfg, x)
            chosen.append(c.cpu())
            return c, w

        def recording_layers(stages_obj, model, state, sel, a, b, carry=None):
            stages.append((sel.cpu(), state[1][sel].cpu(), a, b))
            return layers(stages_obj, model, state, sel, a, b, carry)

        def recording_core(q, k, v, g, beta, lengths, lengths_host, chunk):
            out = core(q, k, v, g, beta, lengths, lengths_host, chunk)
            with moon_ref.full_f32():
                for r, n in enumerate(lengths_host):
                    if n:
                        want = ref.kda_core(*(t[r, :n].float() for t in (q, k, v, g, beta)),
                                            chunk)
                        errs.append(ref.core_err(out[r, :n], want))
            return out

        modeling.route, klm.KimiLinearStages.layers, klm.kda = (
            recording_route, recording_layers, recording_core)
        try:
            answers = self.pipe.predict_features(traffic.gather(self.pool, rows, KEYS))
        finally:
            modeling.route, klm.KimiLinearStages.layers, klm.kda = route, layers, core
        lengths = self.pool["attention_mask"][rows].sum(axis=1)
        starts = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)[:-1]]))
        first = self.cfg["first_k_dense_replace"]
        k = self.cfg["num_experts_per_token"]
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
        return compact(answers), routes, max(errs)

    def reference(self, rows, fp8_products: bool = False, routes=None):
        out = ref.infer(self.w, self.cfg, self.request(rows), self.mix["reference_block"],
                        fp8_products, routes)
        decisions = ref_cascade.decide(ref.max_confidence(out["logits"]), self.thresholds,
                                       self.caps, 0)
        return out, decisions

    def compared(self, served: list, label: str) -> dict:
        """The check's numbers for ``served``, one (rows, answers, routes,
        KDA core error) a request: the answers judged against the f32
        reference forced to the routes, ``route_margin`` and ``kda_err``."""
        t0 = time.perf_counter()
        answers, logits, exits, forced = [], [], [], []
        margin, unlike, pairs, kda_err = 0.0, 0, 0, 0.0
        for rows, got, routes, core_err in served:
            out, (e, f) = self.reference(rows, routes=routes)
            answers.append(got)
            logits.append(out["logits"])
            exits += e
            forced += f
            margin = max(margin, out["routes"]["margin"])
            unlike += out["routes"]["unlike"]
            pairs += out["routes"]["pairs"]
            kda_err = max(kda_err, core_err)
        answers = np.concatenate(answers)
        numbers, conf = judge(answers, torch.cat(logits, dim=1), self.thresholds,
                              len(self.thresholds))
        numbers["route_margin"] = margin
        numbers["kda_err"] = kda_err
        self.log.write(f"serve_long: {label}: {len(answers)} documents checked in "
                       f"{time.perf_counter() - t0:.1f} s; decisions unlike the reference's "
                       f"{mismatch_pct(answers, (exits, forced))} %, confidence error {conf}, "
                       f"forced expert choices the reference would not make "
                       f"{100.0 * unlike / max(pairs, 1)} % of {pairs}\n")
        return numbers

    def check(self) -> dict:
        caps = tuple(self.pipe.capacities)
        replayed, unlike = [], 0
        for rows, answers in self.sample():
            again, routes, core_err = self.replay(rows)
            unlike += int((again != answers).any(axis=1).sum())
            replayed.append((rows, answers, routes, core_err))
        self.log.write(f"serve_long: replayed answers unlike the window's: {unlike}\n")
        self.free_program()
        numbers = self.compared(replayed, "program")
        numbers["capacity_mismatch"] = float(caps != tuple(self.caps))
        return numbers

    def control(self) -> dict:
        """The same numbers for the reference in float8, routing for itself,
        in the program's place; its ``kda_err`` its float8 cores' against
        the f32 core on the same inputs."""
        played = []
        for rows, _ in self.sample():
            out8, decisions8 = self.reference(rows, True)
            played.append((rows, answers_of(out8["logits"], decisions8),
                           [c.cpu() for c in out8["chosen"]], out8["kda_err"]))
        return self.compared(played, "control")
