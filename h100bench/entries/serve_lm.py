"""serve_lm: ``serving.Pipeline.predict_features`` over OCR text alone, for a
text-only backbone (early-exit Moonlight), one caller in a closed loop,
back-to-back requests of one batch of documents each.

A document is its token ids, right-padded to ``seq_len``, and its attention
mask: lengths log-uniform on ``lengths`` (1-3 OCR'd pages), ids uniform over
the vocabulary, all from the seed. Set-up makes the pool and the weights
(``h100bench.moonlight``), builds the port's ``EEModel`` on them, runs it
over the first ``calibration_docs`` documents (the whole pool: principal
directions of fewer documents than the 2048 dimensions do not carry over
to the others) to point each head at the directions in which documents
differ and to set the thresholds (as ``entries/serve.py`` does with the
reference), builds the ``Pipeline`` and serves ``warmup_calls`` requests.

After the window ``check`` serves each of ``check_calls`` sampled requests
once more through the same ``Pipeline`` (the program is deterministic: the
replay's answers are the window's, which is logged), recording each stage's
rows and every expert layer's choices; it then frees the program and runs
the reference with those choices forced (``reference/moonlight.py``: with
random weights near-tied experts flip under any rounding, and the states
would drift apart whatever the arithmetic's quality), and judges the
window's answers against it. ``route_margin`` is the largest shortfall of a
forced expert's corrected score below the reference's own k-th best. The
control puts the reference in float8, routing for itself, in the program's
place, and is judged the same way against the f32 reference forced to its
choices.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100bench import moonlight, port, traffic
from h100bench.entries.serve import answers_of, compact, judge, mismatch_pct, thresholds_for
from h100bench.reference import cascade as ref_cascade
from h100bench.reference import moonlight as ref

KEYS = ("input_ids", "attention_mask")


def make_pool(seed: int, cfg: dict, mix: dict) -> dict:
    """(pool, seq_len) int32 ids and mask on the host: lengths log-uniform
    on ``mix['lengths']``, ids uniform over the vocabulary."""
    rng = np.random.default_rng([seed, 1])
    n, s = mix["pool"], mix["seq_len"]
    lo, hi = mix["lengths"]
    lengths = np.exp(rng.uniform(np.log(lo), np.log(hi), n)).round().astype(np.int64)
    ids = rng.integers(0, cfg["vocab_size"], (n, s)).astype(np.int32)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return {"input_ids": ids * mask, "attention_mask": mask}


class Entry:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, log):
        from multi_modal_early_exit_tpu_torch.serving import Pipeline
        from multi_modal_early_exit_tpu_torch.utils import profiling

        self.cfg, self.mix, self.seed, self.device, self.log = cfg, mix, seed, device, log
        self.batch = mix["batch"]
        self.dist = {int(k): v for k, v in mix["exit_distribution"].items()}
        n_exits = len(moonlight.encoder_exits(cfg))
        self.caps = ref_cascade.capacities(self.dist, self.batch, 0, n_exits + 1,
                                           mix["capacity_tail"])
        t0 = time.perf_counter()
        self.pool = make_pool(seed, cfg, mix)
        lengths = self.pool["attention_mask"].sum(axis=1)
        self.doc_flops = np.array([[moonlight.doc_flops_to_exit(cfg, e, int(n))
                                    for e in range(n_exits + 1)] for n in lengths])
        self.dtype = port.DTYPES[cfg["serve_dtype"]]
        # one copy of the weights: the program's parameters and the reference's
        self.w = moonlight.make(cfg, seed, device, self.dtype)
        # a program without the Moonlight model raises here, seconds in
        model = moonlight.port_model(cfg, self.w, device)
        self.calibrate(model)
        # the counters read the served batches alone, not the calibration's
        profiling.counters(reset=True)
        self.pipe = Pipeline(model, moonlight.port_config(cfg), threshold=self.thresholds,
                             batch_size=self.batch, exit_distribution=self.dist,
                             tokenizer=object(),  # predict_features tokenizes nothing
                             capacity_tail=mix["capacity_tail"], device=device)
        self.batches = traffic.Batches(seed, mix["pool"], self.batch)
        self.calls = []  # (rows, answers) of every request in the window
        log.write(f"serve_lm: set-up {time.perf_counter() - t0:.2f} s (pool, weights, "
                  f"program, calibration); capacities {self.pipe.capacities} (reference "
                  f"{self.caps}), thresholds {[round(t, 5) for t in self.thresholds]}\n")

    def calibrate(self, model) -> None:
        """Each head's output projection becomes the first ``num_labels``
        principal directions of its hidden layer (tanh(dense(norm x))) over
        the calibration documents, centred and scaled to unit variance
        (``entries/serve.py::Entry.calibrate``'s reason), written into the
        shared weights in the serving type; the thresholds are set from the
        criteria with those heads. The heads' inputs are the program's own
        last-token states (its batched forward, ``batch`` rows a call); the
        heads are computed in f32."""
        from multi_modal_early_exit_tpu_torch.models.moonlight.modeling import last_token_states

        n, bb_cfg = self.mix["calibration_docs"], moonlight.port_config(self.cfg).backbone
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
        ref_model = ref.Model(self.w, self.cfg)
        logits = []
        with torch.no_grad(), ref.full_f32():
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
        self.thresholds = thresholds_for(ref.max_confidence(torch.stack(logits)), self.dist,
                                         self.mix["threshold_window"])

    def request(self, rows) -> dict:
        """The pool's ``rows`` as tensors on the device: the reference's input."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in traffic.gather(self.pool, rows, KEYS).items()}

    def serve_one(self):
        rows = self.batches.next()
        req = traffic.gather(self.pool, rows, KEYS)
        t0 = time.perf_counter()
        answers = self.pipe.predict_features(req)
        return rows, answers, time.perf_counter() - t0

    def warm(self) -> None:
        for _ in range(self.mix["warmup_calls"]):
            self.serve_one()

    def window(self, seconds: float) -> dict:
        lat, failed = [], 0
        start = time.perf_counter()
        while True:
            rows, answers, dt = self.serve_one()
            lat.append(dt)
            served = compact(answers)
            self.calls.append((rows, served))
            failed += len(served) != self.batch
            if time.perf_counter() - start >= seconds:
                break
        elapsed = time.perf_counter() - start
        exits = np.concatenate([s[:, 0] for _, s in self.calls]).astype(np.int64)
        rows = np.concatenate([r for r, _ in self.calls])
        return {"docs": len(self.calls) * self.batch, "seconds": elapsed, "latencies": lat,
                "attempted": len(self.calls), "failed": failed,
                "model_flops": float(self.doc_flops[rows, exits].sum()),
                "exit_counts": np.bincount(exits, minlength=self.doc_flops.shape[1]).tolist()}

    def slice(self, n: int) -> int:
        for _ in range(n):
            self.serve_one()
        return n

    def attention_calls(self, units: int) -> list:
        """(rows, positions) of every causal attention call the program
        makes in ``units`` batches: each stage runs its layers at its
        capacity over the padded sequence."""
        ends = moonlight.encoder_exits(self.cfg) + [self.cfg["num_hidden_layers"]]
        calls, start = [], 0
        for cap, end in zip(self.caps, ends):
            calls += [(cap, self.mix["seq_len"])] * (end - start)
            start = end
        return calls * units

    def replay(self, rows):
        """Serve the request of ``rows`` once more through the ``Pipeline``,
        recording each stage's rows and mask and each expert layer's
        choices: (its answers, per expert layer the (tokens, k) experts
        each real token of the request ran, in row order; -1 where a token's
        row had left before that layer)."""
        from multi_modal_early_exit_tpu_torch.models.moonlight import modeling

        stages, chosen = [], []
        route, layers = modeling.route, modeling.CascadeStages.layers

        def recording_route(p, cfg, x):
            c, w = route(p, cfg, x)
            chosen.append(c.cpu())
            return c, w

        def recording_layers(stages_obj, model, state, sel, a, b, rope):
            stages.append((sel.cpu(), state[1][sel].cpu(), a, b))
            return layers(stages_obj, model, state, sel, a, b, rope)

        modeling.route, modeling.CascadeStages.layers = recording_route, recording_layers
        try:
            answers = self.pipe.predict_features(traffic.gather(self.pool, rows, KEYS))
        finally:
            modeling.route, modeling.CascadeStages.layers = route, layers
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
        return compact(answers), routes

    def free_program(self) -> None:
        del self.pipe
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def sample(self) -> list:
        """The requests the check compares: ``check_calls`` of the window's,
        drawn from the seed."""
        rng = np.random.default_rng([self.seed, 3])
        k = min(self.mix["check_calls"], len(self.calls))
        return [self.calls[i] for i in sorted(rng.choice(len(self.calls), k, replace=False))]

    def reference(self, rows, fp8_products: bool = False, routes=None):
        out = ref.infer(self.w, self.cfg, self.request(rows), self.mix["reference_block"],
                        fp8_products, routes)
        decisions = ref_cascade.decide(ref.max_confidence(out["logits"]), self.thresholds,
                                       self.caps, 0)
        return out, decisions

    def compared(self, served_routes: list, label: str) -> dict:
        """The check's numbers for ``served_routes``, one (rows, answers,
        routes) a request: the answers judged against the f32 reference
        forced to the routes, and ``route_margin``."""
        t0 = time.perf_counter()
        served, logits, exits, forced = [], [], [], []
        margin, unlike, pairs = 0.0, 0, 0
        for rows, answers, routes in served_routes:
            out, (e, f) = self.reference(rows, routes=routes)
            served.append(answers)
            logits.append(out["logits"])
            exits += e
            forced += f
            margin = max(margin, out["routes"]["margin"])
            unlike += out["routes"]["unlike"]
            pairs += out["routes"]["pairs"]
        served = np.concatenate(served)
        numbers, conf = judge(served, torch.cat(logits, dim=1), self.thresholds,
                              len(self.thresholds))
        numbers["route_margin"] = margin
        self.log.write(f"serve_lm: {label}: {len(served)} documents checked in "
                       f"{time.perf_counter() - t0:.1f} s; decisions unlike the reference's "
                       f"{mismatch_pct(served, (exits, forced))} %, confidence error {conf}, "
                       f"forced expert choices the reference would not make "
                       f"{100.0 * unlike / max(pairs, 1)} % of {pairs}\n")
        return numbers

    def check(self) -> dict:
        """{number: value} over the sampled requests, after freeing the
        program; ``capacity_mismatch`` compares the program's capacities
        with the reference's."""
        caps = tuple(self.pipe.capacities)
        replayed, unlike = [], 0
        for rows, answers in self.sample():
            again, routes = self.replay(rows)
            unlike += int((again != answers).any(axis=1).sum())
            replayed.append((rows, answers, routes))
        self.log.write(f"serve_lm: replayed answers unlike the window's: {unlike}\n")
        self.free_program()
        numbers = self.compared(replayed, "program")
        numbers["capacity_mismatch"] = float(caps != tuple(self.caps))
        return numbers

    def control(self) -> dict:
        """The same numbers for the reference in float8, routing for itself,
        put in the program's place on the same sampled requests."""
        played = []
        for rows, _ in self.sample():
            out8, decisions8 = self.reference(rows, True)
            played.append((rows, answers_of(out8["logits"], decisions8),
                           [c.cpu() for c in out8["chosen"]]))
        return self.compared(played, "control")
