"""serve: ``serving.Pipeline.predict_features``, one caller in a closed
loop, back-to-back requests of one batch of documents each.

Set-up makes the pool and the weights from the seed, runs the reference
over the first ``calibration_docs`` documents (the whole pool) to point each
exit head at the directions in which documents differ (``calibrate``) and
to set each exit's threshold near the criterion quantile that gives the
traffic's exit mix, in a gap between documents, builds the port's ``EEModel`` and ``Pipeline`` from the same
weights and thresholds, and serves ``warmup_calls`` requests. After the
window, ``check`` frees the program and runs the reference over a sample of
the requests served in it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100bench import flops, port, traffic, weights
from h100bench.reference import cascade as ref_cascade
from h100bench.reference import v3 as ref

KEYS = ("input_ids", "bbox", "pixel_values", "attention_mask")


def head_prefix(out_proj: str) -> str:
    return out_proj[:-len(".out_proj")]


def thresholds_for(crit: torch.Tensor, dist: dict, window: float = 0.0) -> list:
    """Per-exit thresholds on the maximum-softmax criteria ``crit`` (E + 1,
    N): in turn, over the documents still running, the value that lets
    ``dist[j]`` of all documents leave at exit j. With ``window`` > 0 the
    threshold is the middle of the widest gap between neighbouring criteria
    within ``window`` of the documents on either side of that quantile, so
    no document lies on a threshold."""
    crit = crit.double().cpu().numpy()
    running = np.ones(crit.shape[1], bool)
    out, left = [], 1.0
    for j in range(crit.shape[0] - 1):
        share = min(dist.get(j, 0.0) / max(left, 1e-12), 1.0)
        v = np.sort(crit[j, running])[::-1]  # the highest leave
        leave = int(round(share * len(v)))
        if leave == 0:
            t = float(v[0]) + 1.0
        elif leave >= len(v):
            t = float(v[-1]) - 1.0
        else:
            span = max(1, int(window * len(v)))
            lo, hi = max(leave - span, 1), min(leave + span, len(v) - 1)
            k = lo + int(np.argmax(v[lo - 1:hi] - v[lo:hi + 1]))  # gap between v[k-1] and v[k]
            t = float(v[k - 1] + v[k]) / 2
        out.append(t)
        running &= ~(crit[j] > t)
        left -= dist.get(j, 0.0)
    return out


def compact(answers: list) -> np.ndarray:
    """(n, 4) [exit, label, confidence, capacity-exited] of a request's
    answers: one object a request, not one a document, while the window
    runs."""
    return np.array([(a["exit"], a["label_id"], a["confidence"], a["capacity_exited"])
                     for a in answers], np.float64).reshape(-1, 4)


def judge(served: np.ndarray, logits: torch.Tensor, thresholds, n_exits: int) -> dict:
    """The numbers of the check for ``served`` answers (``compact`` rows)
    against the reference ``logits`` (E + 1, N, K):

    - ``exit_err``: the widest margin by which a served exit decision
      contradicts the reference's criteria: an exit passed although the
      reference's criterion cleared its threshold by that much, or left
      although the reference's (or the answer's own confidence, the
      criterion the program read) fell short of it by that much; 0 when
      every decision agrees;
    - ``label_gap``: the widest gap by which the served label's reference
      logit lies below the reference's best at the served exit.

    The served confidence's error against the reference's softmax is
    logged, not compared: its sound and control readings lie too close."""
    logits = logits.double().cpu()
    probs = torch.softmax(logits, dim=-1)
    crit = probs.amax(dim=-1)
    exit_err, gap, conf = 0.0, 0.0, 0.0
    for i, (e, lab, c, forced) in enumerate(served):
        e, lab, forced = int(e), int(lab), bool(forced)
        for j in range(min(e + forced, n_exits)):  # a capacity-exited answer went on at e
            exit_err = max(exit_err, float(crit[j, i]) - thresholds[j])
        if e < n_exits and not forced:
            exit_err = max(exit_err, thresholds[e] - float(crit[e, i]), thresholds[e] - c)
        gap = max(gap, float(logits[e, i].max() - logits[e, i, lab]))
        conf = max(conf, abs(c - float(probs[e, i, lab])))
    return {"exit_err": exit_err, "label_gap": gap}, conf


def mismatch_pct(served: np.ndarray, decisions) -> float:
    """The share of answers whose exit or capacity flag differs from the
    reference cascade's (logged: rounding moves documents that lie near a
    threshold, so it is no number with a limit)."""
    exits, forced = decisions
    bad = sum((int(r[0]), bool(r[3])) != (e, f) for r, e, f in zip(served, exits, forced))
    return 100.0 * bad / len(served)


def answers_of(logits: torch.Tensor, decisions) -> np.ndarray:
    """What a server that computed ``logits`` and ``decisions`` would
    answer (the control: the reference in the program's place)."""
    exits, forced = decisions
    probs = torch.softmax(logits.double().cpu(), dim=-1)
    rows = []
    for i, (e, f) in enumerate(zip(exits, forced)):
        lab = int(probs[e, i].argmax())
        rows.append((e, lab, float(probs[e, i, lab]), f))
    return np.array(rows, np.float64)


class Entry:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, log):
        self.cfg, self.mix, self.seed, self.device, self.log = cfg, mix, seed, device, log
        self.batch = mix["batch"]
        self.dist = {int(k): v for k, v in mix["exit_distribution"].items()}
        order = flops.exit_order(cfg)
        self.n_emb = sum(1 for e in order if isinstance(e, str))
        n_stages = len(order) - self.n_emb + 1
        self.caps = ref_cascade.capacities(self.dist, self.batch, self.n_emb, n_stages,
                                           mix["capacity_tail"])
        t0 = time.perf_counter()
        self.pool = traffic.make_pool(seed, cfg, mix, device)
        self.dtype = port.DTYPES[cfg["serve_dtype"]]
        w = weights.make(cfg, seed, device, self.dtype)
        self.w32 = {n: t.float() for n, t in w.items()}
        self.heads = self.calibrate(w)
        model = port.ee_model(cfg, w, device, self.dtype)
        del w
        self.w32 = None  # the reference's weights are made again after the window
        from multi_modal_early_exit_tpu_torch.serving import Pipeline

        self.pipe = Pipeline(model, port.ee_config(cfg), threshold=self.thresholds,
                             batch_size=self.batch, exit_distribution=self.dist,
                             tokenizer=object(),  # predict_features tokenizes nothing
                             capacity_tail=mix["capacity_tail"], device=device)
        self.batches = traffic.Batches(seed, mix["pool"], self.batch)
        self.calls = []  # (rows, answers) of every request in the window
        log.write(f"serve: set-up {time.perf_counter() - t0:.2f} s (pool, weights, calibration, "
                  f"program); capacities {self.pipe.capacities} (reference {self.caps}), "
                  f"thresholds {[round(t, 5) for t in self.thresholds]}\n")

    def calibrate(self, w: dict) -> dict:
        """Give each head's output projection the directions in which the
        calibration documents differ most, and set the thresholds from the
        reference's criteria. Random heads read random directions, in which
        the documents' states hardly differ, so the rounding of a bf16
        program would decide most exits; a trained head reads the directions
        that tell documents apart. Logit k becomes the k-th principal
        component of the head's input to its projection, centred and scaled
        to unit variance over the calibration documents. Writes the new
        projections into ``w`` (the serving type) and ``self.w32`` (the
        same values in f32) and returns them in f32."""
        n = self.mix["calibration_docs"]
        out = ref.infer(self.w32, self.cfg, self.request(np.arange(n)), self.mix["reference_block"])
        names = weights.head_names(self.cfg)
        k = self.cfg["num_labels"]
        with torch.no_grad(), ref.full_f32():
            model = ref.Model(self.w32, self.cfg)
            for name, x in zip(names, out["exit_inputs"]):
                dense = f"{head_prefix(name)}.dense"
                z = torch.tanh(model.lin(x, dense)) if f"{dense}.weight" in self.w32 else x
                mean = z.mean(dim=0)
                _, sv, vh = torch.linalg.svd(z - mean, full_matrices=False)
                proj = vh[:k] / (sv[:k, None] / (n - 1) ** 0.5)
                wt, b = f"{name}.weight", f"{name}.bias"
                w[wt].copy_(proj.to(self.dtype))
                w[b].copy_((-(proj @ mean)).to(self.dtype))
                self.w32[wt], self.w32[b] = w[wt].float(), w[b].float()
            logits = torch.stack([model.head(x, head_prefix(name), None)
                                  for x, name in zip(out["exit_inputs"], names)])
        self.thresholds = thresholds_for(ref.max_confidence(logits), self.dist,
                                         self.mix["threshold_window"])
        return {n: self.w32[n] for name in names for n in (f"{name}.weight", f"{name}.bias")}

    def request(self, rows) -> dict:
        """The pool's ``rows`` as tensors on the device: the reference's
        input (the program gets host arrays and the pages, ``serve_one``)."""
        return {k: (v if torch.is_tensor(v) else torch.from_numpy(v).to(self.device))
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
        lat, exits, failed = [], np.zeros(len(flops.exit_order(self.cfg)) + 1, np.int64), 0
        start = time.perf_counter()
        while True:
            rows, answers, dt = self.serve_one()
            lat.append(dt)
            served = compact(answers)
            self.calls.append((rows, served))
            failed += len(served) != self.batch
            exits += np.bincount(served[:, 0].astype(np.int64), minlength=len(exits))
            if time.perf_counter() - start >= seconds:
                break
        elapsed = time.perf_counter() - start
        model_flops = sum(int(c) * flops.doc_flops_to_exit(self.cfg, e) for e, c in enumerate(exits))
        return {"docs": len(self.calls) * self.batch, "seconds": elapsed, "latencies": lat,
                "attempted": len(self.calls), "failed": failed, "model_flops": model_flops,
                "exit_counts": exits.tolist()}

    def slice(self, n: int) -> int:
        for _ in range(n):
            self.serve_one()
        return n

    def attention_calls(self, units: int) -> list:
        """(b, heads, s, d) of every #2 call the program makes in ``units``
        batches: each encoder stage runs its layers at its capacity, at the
        sequence padded to 128."""
        cfg = self.cfg
        s = flops.padded(flops.seq_len(cfg))
        heads = cfg["num_attention_heads"]
        d = cfg["hidden_size"] // heads
        ends = flops.encoder_exit_layers(cfg) + [cfg["num_hidden_layers"]]
        calls, start = [], 0
        for cap, end in zip(self.caps, ends):
            calls += [(cap, heads, s, d)] * (end - start)
            start = end
        return calls * units

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

    def reference_weights(self) -> dict:
        """The served weights in f32, made again from the seed with the
        calibrated heads."""
        if self.w32 is None:
            w = weights.make(self.cfg, self.seed, self.device, self.dtype)
            self.w32 = {n: t.float() for n, t in w.items()} | self.heads
        return self.w32

    def reference(self, rows, fp8_products: bool = False):
        out = ref.infer(self.reference_weights(), self.cfg, self.request(rows), self.mix["reference_block"],
                        fp8_products)
        decisions = ref_cascade.decide(ref.max_confidence(out["logits"]), self.thresholds,
                                       self.caps, self.n_emb)
        return out["logits"], decisions

    def compared(self, control: bool = False) -> dict:
        """The check's numbers for the sampled requests: of the program's
        answers, or with ``control`` of the reference's in float8."""
        t0 = time.perf_counter()
        served, logits, exits, forced = [], [], [], []
        for rows, answers in self.sample():
            lg, (e, f) = self.reference(rows)
            served.append(answers_of(*self.reference(rows, True)) if control else answers)
            logits.append(lg)
            exits += e
            forced += f
        served = np.concatenate(served)
        numbers, conf = judge(served, torch.cat(logits, dim=1), self.thresholds, len(self.thresholds))
        self.log.write(f"serve: {len(served)} documents checked in {time.perf_counter() - t0:.1f} s; "
                       f"decisions unlike the reference's {mismatch_pct(served, (exits, forced))} %, "
                       f"confidence error {conf}\n")
        return numbers

    def check(self) -> dict:
        """{number: value} over the sampled requests, after freeing the
        program; ``capacity_mismatch`` compares the program's capacities
        with the reference's."""
        caps = tuple(self.pipe.capacities)
        self.free_program()
        numbers = self.compared()
        numbers["capacity_mismatch"] = float(caps != tuple(self.caps))
        return numbers

    def control(self) -> dict:
        """The same numbers for the reference in float8 put in the program's
        place, on the same sampled requests."""
        return self.compared(control=True)
