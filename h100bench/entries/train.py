"""train: ``training.trainer.EETrainer.train_step``, one step after another
over batches that cycle the pool.

Set-up makes the pool and the f32 master weights from the seed, builds the
port's ``EEModel`` and ``EETrainer`` from them, and drives the trainer
through its first ``checked_steps`` steps, on rows that all differ, with a
dropout generator from the seed. From those steps it keeps each loss, each
leaf's first gradient as AdamW holds it after step 1 (the first moment over
1 - b1) and each leaf's change after the last of them. The window then goes
on training the same object. After the window, ``check`` frees the program
and runs the reference through the same steps from the same weights, rows
and dropout seeds.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from h100bench import flops, port, traffic, weights
from h100bench.reference import train as ref_train

KEYS = ("input_ids", "bbox", "pixel_values", "attention_mask", "labels")
BETA1 = 0.9


def draws_per_step(cfg: dict) -> int:
    """Dropout seeds one training forward draws: the text embeddings, the
    concatenated sequence, three a layer, two for each two-layer head (one
    for a one-layer head) and two for the classifier."""
    per_head = 2 if cfg["exit_head_num_layers"] == 2 else 1
    return 2 + 3 * cfg["num_hidden_layers"] + per_head * len(flops.exit_order(cfg)) + 2


def step_seeds(seed: int, cfg: dict, steps: int) -> list:
    """The dropout seeds the program's generator hands out, step by step."""
    gen = torch.Generator().manual_seed(seed)
    return [[int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
             for _ in range(draws_per_step(cfg))] for _ in range(steps)]


def norms(tensors: dict) -> dict:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def leaf_gaps(got: dict, want: dict, names=None) -> dict:
    """Each leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = list(want) if names is None else names
    med = statistics.median(want[n] for n in want)
    return {n: abs(got[n] - want[n]) / max(want[n], med) for n in names}


def worst(gaps: dict, k: int = 3) -> list:
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:k]


def compare(losses, g1, change, ref_losses, ref_g1, ref_change, log=None) -> dict:
    """The check's numbers: the worst step's relative loss gap, the first
    gradient's worst leaf, and the change's worst leaf among the leaves
    whose reference gradient is over a thousandth of the median leaf's
    (a key bias, whose gradient is nought under the softmax, moves by
    round-off alone)."""
    med = statistics.median(ref_g1.values())
    moved = [n for n in ref_g1 if ref_g1[n] > 1e-3 * med]
    grad, step = leaf_gaps(g1, ref_g1), leaf_gaps(change, ref_change, moved)
    if log:
        log.write(f"train: losses {losses} against {ref_losses}; worst first gradients "
                  f"{worst(grad)}; worst changes {worst(step)}; left out of the change "
                  f"{sorted(set(ref_g1) - set(moved))}\n")
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
        "grad_gap": max(grad.values()),
        "change_gap": max(step.values()),
    }


class Entry:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, log):
        from multi_modal_early_exit_tpu_torch.training.trainer import EETrainer, TrainingArguments

        self.cfg, self.mix, self.seed, self.device, self.log = cfg, mix, seed, device, log
        t0 = time.perf_counter()
        self.batch = mix["batch"]
        self.pool = traffic.make_pool(seed, cfg, mix, device)
        self.batches = traffic.Batches(seed, mix["pool"], self.batch)
        self.dropout_seed = seed ^ 0xD20
        w0 = weights.make(cfg, seed, device, torch.float32)
        model = port.ee_model(cfg, w0, device, torch.float32)
        args = TrainingArguments(learning_rate=mix["learning_rate"],
                                 bf16=cfg["train_compute_dtype"] == "bfloat16")
        self.trainer = EETrainer(port.ee_config(cfg), model, args, mix["total_steps"],
                                 device=device)
        self.rng = torch.Generator().manual_seed(self.dropout_seed)
        t1 = time.perf_counter()
        self.checked_rows, self.losses, self.want = [], [], None
        params = self.trainer.optimizer.params
        for k in range(mix["checked_steps"]):
            rows = self.batches.next()
            self.checked_rows.append(rows)
            self.losses.append(self.trainer.train_step(self.step_batch(rows), self.rng)[0])
            if k == 0:
                # a leaf the optimizer holds no moment for got no gradient
                state = self.trainer.optimizer.adamw.state
                self.g1 = norms({n: state[p]["exp_avg"] / (1 - BETA1) if "exp_avg" in state[p]
                                 else torch.zeros(()) for n, p in params.items()})
        self.change = norms({n: p.detach() - w0[n] for n, p in params.items()})
        del w0
        log.write(f"train: set-up {t1 - t0:.2f} s (pool, weights, trainer), checked steps "
                  f"{time.perf_counter() - t1:.2f} s, losses {self.losses}\n")

    def step_batch(self, rows) -> dict:
        """One step's batch, (accumulation 1, rows, ...)."""
        return {k: v[None] for k, v in traffic.gather(self.pool, rows, KEYS).items()}

    def warm(self) -> None:
        """The checked steps have run every shape of a step."""

    def train_one(self) -> float:
        return self.trainer.train_step(self.step_batch(self.batches.next()), self.rng)[0]

    def window(self, seconds: float) -> dict:
        steps, failed = 0, 0
        start = time.perf_counter()
        while True:
            failed += not math.isfinite(self.train_one())
            steps += 1
            if time.perf_counter() - start >= seconds:
                break
        elapsed = time.perf_counter() - start
        return {"docs": steps * self.batch, "seconds": elapsed, "attempted": steps,
                "failed": failed, "model_flops": steps * self.batch * flops.train_doc_flops(self.cfg)}

    def slice(self, n: int) -> int:
        for _ in range(n):
            self.train_one()
        return n

    def attention_calls(self, units: int) -> list:
        """(b, heads, s, d) of every training attention call in ``units``
        steps: each layer once a step, at the sequence padded to 128."""
        cfg = self.cfg
        heads = cfg["num_attention_heads"]
        call = (self.batch, heads, flops.padded(flops.seq_len(cfg)), cfg["hidden_size"] // heads)
        return [call] * (cfg["num_hidden_layers"] * units)

    def free_program(self) -> None:
        del self.trainer
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference(self, fp8_products: bool = False, rows=None):
        """(losses, first gradients' norms, changes' norms) of the reference
        over the checked steps; ``rows`` (a bool mask over a batch's rows)
        takes the mean over those rows only."""
        cfg, mix = self.cfg, self.mix
        w = weights.make(cfg, self.seed, self.device, torch.float32)
        w0 = {n: t.clone() for n, t in w.items()}
        batches = [{k: (v if torch.is_tensor(v) else torch.from_numpy(v).to(self.device))
                    for k, v in traffic.gather(self.pool, r, KEYS).items()}
                   for r in self.checked_rows]
        seeds = step_seeds(self.dropout_seed, cfg, len(batches))
        losses, first, _ = ref_train.run_steps(
            w, cfg, batches, seeds, mix["learning_rate"], mix["total_steps"],
            flops.padded(flops.seq_len(cfg)), mix["reference_block"], fp8_products, rows)
        return losses, norms(first), norms({n: w[n] - w0[n] for n in w})

    def check(self) -> dict:
        self.free_program()
        return compare(self.losses, self.g1, self.change, *self.wanted(), log=self.log)

    def wanted(self):
        """The reference's readings, made once."""
        if self.want is None:
            t0 = time.perf_counter()
            self.want = self.reference()
            self.log.write(f"train: the reference took {time.perf_counter() - t0:.1f} s\n")
        return self.want

    def control(self) -> dict:
        return compare(*self.reference(fp8_products=True), *self.wanted(), log=self.log)

    def half_batch(self) -> dict:
        """A planted fault: the reference's mean taken over half the batch."""
        rows = torch.arange(self.batch) < self.batch // 2
        return compare(*self.reference(rows=rows), *self.wanted(), log=self.log)
