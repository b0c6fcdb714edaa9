"""harvest: ``evaluation.pipeline.get_logits`` of a dense LayoutLMv2 over an
in-memory split, as ``cli.evaluate`` harvests a logit store, call after
call with no cache.

Set-up makes the split (f32 pages on the host, as the path loads them) and
the weights from the seed, builds the port's ``LayoutLMv2Model`` and
harvests once. After the window, ``check`` frees the program and runs the
reference over the split, against the store of one call drawn from the
seed.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from h100bench import flops, port, traffic, weights
from h100bench.reference import v2 as ref

KEYS = ("input_ids", "bbox", "pixel_values", "attention_mask", "labels")


def store_err(store: np.ndarray, want: torch.Tensor) -> float:
    """The largest error of a (1, N, K) store against the reference's, over
    the reference's largest logit; a store short of documents is compared
    on those it has (the run counts it as failed)."""
    want = want.double().cpu().numpy()
    n = min(store.shape[1], want.shape[1])
    return float(np.abs(store[:, :n] - want[:, :n]).max() / np.abs(want).max())


class Entry:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, log):
        from multi_modal_early_exit_tpu_torch.data.datasets import DocClassificationDataset
        from multi_modal_early_exit_tpu_torch.models.layoutlmv2.config import LayoutLMv2Config
        from multi_modal_early_exit_tpu_torch.models.layoutlmv2.modeling import LayoutLMv2Model

        self.cfg, self.mix, self.seed, self.device, self.log = cfg, mix, seed, device, log
        t0 = time.perf_counter()
        self.batch = mix["batch"]
        pool = traffic.make_pool(seed, cfg, mix, device)
        arrays = {k: (v.cpu().numpy() if torch.is_tensor(v) else v.astype(np.int32)) for k, v in pool.items()}
        self.dataset = DocClassificationDataset("h100bench", "test", arrays,
                                                {i: str(i) for i in range(cfg["num_labels"])})
        fields = {f.name for f in dataclasses.fields(LayoutLMv2Config)}
        self.v2cfg = LayoutLMv2Config(**{k: tuple(v) if isinstance(v, list) else v
                                         for k, v in cfg.items() if k in fields})
        self.dtype = port.DTYPES[cfg["serve_dtype"]]
        w = weights.make(cfg, seed, device, self.dtype)
        self.model = LayoutLMv2Model(self.v2cfg, device=device).to(self.dtype)
        self.model.load_state_dict(w, strict=True)
        del w, pool
        self.stores = []
        log.write(f"harvest: set-up {time.perf_counter() - t0:.2f} s (split, weights, program)\n")

    def harvest(self) -> np.ndarray:
        from multi_modal_early_exit_tpu_torch.evaluation.pipeline import get_logits

        store, _, _ = get_logits(self.model, self.v2cfg, self.dataset, {}, batch_size=self.batch,
                                 use_cache=False, device=self.device)
        return store

    def warm(self) -> None:
        for _ in range(self.mix["warmup_calls"]):
            self.harvest()

    def window(self, seconds: float) -> dict:
        failed = 0
        start = time.perf_counter()
        while True:
            store = self.harvest()
            self.stores.append(store)
            failed += store.shape[1] != len(self.dataset) or not np.isfinite(store).all()
            if time.perf_counter() - start >= seconds:
                break
        elapsed = time.perf_counter() - start
        docs = len(self.stores) * len(self.dataset)
        return {"docs": docs, "seconds": elapsed, "attempted": len(self.stores), "failed": failed,
                "model_flops": docs * flops.v2_doc_flops(self.cfg)}

    def slice(self, n: int) -> int:
        """At least ``n`` batches, in whole harvests; returns the batches."""
        per_call = -(-len(self.dataset) // self.batch)
        calls = -(-n // per_call)
        for _ in range(calls):
            self.harvest()
        return calls * per_call

    def attention_calls(self, units: int) -> list:
        cfg = self.cfg
        heads = cfg["num_attention_heads"]
        call = (self.batch, heads, flops.padded(flops.v2_seq_len(cfg)), cfg["hidden_size"] // heads)
        return [call] * (cfg["num_hidden_layers"] * units)

    def free_program(self) -> None:
        del self.model
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference(self, fp8_products: bool = False) -> torch.Tensor:
        w = {n: t.float() for n, t in weights.make(self.cfg, self.seed, self.device, self.dtype).items()}
        batch = {k: torch.from_numpy(v).to(self.device) for k, v in self.dataset.arrays.items()}
        return ref.infer(w, self.cfg, batch, self.mix["reference_block"], fp8_products)

    def sampled_store(self) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 3])
        return self.stores[int(rng.integers(len(self.stores)))]

    def check(self) -> dict:
        self.free_program()
        t0 = time.perf_counter()
        self.want = self.reference()
        numbers = {"store_err": store_err(self.sampled_store(), self.want)}
        self.log.write(f"harvest: the reference took {time.perf_counter() - t0:.1f} s\n")
        return numbers

    def control(self) -> dict:
        if not hasattr(self, "want"):
            self.want = self.reference()
        got = self.reference(fp8_products=True).double().cpu().numpy()
        return {"store_err": store_err(got, self.want)}
