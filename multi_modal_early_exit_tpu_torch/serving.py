"""End-to-end serving pipeline: raw document -> label + confidence + exit.

One object owns preprocessing (tokenization + batched image pipeline on the
device), the capacity-constrained cascade, and postprocessing:

    pipe = Pipeline(model, cfg)                  # on cuda by default
    results = pipe.predict(images=[pil_image], words=[["inv", "total"]],
                           boxes=[[[10, 10, 40, 30], [50, 10, 90, 30]]])
    results[0] -> {"label": "invoice", "confidence": 0.93, "exit": 2,
                   "exit_name": "7", "capacity_exited": False}

Batches are padded to the pipeline's static batch size (by repeating rows)
so every cascade call has the same shapes. Words and boxes come with the
request (OCR ingestion is not ported yet).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from multi_modal_early_exit_tpu_torch.data.features import (
    MAX_SEQ_LENGTH,
    convert_words_to_features,
    load_tokenizer,
)
from multi_modal_early_exit_tpu_torch.data.images import preprocess_pil_batch
from multi_modal_early_exit_tpu_torch.data.labels import RVL_CDIP_ID2LABEL
from multi_modal_early_exit_tpu_torch.device import resolve_device
from multi_modal_early_exit_tpu_torch.models.ee.cascade import (
    capacities_from_distribution,
    make_cascade_forward,
)
from multi_modal_early_exit_tpu_torch.models.ee.model import EEModel, canonical_exit_order
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import EEModelConfig


class Pipeline:
    """Anytime document classification with a fixed serving batch size."""

    def __init__(
        self,
        model: EEModel,
        cfg: EEModelConfig,
        id2label: Optional[Dict[int, str]] = None,
        # one global threshold, or a per-exit vector (length = num exits)
        threshold=None,
        batch_size: int = 16,
        exit_distribution: Optional[Dict[int, float]] = None,
        tokenizer=None,
        seq_len: Optional[int] = None,
        capacity_tail: float = 0.995,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.id2label = id2label or dict(RVL_CDIP_ID2LABEL)
        self.batch_size = batch_size
        self.tokenizer = tokenizer or load_tokenizer(
            vocab_size=cfg.backbone.vocab_size
        )
        self.seq_len = seq_len or min(
            MAX_SEQ_LENGTH, cfg.backbone.max_position_embeddings - 2
        )
        self.order = canonical_exit_order(cfg.exit)

        n_emb = sum(1 for e in self.order if isinstance(e, str))
        n_stages = len([e for e in self.order if isinstance(e, int)]) + 1
        if exit_distribution:
            # binomial-tail sizing (no-overflow probability = capacity_tail
            # per batch under i.i.d. exits); watch
            # ``metrics()['capacity_exit_rate']`` for drift
            caps = capacities_from_distribution(
                exit_distribution, batch_size, n_emb, n_stages,
                tail=capacity_tail,
            )
        else:
            caps = tuple([batch_size] * n_stages)  # conservative: exact policy
        self.capacities = caps
        self.capacity_tail = capacity_tail
        self._n_served = 0
        self._n_capacity_exited = 0
        self._cascade = make_cascade_forward(cfg, capacities=caps, threshold=threshold)

    def preprocess(
        self,
        images: Sequence,
        words: Optional[Sequence[Sequence[str]]] = None,
        boxes: Optional[Sequence[Sequence[Sequence[int]]]] = None,
    ) -> Dict[str, object]:
        """Host features (numpy) plus normalized ``pixel_values`` on the device."""
        if words is None or boxes is None:
            raise ValueError(
                "words and boxes are required: OCR ingestion is not part of "
                "the PyTorch port yet"
            )
        feats = [
            convert_words_to_features(w, b, self.tokenizer, self.seq_len)
            for w, b in zip(words, boxes)
        ]
        return {
            "input_ids": np.stack([f["input_ids"] for f in feats]),
            "bbox": np.stack([f["bbox"] for f in feats]),
            "attention_mask": np.stack([f["attention_mask"] for f in feats]),
            "pixel_values": preprocess_pil_batch(
                images, size=self.cfg.backbone.input_size, device=self.device
            ),
        }

    def predict(
        self,
        images: Sequence,
        words: Optional[Sequence[Sequence[str]]] = None,
        boxes: Optional[Sequence[Sequence[Sequence[int]]]] = None,
    ) -> List[Dict]:
        return self.predict_features(self.preprocess(images, words, boxes))

    def predict_features(self, batch: Dict[str, object]) -> List[Dict]:
        """Run preprocessed features (numpy arrays or tensors) through the
        cascade; pads to the static batch size and chunks larger inputs."""
        tensors = {
            k: (v if torch.is_tensor(v) else torch.from_numpy(np.array(v))).to(self.device)
            for k, v in batch.items()
        }
        n = len(tensors["input_ids"])
        results: List[Dict] = []
        for start in range(0, n, self.batch_size):
            idx = np.arange(start, min(start + self.batch_size, n))
            real = len(idx)
            if real < self.batch_size:
                # pad a short batch by repeating its rows
                idx = np.concatenate([idx, np.resize(idx, self.batch_size - real)])
            rows = torch.as_tensor(idx, device=self.device)
            chunk = {k: v[rows] for k, v in tensors.items()}
            res = self._cascade(
                self.model, chunk["input_ids"], chunk["bbox"],
                chunk["pixel_values"], chunk["attention_mask"],
            )
            logits = res.logits[:real].cpu()
            exits = res.exit_ids[:real].cpu()
            forced = res.capacity_exited[:real].cpu()
            self._n_served += real
            self._n_capacity_exited += int(forced.sum())
            probs = torch.softmax(logits.double(), dim=-1)
            for i in range(real):
                pred = int(probs[i].argmax())
                e = int(exits[i])
                results.append({
                    "label": self.id2label.get(pred, str(pred)),
                    "label_id": pred,
                    "confidence": float(probs[i, pred]),
                    "exit": e,
                    "exit_name": str(self.order[e]) if e < len(self.order)
                    else "final",
                    "capacity_exited": bool(forced[i]),
                })
        return results

    def metrics(self) -> Dict[str, float]:
        """Serving-health counters. ``capacity_exit_rate`` is the fraction of
        documents forced onto shallower best-so-far logits because a stage's
        capacity overflowed; the sizing rule designs for <= 1 - capacity_tail
        under i.i.d. traffic."""
        return {
            "documents_served": float(self._n_served),
            "capacity_exit_rate": (
                self._n_capacity_exited / self._n_served
                if self._n_served else 0.0
            ),
            "capacity_tail": self.capacity_tail,
        }
