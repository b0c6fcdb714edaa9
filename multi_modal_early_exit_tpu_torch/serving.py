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
request, or from OCR (tesseract) when the request has none.
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
from multi_modal_early_exit_tpu_torch.utils import profiling
from multi_modal_early_exit_tpu_torch.utils.profiling import count, span


class Pipeline:
    """Anytime document classification with a fixed serving batch size.

    On the card a LayoutLMv3 model's cascade replays CUDA graphs that read
    ``model``'s parameters where they lay at its first batch: replace none
    of them after it (``models.ee.cascade``)."""

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
        self._n_emb = n_emb
        # layers per encoder stage (stages split at the encoder exits)
        ends = sorted(e for e in self.order if isinstance(e, int))
        ends.append(cfg.backbone.num_hidden_layers)
        self._stage_layers = [b - a for a, b in zip([0] + ends, ends)]
        self._stage_counters = [
            (f"cascade.stage{i}.rows", f"cascade.stage{i}.rows_wanted",
             f"cascade.stage{i}.rows_refused") for i in range(n_stages)
        ]
        # this instance's totals of the counters it adds to the process's
        self._counts: Dict[str, int] = {}
        self._cascade = make_cascade_forward(cfg, capacities=caps, threshold=threshold)

    @classmethod
    def from_checkpoint(cls, directory: str, **kwargs) -> "Pipeline":
        """A pipeline over a training checkpoint (``training/checkpoint.py``
        layout): the backbone config read off the state dict's shapes
        (``infer_backbone_config``), the ``ExitConfig`` from the saved run
        config. ``kwargs`` go to ``Pipeline`` (``device`` among them)."""
        from multi_modal_early_exit_tpu_torch.config.experiment import ExperimentConfig
        from multi_modal_early_exit_tpu_torch.models.registry import infer_backbone_config
        from multi_modal_early_exit_tpu_torch.training.checkpoint import load_checkpoint

        state, saved, _, _ = load_checkpoint(directory)
        exp = ExperimentConfig.from_dict(saved or {})
        cfg = EEModelConfig(backbone=infer_backbone_config(state), exit=exp.exit_config())
        model = EEModel(cfg, device="cpu")
        model.load_state_dict(state, strict=True)
        return cls(model, cfg, **kwargs)

    def preprocess(
        self,
        images: Sequence,
        words: Optional[Sequence[Sequence[str]]] = None,
        boxes: Optional[Sequence[Sequence[Sequence[int]]]] = None,
    ) -> Dict[str, object]:
        """Host features (numpy) plus normalized ``pixel_values`` on the
        device. Without words or boxes each page is OCR'd
        (``data.ocr.apply_tesseract``; pytesseract must be installed)."""
        if words is None or boxes is None:
            from multi_modal_early_exit_tpu_torch.data.ocr import apply_tesseract

            pairs = [apply_tesseract(im.convert("RGB")) for im in images]
            words = [p[0] for p in pairs]
            boxes = [p[1] for p in pairs]
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

    def _copy_in(self, v) -> torch.Tensor:
        """A request's array (numpy or a tensor) on the pipeline's device.
        A copy from the host's pageable memory waits for the card's queue:
        the span ``sync.copy_in``, one an array."""
        t = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
        if not t.is_cpu:
            return t.to(self.device)
        with profiling.sync("copy_in"):
            return t.to(self.device)

    @torch.no_grad()
    def predict_features(self, batch: Dict[str, object]) -> List[Dict]:
        """Run preprocessed features (numpy arrays or tensors) through the
        cascade; pads to the static batch size and chunks larger inputs. A
        text-only model (Moonlight) takes ``input_ids`` and
        ``attention_mask`` alone. A vision-language model (Kimi-VL, ``EEkimivl``) takes
        them, with each row's page's placeholder ids where its image tokens
        go, beside each row's page: ``pixel_values`` (B, P, 588), the page's
        14 x 14 x 3 patch rows in row-major order, padded to P rows, and
        ``image_grid_hws`` (B, 2), its patch grid (h, w)."""
        with span("pipeline.copy_in"):
            tensors = {k: self._copy_in(v) for k, v in batch.items()}
        n = len(tensors["input_ids"])
        results: List[Dict] = []
        for start in range(0, n, self.batch_size):
            with span("pipeline.copy_in"):
                idx = np.arange(start, min(start + self.batch_size, n))
                real = len(idx)
                if real < self.batch_size:
                    # pad a short batch by repeating its rows
                    idx = np.concatenate([idx, np.resize(idx, self.batch_size - real)])
                with profiling.sync("rows"):
                    rows = torch.as_tensor(idx, device=self.device)
                chunk = {k: v[rows] for k, v in tensors.items()}
            res = self._cascade(
                self.model, chunk["input_ids"], chunk.get("bbox"),
                chunk.get("pixel_values"), chunk["attention_mask"],
                chunk.get("image_grid_hws"),
            )
            with span("pipeline.answers"):
                with profiling.sync("answers"):
                    logits = res.logits[:real].cpu()
                with profiling.sync("answers"):
                    exits = res.exit_ids[:real].cpu()
                with profiling.sync("answers"):
                    forced = res.capacity_exited[:real].cpu()
                self._count_chunk(exits.numpy(), forced.numpy())
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

    def _tally(self, name: str, n: int) -> None:
        self._counts[name] = self._counts.get(name, 0) + n
        count(name, n)

    def _count_chunk(self, exits: np.ndarray, forced: np.ndarray) -> None:
        """Add one served chunk's real rows to the counters. A row's deepest
        encoder stage is ``exit - n_emb + forced``: a row that left at
        stage i's exit ran stage i, a capacity-forced row wanted the stage
        that refused it, and an embedding exit wanted none (negative).
        Stage i is wanted by the rows whose deepest stage is at least i,
        and runs ``capacities[i]`` rows whatever the chunk holds."""
        deepest = exits.astype(np.int64) - self._n_emb + forced
        n_stages = len(self.capacities)
        reached = np.bincount(deepest[deepest >= 0], minlength=n_stages)
        wanted = np.cumsum(reached[::-1])[::-1]
        refused = np.bincount(deepest[forced], minlength=n_stages)
        self._tally("serving.documents", len(exits))
        self._tally("serving.capacity_exited", int(forced.sum()))
        for (rows, want, refuse), c, w, r in zip(
            self._stage_counters, self.capacities, wanted, refused
        ):
            self._tally(rows, int(c))
            self._tally(want, int(w))
            self._tally(refuse, int(r))

    def metrics(self) -> Dict[str, float]:
        """Serving-health counters. ``capacity_exit_rate`` is the fraction of
        documents forced onto shallower best-so-far logits because a stage's
        capacity overflowed; the sizing rule designs for <= 1 - capacity_tail
        under i.i.d. traffic. ``encoder_fill`` is the share of the encoder
        layers' rows run that served a real document still running:
        sum_i L_i (wanted_i - refused_i) / sum_i L_i rows_i, with L_i stage
        i's layer count (0 before any document)."""
        counts = self._counts
        served = counts.get("serving.documents", 0)
        useful = run = 0
        for (rows, want, refuse), layers in zip(self._stage_counters, self._stage_layers):
            useful += layers * (counts.get(want, 0) - counts.get(refuse, 0))
            run += layers * counts.get(rows, 0)
        return {
            "documents_served": float(served),
            "capacity_exit_rate": (
                counts.get("serving.capacity_exited", 0) / served if served else 0.0
            ),
            "capacity_tail": self.capacity_tail,
            "encoder_fill": useful / run if run else 0.0,
        }
