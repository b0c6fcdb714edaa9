"""Staged anytime inference: early exits that save compute under batching.

The counterpart of the JAX package's ``models/ee/engine.py``. The batched
``ee_forward`` computes every exit and always runs the full depth; this
engine runs less:

- the encoder is split into stages at the exit layers; stage i runs layers
  (k_{i-1}, k_i] eagerly on the device over a bucket of rows, then exit
  k_i's head and criterion (the last stage: the final classifier);
- after each stage the host reads the (bucket,) criterion and logits back
  once, drops the samples that exit, gathers the survivors on the device
  and pads them to the next bucket size (powers of two from ``min_bucket``
  up to ``max_batch``), so each stage sees few distinct shapes;
- each stage builds its attention bias from the carried boxes, position
  ids and mask (``make_attention_bias``: ``materialize_bias`` on the card),
  and every layer runs the packed attention (``flash_attention_packed``);
- PABEE patience is stateful across exits: the host carries each sample's
  previous prediction and agreement count, which the stages leave alone.

The cascade (``models/ee/cascade.py``) is the serving path; this engine is
the criterion-faithful host loop and an offline store collector. Padding
rows of a bucket repeat the first row and are never read back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from multi_modal_early_exit_tpu_torch.config.exit_config import EarlyExitInference
from multi_modal_early_exit_tpu_torch.device import resolve_device
from multi_modal_early_exit_tpu_torch.models.ee.heads import exit_head_apply, lte_head_apply
from multi_modal_early_exit_tpu_torch.models.ee.model import EEModel, canonical_exit_order
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import EEModelConfig
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import (
    classifier_apply,
    embed_text,
    embed_vision,
    encoder_layer_apply,
    make_attention_bias,
    sequence_layout,
)


def _bucket_sizes(max_batch: int, minimum: int = 8) -> Tuple[int, ...]:
    sizes = []
    b = minimum
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)


def _round_bucket(n: int, sizes: Tuple[int, ...]) -> int:
    for s in sizes:
        if n <= s:
            return s
    return sizes[-1]


def _host(x: torch.Tensor) -> np.ndarray:
    return x.to(torch.float32).cpu().numpy()


class AnytimeEngine:
    """Bucketed staged inference over a fixed exit configuration, on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``; the model is
    moved there).

    ``infer(...)`` returns ``(final_logits (B, K), exit_ids (B,), store)``:
    each sample's logits come from the exit that claimed it, the live
    counterpart of ``Policy.max_confidence_global_thresholding_policy``.
    """

    def __init__(
        self,
        model: EEModel,
        cfg: EEModelConfig,
        threshold: Optional[float] = None,
        max_batch: int = 64,
        min_bucket: int = 8,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.exit_cfg = cfg.exit
        self.threshold = threshold if threshold is not None else cfg.exit.global_threshold
        self.sign = cfg.exit.inference_strategy.get_sign()
        self.crit_fn = cfg.exit.inference_strategy.get_function()
        self._use_lte = cfg.exit.inference_strategy == EarlyExitInference.LTE
        # patience (PABEE) is stateful across exits: the host keeps
        # (prev_pred, count) per sample and the stages skip the criterion
        self._use_patience = cfg.exit.inference_strategy == EarlyExitInference.PATIENCE
        if self._use_lte and model.lte is None:
            raise ValueError("LTE inference requires lte head params")
        self.buckets = _bucket_sizes(max_batch, min_bucket)
        self.order = canonical_exit_order(cfg.exit)
        self.emb_exits = [e for e in self.order if isinstance(e, str)]
        self.enc_exits = [e for e in self.order if isinstance(e, int)]

        # stage boundaries: [0, k1], (k1, k2], ..., (k_last, L]
        bounds = []
        prev = 0
        for k in self.enc_exits:
            bounds.append((prev, k))
            prev = k
        bounds.append((prev, cfg.backbone.num_hidden_layers))
        self.stage_bounds = bounds

    # ------------------------------------------------------------------
    # device stages
    # ------------------------------------------------------------------

    def _stage0(self, input_ids, bbox, pixel_values, attention_mask):
        """Embeddings and the embedding exits; returns the encoder input,
        the carried boxes/positions/mask and the exits' (E_emb, B, K)
        logits and (E_emb, B) criteria."""
        cfg = self.cfg.backbone
        bb = self.model.backbone
        b = input_ids.shape[0]
        text_emb = embed_text(bb.embeddings, cfg, input_ids, bbox)
        vis_emb = embed_vision(bb.visual, cfg, pixel_values)
        combined = bb.LayerNorm(torch.cat([text_emb, vis_emb], dim=1))
        full_bbox, pos_ids, full_mask = sequence_layout(cfg, bbox, attention_mask,
                                                        vis_emb.shape[1])
        sources = {"vision_avg": vis_emb, "text_avg": text_emb, "text_visual_concat": combined}
        logits, crit = [], []
        for name in self.emb_exits:
            x = sources[name].mean(dim=1)
            head_out = exit_head_apply(self.model.embedding_exits[name], cfg, x)
            if self.exit_cfg.apply_gating:
                # gate heads emit 2 logits, the criterion only; the class
                # prediction is the final classifier on this exit's input
                logits.append(classifier_apply(bb.classifier, cfg, x))
            else:
                logits.append(head_out)
            if self._use_lte:
                # LTE scores exist only at the concat exit
                crit.append(lte_head_apply(self.model.lte, x)
                            if name == "text_visual_concat"
                            else torch.full((b,), float("inf"), device=x.device))
            elif self._use_patience:
                crit.append(torch.zeros((b,), device=x.device))
            else:
                crit.append(self.crit_fn(head_out))
        if logits:
            logits_t, crit_t = torch.stack(logits), torch.stack(crit)
        else:
            logits_t = torch.zeros((0, b, cfg.num_labels), device=combined.device)
            crit_t = torch.zeros((0, b), device=combined.device)
        return (combined, full_bbox, pos_ids, full_mask), logits_t, crit_t

    def _stage(self, stage_idx, hidden, full_bbox, pos_ids, full_mask):
        """Encoder layers (a, b] with this stage's bias, then the exit head
        at b (the classifier after the last layer)."""
        cfg = self.cfg.backbone
        bb = self.model.backbone
        a, b_layer = self.stage_bounds[stage_idx]
        bias = make_attention_bias(bb, cfg, pos_ids, full_bbox, full_mask, dtype=hidden.dtype)
        for layer in bb.encoder.layers[a:b_layer]:
            hidden = encoder_layer_apply(layer, cfg, hidden, bias)
        cls = hidden[:, 0, :]
        zeros = torch.zeros((cls.shape[0],), device=cls.device)
        if stage_idx == len(self.stage_bounds) - 1:
            logits = classifier_apply(bb.classifier, cfg, cls)
            # the final classifier always exits: patience and LTE have no
            # criterion there (ee_forward records 0 for both, ROADMAP.md C2)
            crit = zeros if self._use_patience or self._use_lte else self.crit_fn(logits)
        else:
            head_out = exit_head_apply(self.model.encoder_exits[stage_idx], cfg, cls)
            logits = (classifier_apply(bb.classifier, cfg, cls) if self.exit_cfg.apply_gating
                      else head_out)
            if self._use_lte:
                crit = lte_head_apply(self.model.lte, cls)
            elif self._use_patience:
                crit = zeros
            else:
                crit = self.crit_fn(head_out)
        return hidden, logits, crit

    # ------------------------------------------------------------------
    # host orchestration
    # ------------------------------------------------------------------

    def _pad_gather(self, arrays, idx: np.ndarray, bucket: int):
        """Rows ``idx`` of each array, padded to ``bucket`` rows with row 0."""
        pad_idx = np.zeros(bucket, np.int64)
        pad_idx[: len(idx)] = idx
        index = torch.from_numpy(pad_idx).to(arrays[0].device)
        return tuple(a.index_select(0, index) for a in arrays)

    @torch.no_grad()
    def infer(
        self,
        input_ids,
        bbox,
        pixel_values,
        attention_mask,
        collect_store: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Run the stages; returns ``(final_logits, exit_ids, store | None)``.

        ``exit_ids`` index the canonical exit order with the final
        classifier at E (the offline policy contract). Inputs are numpy
        arrays or tensors; they are moved to the engine's device. With
        ``collect_store`` every stage runs on every sample and ``store`` is
        the (E + 1, B, K) logit store."""
        input_ids, bbox, pixel_values, attention_mask = (
            (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))).to(
                self.device)
            for x in (input_ids, bbox, pixel_values, attention_mask))
        B = input_ids.shape[0]
        K = self.cfg.backbone.num_labels
        E = len(self.order)
        out_logits = np.zeros((B, K), np.float32)
        out_exit = np.full(B, E, np.int32)
        store = np.zeros((E + 1, B, K), np.float32) if collect_store else None

        carried, emb_logits, emb_crit = self._stage0(input_ids, bbox, pixel_values,
                                                     attention_mask)
        emb_logits_h, emb_crit_h = _host(emb_logits), _host(emb_crit)

        alive = np.arange(B)
        # patience carry: previous top-1 prediction (-1 = none yet) and the
        # consecutive-agreement count per sample (PABEE)
        prev_pred = np.full(B, -1, np.int64)
        count = np.zeros(B, np.float64)
        # embedding exits decide in canonical order
        for j in range(len(self.emb_exits)):
            if store is not None:
                store[j] = emb_logits_h[j]
            if len(alive) == 0:
                continue
            if self._use_patience:
                preds = emb_logits_h[j][alive].argmax(-1)
                count[alive] = np.where(preds == prev_pred[alive], count[alive] + 1, 0)
                prev_pred[alive] = preds
                passed = count[alive] >= self.threshold
            else:
                passed = self.sign(emb_crit_h[j][alive], self.threshold)
            exiting = alive[passed]
            out_logits[exiting] = emb_logits_h[j][exiting]
            out_exit[exiting] = j
            alive = alive[~passed]

        n_emb = len(self.emb_exits)
        carried_idx = np.arange(B)  # the global sample id of each carried row
        for stage_idx in range(len(self.stage_bounds)):
            run_idx = carried_idx if collect_store else alive
            if len(run_idx) == 0:
                break
            bucket = _round_bucket(len(run_idx), self.buckets)
            # global sample ids -> rows of the carried arrays
            row_of = {g: r for r, g in enumerate(carried_idx)}
            rows = np.asarray([row_of[g] for g in run_idx], np.int64)
            gathered = self._pad_gather(carried, rows, bucket)
            hidden_b, logits_b, crit_b = self._stage(stage_idx, *gathered)
            logits_h = _host(logits_b)[: len(run_idx)]
            crit_h = _host(crit_b)[: len(run_idx)]

            is_final = stage_idx == len(self.stage_bounds) - 1
            exit_pos = n_emb + stage_idx
            if store is not None:
                store[exit_pos, run_idx] = logits_h

            alive_mask = np.isin(run_idx, alive)
            if is_final:
                final_rows = np.where(alive_mask)[0]
                out_logits[run_idx[final_rows]] = logits_h[final_rows]
                out_exit[run_idx[final_rows]] = E
                alive = np.asarray([], np.int64)
            elif self._use_patience:
                am_idx = run_idx[alive_mask]
                preds = logits_h[alive_mask].argmax(-1)
                count[am_idx] = np.where(preds == prev_pred[am_idx], count[am_idx] + 1, 0)
                prev_pred[am_idx] = preds
                passed = np.zeros(len(run_idx), bool)
                passed[alive_mask] = count[am_idx] >= self.threshold
                exiting = run_idx[passed]
                out_logits[exiting] = logits_h[passed]
                out_exit[exiting] = exit_pos
                alive = np.setdiff1d(alive, exiting, assume_unique=True)
            else:
                passed = self.sign(crit_h, self.threshold) & alive_mask
                exiting = run_idx[passed]
                out_logits[exiting] = logits_h[passed]
                out_exit[exiting] = exit_pos
                alive = np.setdiff1d(alive, exiting, assume_unique=True)

            # the bucket's padding rows are dropped from the carry
            n = len(run_idx)
            carried = (hidden_b[:n],) + tuple(a[:n] for a in gathered[1:])
            carried_idx = run_idx
        return out_logits, out_exit, store
