"""Capacity-constrained anytime cascade with static per-stage capacities.

The counterpart of the JAX package's ``models/ee/cascade.py``, run eagerly:

- stage 0 computes embeddings and the embedding-exit criteria for the full
  batch;
- before each encoder stage, the ``c_i`` least exit-worthy still-running
  samples are selected (a stable descending sort, so ties keep the lower
  row first, as ``jax.lax.top_k`` does) and compacted by gather, so the
  deep layers process only c_i rows;
- samples that want to continue but exceed capacity exit at once with their
  best logits so far ("capacity-constrained exiting"); with capacities >=
  the true survivor counts the decisions equal the exact threshold policy;
- the sequence is padded once to a multiple of 128, and stage 0 builds the
  (c_0, H, P, P) bias; later stages gather their rows out of the previous
  stage's bias (their rows are a subset of it) instead of rebuilding it.
  With ``MMEE_FUSED_BIAS=1`` (read per call) no bias tensor exists: each
  stage hands its layers a ``FusedBiasContext`` of its gathered rows.

FLOP cost is fixed per batch: stage i always costs c_i rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from multi_modal_early_exit_tpu_torch.config.exit_config import EarlyExitInference
from multi_modal_early_exit_tpu_torch.models.ee.heads import exit_head_apply, lte_head_apply
from multi_modal_early_exit_tpu_torch.models.ee.model import EEModel, canonical_exit_order
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import EEModelConfig
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import (
    classifier_apply,
    embed_text,
    embed_vision,
    encoder_layer_apply,
    fused_bias_context,
    has_both_biases,
    make_attention_bias,
    pad_sequence,
    sequence_layout,
    use_fused_bias_attention,
)
from multi_modal_early_exit_tpu_torch.ops.fused_bias_attention import LANE


def capacities_from_distribution(
    exit_distribution: Dict[int, float],
    batch: int,
    n_emb: int,
    n_stages: int,
    margin: float = 1.25,
    multiple: int = 8,
    tail: Optional[float] = None,
) -> Tuple[int, ...]:
    """Per-stage capacities from a (validation) exit distribution.

    ``margin``: expected survivor count times a flat safety factor.
    ``tail`` (preferred when set, e.g. 0.995): the binomial-tail quantile
    mean + z·sqrt(B·p·(1−p)), z = Phi^{-1}(tail) — the smallest capacity
    that covers the stage's survivor count in a ``tail`` fraction of i.i.d.
    batches. Rounded up to ``multiple``, capped at ``batch``.
    """
    surv = 1.0
    for j in range(n_emb):
        surv -= exit_distribution.get(j, 0.0)
    caps = []
    for s in range(n_stages):
        p = min(max(surv, 0.0), 1.0)
        if tail is not None:
            from scipy.stats import norm

            z = float(norm.ppf(tail))
            want = p * batch + z * np.sqrt(batch * p * (1.0 - p))
        else:
            want = p * batch * margin
        c = min(batch, int(np.ceil(want / multiple)) * multiple)
        caps.append(max(c, multiple))
        surv -= exit_distribution.get(n_emb + s, 0.0)
    return tuple(caps)


@dataclasses.dataclass
class CascadeResult:
    logits: torch.Tensor  # (B, K) f32 per-sample final logits (from its exit)
    exit_ids: torch.Tensor  # (B,) int32 canonical exit index; E == final
    capacity_exited: torch.Tensor  # (B,) bool: exited due to capacity


def make_cascade_forward(
    cfg: EEModelConfig,
    capacities: Sequence[int],
    threshold=None,
    temperatures: Optional[Sequence[float]] = None,
):
    """Build the cascade ``fn(model, input_ids, bbox, pixel_values,
    attention_mask) -> CascadeResult``.

    ``capacities[i]`` is the row count of encoder stage i (stages split at
    the encoder exits; the last runs to the final classifier).
    ``threshold`` is one global value or a per-exit sequence of length
    num_exits; the final classifier always exits. ``temperatures`` (length
    num_exits + 1) scales each exit's criterion input (not its prediction);
    ignored for patience and LTE.
    """
    exit_cfg = cfg.exit
    bb_cfg = cfg.backbone
    thr = exit_cfg.global_threshold if threshold is None else threshold
    sign = exit_cfg.inference_strategy.get_sign()
    crit_fn = exit_cfg.inference_strategy.get_function()
    use_lte = exit_cfg.inference_strategy == EarlyExitInference.LTE
    # patience is stateful: the cascade carries (prev_pred, count) per row
    use_patience = exit_cfg.inference_strategy == EarlyExitInference.PATIENCE
    order = canonical_exit_order(exit_cfg)
    E = len(order)
    if temperatures is not None:
        if len(temperatures) != E + 1:
            raise ValueError(
                f"need {E + 1} temperatures (one per exit + final), "
                f"got {len(temperatures)}"
            )
        temps = tuple(float(t) for t in temperatures)
    else:
        temps = (1.0,) * (E + 1)
    emb_exits = [e for e in order if isinstance(e, str)]
    enc_exits = [e for e in order if isinstance(e, int)]
    n_emb = len(emb_exits)
    if np.ndim(thr) == 0:
        thrs = (float(thr),) * E
    else:
        if len(thr) != E:
            raise ValueError(
                f"need {E} per-exit thresholds (one per exit; the final "
                f"classifier always exits), got {len(thr)}"
            )
        thrs = tuple(float(t) for t in thr)
    bounds = []
    prev = 0
    for k in enc_exits:
        bounds.append((prev, k))
        prev = k
    bounds.append((prev, bb_cfg.num_hidden_layers))
    if len(capacities) != len(bounds):
        raise ValueError(
            f"need {len(bounds)} capacities (one per encoder stage), got "
            f"{len(capacities)}"
        )
    # rank so the LEAST exit-worthy rows keep compute: for 'greater is
    # exit' criteria low values continue, for 'lower is exit' high values
    higher_exits = bool(sign(1.0, 0.0))

    @torch.no_grad()
    def cascade(model: EEModel, input_ids, bbox, pixel_values, attention_mask):
        bb = model.backbone
        B = input_ids.shape[0]
        K = bb_cfg.num_labels
        dev = input_ids.device
        if n_emb == 0 and capacities[0] < B:
            raise ValueError(
                "capacities[0] must cover the full batch when the config "
                "has no embedding exits"
            )

        # ---- stage 0: embeddings + embedding exits (full batch) --------
        text_emb = embed_text(bb.embeddings, bb_cfg, input_ids, bbox)
        vis_emb = embed_vision(bb.visual, bb_cfg, pixel_values)
        combined = bb.LayerNorm(torch.cat([text_emb, vis_emb], dim=1))
        full_bbox, pos_ids, full_mask = sequence_layout(
            bb_cfg, bbox, attention_mask, vis_emb.shape[1]
        )

        out_logits = torch.zeros((B, K), dtype=torch.float32, device=dev)
        exit_ids = torch.full((B,), E, dtype=torch.int32, device=dev)
        running = torch.ones((B,), dtype=torch.bool, device=dev)
        last_crit = torch.zeros((B,), dtype=torch.float32, device=dev)
        # patience: top-1 prediction at the previous exit (-1 = none yet);
        # the agreement count lives in last_crit
        prev_pred = torch.full((B,), -1, dtype=torch.int64, device=dev)

        sources = {"vision_avg": vis_emb, "text_avg": text_emb,
                   "text_visual_concat": combined}
        for j, name in enumerate(emb_exits):
            x = sources[name].mean(dim=1)
            head_out = exit_head_apply(
                model.embedding_exits[name], bb_cfg, x
            ).to(torch.float32)
            if exit_cfg.apply_gating:
                # gate heads: 2-logit criterion; the prediction is the
                # final classifier on the exit input
                logits_j = classifier_apply(bb.classifier, bb_cfg, x).to(torch.float32)
            else:
                logits_j = head_out
            if use_lte:
                crit_j = (
                    lte_head_apply(model.lte, x).to(torch.float32)
                    if name == "text_visual_concat"
                    else torch.full((B,), float("inf"), device=dev)
                )
            elif use_patience:
                pred_j = logits_j.argmax(dim=-1)
                crit_j = torch.where(pred_j == prev_pred, last_crit + 1.0, 0.0)
                prev_pred = torch.where(running, pred_j, prev_pred)
            else:
                crit_j = crit_fn(head_out / temps[j])
            exits_now = running & sign(crit_j, thrs[j])
            # exiting rows take this exit's logits; rows that go on keep
            # them as their best so far, for a later capacity-forced exit
            out_logits = torch.where(running[:, None], logits_j, out_logits)
            exit_ids = torch.where(exits_now, j, exit_ids).to(torch.int32)
            last_crit = torch.where(running, crit_j, last_crit)
            running = running & ~exits_now

        capacity_exited = torch.zeros((B,), dtype=torch.bool, device=dev)
        prev_bias = prev_sel = None
        fused = has_both_biases(bb_cfg) and use_fused_bias_attention()
        # pad once to the bias width: every stage runs at P = S_pad
        state = pad_sequence(LANE, combined, full_bbox, pos_ids, full_mask)

        for stage_idx, (a, b_layer) in enumerate(bounds):
            c = int(capacities[stage_idx])
            # running rows outrank finished ones; among running rows the
            # least exit-worthy come first; ties keep the lower row first
            score = -last_crit if higher_exits else last_crit
            score = torch.where(running, score, float("-inf"))
            sel = torch.sort(score, descending=True, stable=True).indices[:c]
            selected = torch.zeros((B,), dtype=torch.bool, device=dev)
            selected[sel] = True
            # capacity-forced exits take their last evaluated exit (the
            # deepest embedding exit before stage 0, else the previous
            # encoder exit) with their best-so-far logits
            forced = running & ~selected
            forced_exit = max(n_emb - 1, 0) if stage_idx == 0 else n_emb + stage_idx - 1
            exit_ids = torch.where(forced, forced_exit, exit_ids).to(torch.int32)
            capacity_exited = capacity_exited | forced
            running = running & selected

            hidden_c, bbox_c, pos_c, mask_c = (t[sel] for t in state)
            if fused:
                # the attention kernel builds each stage's bias from its
                # rows' vectors; no bias tensor exists to gather from
                bias_c = fused_bias_context(bb, bb_cfg, pos_c, bbox_c, mask_c)
            elif prev_bias is None:
                bias_c = make_attention_bias(
                    bb, bb_cfg, pos_c, bbox_c, mask_c, dtype=hidden_c.dtype
                )
                prev_bias, prev_sel = bias_c, sel
            else:
                # this stage's rows are a subset of the previous stage's:
                # gather their bias rows instead of rebuilding them
                pos_in_prev = torch.zeros((B,), dtype=torch.int64, device=dev)
                pos_in_prev[prev_sel] = torch.arange(prev_sel.shape[0], device=dev)
                bias_c = prev_bias[pos_in_prev[sel]]
                prev_bias, prev_sel = bias_c, sel

            for layer in bb.encoder.layers[a:b_layer]:
                hidden_c = encoder_layer_apply(layer, bb_cfg, hidden_c, bias_c)

            is_final = stage_idx == len(bounds) - 1
            cls_c = hidden_c[:, 0, :]
            if is_final:
                logits_c = classifier_apply(bb.classifier, bb_cfg, cls_c).to(torch.float32)
                # the final classifier always exits; patience and LTE have no
                # criterion there (ee_forward records 0 for both)
                crit_c = (
                    torch.zeros((c,), dtype=torch.float32, device=dev)
                    if use_patience or use_lte
                    else crit_fn(logits_c / temps[E])
                )
            else:
                head_out = exit_head_apply(
                    model.encoder_exits[stage_idx], bb_cfg, cls_c
                ).to(torch.float32)
                if exit_cfg.apply_gating:
                    logits_c = classifier_apply(bb.classifier, bb_cfg, cls_c).to(torch.float32)
                else:
                    logits_c = head_out
                if use_lte:
                    crit_c = lte_head_apply(model.lte, cls_c).to(torch.float32)
                elif use_patience:
                    pred_c = logits_c.argmax(dim=-1)
                    crit_c = torch.where(pred_c == prev_pred[sel], last_crit[sel] + 1.0, 0.0)
                    prev_pred[sel] = pred_c
                else:
                    crit_c = crit_fn(head_out / temps[n_emb + stage_idx])

            # scatter stage results back to batch rows
            sel_running = running[sel]  # selected rows still running
            stage_thr = thrs[min(n_emb + stage_idx, E - 1)] if E else 0.0
            pass_c = sign(crit_c, stage_thr) | is_final
            exit_pos = E if is_final else n_emb + stage_idx
            out_logits[sel] = torch.where(sel_running[:, None], logits_c, out_logits[sel])
            exit_ids[sel] = torch.where(
                sel_running & pass_c, exit_pos, exit_ids[sel]
            ).to(torch.int32)
            running[sel] = sel_running & ~pass_c
            last_crit[sel] = crit_c

            if not is_final:
                # scatter the compacted state back to batch rows so the next
                # stage's selection indexes one frame; rows of non-selected
                # samples are stale but `running` excludes them
                new_state = []
                for t, t_c in zip(state, (hidden_c, bbox_c, pos_c, mask_c)):
                    full = torch.zeros_like(t)
                    full[sel] = t_c
                    new_state.append(full)
                state = tuple(new_state)
        return CascadeResult(out_logits, exit_ids, capacity_exited)

    return cascade
