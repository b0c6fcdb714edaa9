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
- what a stage carries besides its rows (LayoutLMv3's bias, built once and
  gathered after; Moonlight's rotary tables) is the stages' own.

FLOP cost is fixed per batch: stage i always costs c_i rows.

On the card, where the stages' shapes follow from the inputs' alone
(``uses_cuda_graphs``), the first call of each key (the model and where its
first parameter lies, the inputs' shapes, dtypes and device, the stages'
``graph_key``: LayoutLMv3's fused-bias switch) runs op by op and then
captures the embedding part and each stage as one CUDA graph each, sharing
a memory pool; later calls copy their inputs into the graphs' own, replay
the graphs, each inside its part's span, and return copies of the outputs.
A graph reads the parameters where they lay at capture: they must not be
replaced after a key's first call (a ``.to()`` that moves them all takes a
new key). A capture that fails raises. The counters
``cascade.graph_replays`` and ``cascade.eager_calls`` count the two kinds
of call; what a part's host code adds to the counters (kernel launches
among them) is added again at each replay.

What differs between backbones (the embedding, a stage's layers, an exit's
input, the classifier) comes from the backbone's stages object
(``models.ee.model.backbone_stages``), chosen once, when the cascade is
built: LayoutLMv3's (``models.layoutlmv3.modeling.LayoutLMv3Stages``),
Moonlight's (``models.moonlight.modeling.CascadeStages``: no embedding
exits, causal layers, the last real token read) or Kimi-VL's (Moonlight's
with a vision tower in its embedding part). Selection, capacity-forced
exits and the criteria are shared.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from multi_modal_early_exit_tpu_torch.config.exit_config import EarlyExitInference
from multi_modal_early_exit_tpu_torch.models.ee.heads import exit_head_apply, lte_head_apply
from multi_modal_early_exit_tpu_torch.models.ee.model import (
    EEModel,
    backbone_stages,
    canonical_exit_order,
    page_inputs,
)
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import EEModelConfig
from multi_modal_early_exit_tpu_torch.utils.profiling import (
    add_tallies,
    count,
    recorded_tallies,
    span,
)


def uses_cuda_graphs(stages, x: torch.Tensor) -> bool:
    """Whether the cascade replays CUDA graphs for inputs like ``x``: on
    CUDA inputs, where the stages declare shapes that no data moves
    (Moonlight's do not: a stage reads its real-token list on the host)."""
    return x.is_cuda and stages.static_shapes


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


class _Call:
    """One call's running state, which the embedding part makes and each
    stage reads and updates: the per-row tensors a stage gathers, the
    stages' carry, and per row the logits so far, exit, running flag, last
    criterion, previous prediction (patience) and capacity flag."""

    __slots__ = ("state", "carry", "out_logits", "exit_ids", "running", "last_crit",
                 "prev_pred", "capacity_exited")

    def __init__(self, state, carry):
        self.state, self.carry = state, carry


class _Graphs:
    """One key's captured call: static inputs, a CUDA graph per part (the
    embedding part, then each stage) in one memory pool, each part's
    tallies (``utils.profiling.recorded_tallies``), the static outputs.
    Each graph's outputs lie where the next one reads them; replays run in
    the order of capture, on the current stream."""

    def __init__(self, model, inputs, embed_part, stage_part, spans):
        # kept alive: the key holds its id, the graphs its parameters' addresses
        self.model = model
        self.spans = spans
        self.inputs = [None if x is None else x.clone() for x in inputs]
        pool = torch.cuda.graph_pool_handle()
        self.graphs, self.tallies = [], []
        run = None
        for part in range(1 + len(spans)):
            graph = torch.cuda.CUDAGraph()
            with recorded_tallies() as tallies, torch.cuda.graph(graph, pool=pool):
                if part == 0:
                    run = embed_part(model, *self.inputs)
                else:
                    stage_part(model, run, part - 1)
            self.graphs.append(graph)
            self.tallies.append(tallies)
        self.outputs = (run.out_logits, run.exit_ids, run.capacity_exited)

    def replay(self, inputs) -> CascadeResult:
        """The call on ``inputs``: each copied into its static input, each
        graph replayed inside its part's span. The result is a copy, so it
        outlives the next call."""
        count("cascade.graph_replays")
        with span("cascade.embed"):
            for buf, x in zip(self.inputs, inputs):
                if x is not None:
                    buf.copy_(x)
            self.graphs[0].replay()
            add_tallies(self.tallies[0])
        for name, graph, tallies in zip(self.spans, self.graphs[1:], self.tallies[1:]):
            with span(name):
                graph.replay()
                add_tallies(tallies)
        return CascadeResult(*(t.clone() for t in self.outputs))


def make_cascade_forward(
    cfg: EEModelConfig,
    capacities: Sequence[int],
    threshold=None,
    temperatures: Optional[Sequence[float]] = None,
):
    """Build the cascade ``fn(model, input_ids, bbox, pixel_values,
    attention_mask, image_grid_hws=None) -> CascadeResult``
    (``image_grid_hws``: each row's patch grid, for a backbone that reads
    pages).

    ``capacities[i]`` is the row count of encoder stage i (stages split at
    the encoder exits; the last runs to the final classifier).
    ``threshold`` is one global value or a per-exit sequence of length
    num_exits; the final classifier always exits. ``temperatures`` (length
    num_exits + 1) scales each exit's criterion input (not its prediction);
    ignored for patience and LTE.

    On the card a LayoutLMv3 model's parameters must not be replaced after
    its first call (the module docstring): the graphs read them where they
    lay at capture.
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
    stage_spans = [f"cascade.stage{i}" for i in range(len(bounds))]
    stages = backbone_stages(bb_cfg)

    def embed_part(model: EEModel, input_ids, bbox, pixel_values, attention_mask,
                   image_grid_hws=None) -> _Call:
        """Stage 0: embeddings and the embedding exits over the full batch."""
        B = input_ids.shape[0]
        K = bb_cfg.num_labels
        dev = input_ids.device
        state, sources, carry = stages.embed(
            model, input_ids, bbox, pixel_values, attention_mask, **page_inputs(image_grid_hws)
        )
        run = _Call(state, carry)
        out_logits = torch.zeros((B, K), dtype=torch.float32, device=dev)
        exit_ids = torch.full((B,), E, dtype=torch.int32, device=dev)
        running = torch.ones((B,), dtype=torch.bool, device=dev)
        last_crit = torch.zeros((B,), dtype=torch.float32, device=dev)
        # patience: top-1 prediction at the previous exit (-1 = none yet);
        # the agreement count lives in last_crit
        prev_pred = torch.full((B,), -1, dtype=torch.int64, device=dev)

        for j, name in enumerate(emb_exits):
            x = sources[name].mean(dim=1)
            head_out = exit_head_apply(
                model.embedding_exits[name], bb_cfg, x
            ).to(torch.float32)
            if exit_cfg.apply_gating:
                # gate heads: 2-logit criterion; the prediction is the
                # final classifier on the exit input
                logits_j = stages.classify(model, x).to(torch.float32)
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
        run.out_logits, run.exit_ids, run.running = out_logits, exit_ids, running
        run.last_crit, run.prev_pred, run.capacity_exited = last_crit, prev_pred, capacity_exited
        return run

    def stage_part(model: EEModel, run: _Call, stage_idx: int) -> None:
        """Encoder stage ``stage_idx``: selection, capacity-forced exits, the
        stage's layers over its rows, its exit, the scatter back to batch
        rows (``run`` updated in place)."""
        a, b_layer = bounds[stage_idx]
        B = run.running.shape[0]
        dev = run.running.device
        running, last_crit, prev_pred = run.running, run.last_crit, run.prev_pred
        c = int(capacities[stage_idx])
        # running rows outrank finished ones; among running rows the
        # least exit-worthy come first; ties keep the lower row first
        score = -last_crit if higher_exits else last_crit
        score = torch.where(running, score, float("-inf"))
        sel = torch.sort(score, descending=True, stable=True).indices[:c]
        # index_fill_ takes the value as a kernel argument; an index
        # assignment of a Python scalar copies it from the host and waits
        selected = torch.zeros((B,), dtype=torch.bool, device=dev).index_fill_(0, sel, True)
        # capacity-forced exits take their last evaluated exit (the
        # deepest embedding exit before stage 0, else the previous
        # encoder exit) with their best-so-far logits
        forced = running & ~selected
        forced_exit = max(n_emb - 1, 0) if stage_idx == 0 else n_emb + stage_idx - 1
        exit_ids = torch.where(forced, forced_exit, run.exit_ids).to(torch.int32)
        run.capacity_exited = run.capacity_exited | forced
        running = running & selected

        hidden_c, rest_c, cls_c = stages.layers(model, run.state, sel, a, b_layer, run.carry)

        is_final = stage_idx == len(bounds) - 1
        if is_final:
            logits_c = stages.classify(model, cls_c).to(torch.float32)
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
                logits_c = stages.classify(model, cls_c).to(torch.float32)
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
        out_logits = run.out_logits
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
        run.exit_ids, run.running = exit_ids, running

        if not is_final:
            # scatter the compacted state back to batch rows so the next
            # stage's selection indexes one frame; rows of non-selected
            # samples are stale but `running` excludes them
            new_state = []
            for t, t_c in zip(run.state, (hidden_c,) + rest_c):
                full = torch.zeros_like(t)
                full[sel] = t_c
                new_state.append(full)
            run.state = new_state

    def eager(model: EEModel, *inputs) -> CascadeResult:
        """The call op by op, each part inside its span."""
        count("cascade.eager_calls")
        with span("cascade.embed"):
            run = embed_part(model, *inputs)
        for stage_idx in range(len(bounds)):
            with span(stage_spans[stage_idx]):
                stage_part(model, run, stage_idx)
        return CascadeResult(run.out_logits, run.exit_ids, run.capacity_exited)

    captured: Dict[tuple, _Graphs] = {}

    def key(model: EEModel, specs, device) -> tuple:
        """What a capture holds fixed: the model and its first parameter's
        address (moved by a ``.to()``), the inputs' (shape, dtype) (None for
        an input not given), their device, and the stages' own
        (``graph_key``: LayoutLMv3's fused-bias switch)."""
        first = next(model.parameters()).data_ptr()
        return id(model), first, tuple(specs), device, stages.graph_key()

    @torch.no_grad()
    def cascade(model: EEModel, input_ids, bbox, pixel_values, attention_mask,
                image_grid_hws=None):
        if n_emb == 0 and capacities[0] < input_ids.shape[0]:
            raise ValueError(
                "capacities[0] must cover the full batch when the config "
                "has no embedding exits"
            )
        inputs = (input_ids, bbox, pixel_values, attention_mask, image_grid_hws)
        if not uses_cuda_graphs(stages, input_ids):
            return eager(model, *inputs)
        k = key(model, (None if x is None else (tuple(x.shape), x.dtype) for x in inputs),
                input_ids.device)
        graphs = captured.get(k)
        if graphs is not None:
            return graphs.replay(inputs)
        # the first call of a key runs op by op: it builds the kernels and
        # sets the libraries' handles up before anything is captured
        result = eager(model, *inputs)
        captured[k] = _Graphs(model, inputs, embed_part, stage_part, stage_spans)
        return result

    return cascade
