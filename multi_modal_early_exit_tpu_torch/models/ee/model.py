"""The early-exit LayoutLMv3 model: parameters, batched forward, decisions.

The counterpart of the JAX package's ``models/ee/model.py``:

- embedding-level exits tap modality means before the encoder:
  ``vision_avg`` (visual embeddings), ``text_avg`` (text embeddings),
  ``text_visual_concat`` (the concatenated + LayerNormed sequence);
- encoder exits tap the [CLS] state after layer i;
- exit heads are ramps (num_labels logits) or gates (2 logits); with gating
  the final classifier applied to the exit input gives the prediction;
- criteria are computed on head outputs for every exit, and
  ``decide_exits`` takes the first exit whose criterion clears the
  threshold.

``ee_forward`` is differentiable; inference callers run it under
``torch.no_grad()``. With ``deterministic=False`` the dropout seeds come from
a ``torch.Generator``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from multi_modal_early_exit_tpu_torch.config.exit_config import (
    EarlyExitInference,
    ExitConfig,
)
from multi_modal_early_exit_tpu_torch.device import resolve_device
from multi_modal_early_exit_tpu_torch.models.ee.heads import (
    ExitHead,
    exit_head_apply,
    lte_head_apply,
)
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import EEModelConfig
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import (
    LayoutLMv3Model,
    Linear,
    RngStream,
    backbone_apply,
    classifier_apply,
    reset_parameters,
)

# Forward order of the embedding exits: vision first, then text, then
# concat, whatever order the user listed them in.
EMBEDDING_FORWARD_ORDER = ("vision_avg", "text_avg", "text_visual_concat")


def canonical_exit_order(exit_cfg: ExitConfig) -> Tuple:
    """Exits in the order their logits appear in ``exit_logits``."""
    emb = tuple(e for e in EMBEDDING_FORWARD_ORDER if e in exit_cfg.embedding_exits)
    return emb + exit_cfg.encoder_exits


class EEModel(nn.Module):
    """Backbone + exit heads, uninitialised, on ``device`` (``cuda`` by
    default). ``encoder_exits[i]`` is the head of the i-th encoder exit;
    ``embedding_exits`` is keyed by exit name; ``lte`` exists with
    ``use_lte``. ``with_text``/``with_vision`` prune the backbone's towers
    (the dense ``dit`` and ``bert`` variants, which have no exits)."""

    def __init__(self, cfg: EEModelConfig, device=None, with_text: bool = True,
                 with_vision: bool = True):
        super().__init__()
        device = resolve_device(device)
        backbone, exit_cfg = cfg.backbone, cfg.exit
        self.backbone = LayoutLMv3Model(backbone, device="cpu", with_text=with_text,
                                        with_vision=with_vision)
        emb = {
            name: ExitHead(backbone, exit_cfg)
            for name in EMBEDDING_FORWARD_ORDER
            if name in exit_cfg.embedding_exits
        }
        self.embedding_exits = nn.ModuleDict(emb) if emb else None
        self.encoder_exits = (
            nn.ModuleList(ExitHead(backbone, exit_cfg) for _ in exit_cfg.encoder_exits)
            if exit_cfg.encoder_exits else None
        )
        self.lte = Linear(backbone.hidden_size, 1) if exit_cfg.use_lte else None
        self.to(device)

    def forward(self, cfg: EEModelConfig, *args, **kwargs) -> "EEOutputs":
        """``ee_forward(self, cfg, ...)``, so that ``torch.func.functional_call``
        can run the model on other parameters (the training loss's bf16
        copies)."""
        return ee_forward(self, cfg, *args, **kwargs)


def init_ee_params(
    cfg: EEModelConfig,
    generator: Optional[torch.Generator] = None,
    device=None,
    dtype: torch.dtype = torch.float32,
    with_text: bool = True,
    with_vision: bool = True,
) -> EEModel:
    """Random EE parameters from a (CPU) ``generator`` (seed 0 if none),
    with the JAX package's shapes and std, on ``device`` in ``dtype``;
    ``with_text``/``with_vision`` as in ``EEModel``."""
    device = resolve_device(device)
    model = EEModel(cfg, device="cpu", with_text=with_text, with_vision=with_vision)
    reset_parameters(model, generator or torch.Generator().manual_seed(0),
                     cfg.backbone.initializer_range)
    return model.to(device=device, dtype=dtype)


def prune_ee_params(model: EEModel, old_cfg, new_cfg) -> EEModel:
    """A view of ``model`` for a pruned exit config: heads of dropped exits
    are left out, every other parameter is shared. ``encoder_exits`` heads
    are kept by position in the old config's encoder exits,
    ``embedding_exits`` by name."""
    old_exit = old_cfg.exit if hasattr(old_cfg, "exit") else old_cfg
    new_exit = new_cfg.exit if hasattr(new_cfg, "exit") else new_cfg
    out = copy.copy(model)
    out._modules = dict(model._modules)  # own submodule table; params shared
    if model.embedding_exits is not None:
        kept = {
            name: head for name, head in model.embedding_exits.items()
            if name in new_exit.embedding_exits
        }
        out.embedding_exits = nn.ModuleDict(kept) if kept else None
    if model.encoder_exits is not None:
        kept_heads = [
            model.encoder_exits[i]
            for i, layer in enumerate(old_exit.encoder_exits)
            if layer in new_exit.encoder_exits
        ]
        out.encoder_exits = nn.ModuleList(kept_heads) if kept_heads else None
    return out


@dataclasses.dataclass
class EEOutputs:
    """All per-exit tensors from one batched forward. ``E`` = number of
    exits; the final classifier is index E in policy space."""

    logits: torch.Tensor  # (B, K) final classifier
    exit_logits: torch.Tensor  # (E, B, head_dim) raw head outputs
    exit_criteria: torch.Tensor  # (E + 1, B) criterion incl. final
    gate_inputs: Optional[torch.Tensor] = None  # (E, B, H) (gating only)
    gated_logits: Optional[torch.Tensor] = None  # (E, B, K) classifier(gate input)
    lte_scores: Optional[torch.Tensor] = None  # (E_lte, B) sigmoid scores

    @property
    def num_exits(self) -> int:
        return self.exit_logits.shape[0]

    def policy_logits(self) -> torch.Tensor:
        """(E+1, B, K) logit store: gated logits when gating, else ramp
        logits, with the final classifier's logits last."""
        per_exit = self.gated_logits if self.gated_logits is not None else self.exit_logits
        return torch.cat([per_exit, self.logits[None]], dim=0)


def ee_forward(
    model: EEModel,
    cfg: EEModelConfig,
    input_ids: torch.Tensor,
    bbox: torch.Tensor,
    pixel_values: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    rng: Optional[torch.Generator] = None,
    seq_pad_multiple: Optional[int] = None,
) -> EEOutputs:
    """Every exit's logits and criterion from one batched forward, on the
    device of the model and inputs. With ``deterministic=False`` every
    dropout draws its seed from ``rng`` (a CPU generator)."""
    backbone_cfg, exit_cfg = cfg.backbone, cfg.exit
    rngs = RngStream(None if deterministic else rng)
    bb = backbone_apply(
        model.backbone, backbone_cfg, input_ids, bbox, pixel_values,
        attention_mask, deterministic=deterministic, rng=rng,
        collect_cls=bool(exit_cfg.encoder_exits),
        seq_pad_multiple=seq_pad_multiple,
    )
    b = input_ids.shape[0]

    order = canonical_exit_order(exit_cfg)
    sources = {
        "vision_avg": bb.visual_embeddings,
        "text_avg": bb.text_embeddings,
        "text_visual_concat": bb.combined_embeddings,
    }
    exit_inputs = [sources[name].mean(dim=1) for name in order if isinstance(name, str)]
    n_emb = len(exit_inputs)
    exit_logit_list = [
        exit_head_apply(model.embedding_exits[name], backbone_cfg, x, deterministic, rngs)
        for name, x in zip(order[:n_emb], exit_inputs)
    ]
    for head, layer in zip(model.encoder_exits or (), exit_cfg.encoder_exits):
        cls_state = bb.cls_per_layer[layer - 1]
        exit_inputs.append(cls_state)
        exit_logit_list.append(
            exit_head_apply(head, backbone_cfg, cls_state, deterministic, rngs)
        )

    final_logits = classifier_apply(
        model.backbone.classifier, backbone_cfg, bb.last_hidden_state[:, 0, :],
        deterministic, rngs,
    )
    exit_logits = (
        torch.stack(exit_logit_list)
        if exit_logit_list
        else final_logits.new_zeros((0, b, backbone_cfg.num_labels))
    )

    gate_inputs = gated_logits = None
    if exit_cfg.apply_gating and exit_inputs:
        gate_inputs = torch.stack(exit_inputs)  # (E, B, H)
        gated_logits = classifier_apply(
            model.backbone.classifier, backbone_cfg, gate_inputs
        )

    lte_scores = None
    if exit_cfg.use_lte and model.lte is not None:
        # LTE scores at the concat embedding exit and at every encoder exit
        lte_inputs = [
            x for name, x in zip(order[:n_emb], exit_inputs)
            if name == "text_visual_concat"
        ] + exit_inputs[n_emb:]
        if lte_inputs:
            lte_scores = lte_head_apply(model.lte, torch.stack(lte_inputs))

    crit_fn = exit_cfg.inference_strategy.get_function()
    if exit_cfg.inference_strategy == EarlyExitInference.PATIENCE:
        per_exit = gated_logits if gated_logits is not None else exit_logits
        exit_criteria = crit_fn(torch.cat([per_exit, final_logits[None]], dim=0))
    elif exit_cfg.inference_strategy == EarlyExitInference.LTE and lte_scores is not None:
        pad = exit_logits.shape[0] - lte_scores.shape[0]
        inf = torch.full((pad, b), float("inf"), device=lte_scores.device)
        exit_criteria = torch.cat(
            [inf, lte_scores.float(), torch.zeros((1, b), device=lte_scores.device)]
        )
    else:
        crit_exits = (
            crit_fn(exit_logits)
            if exit_logits.shape[0]
            else torch.zeros((0, b), device=final_logits.device)
        )
        exit_criteria = torch.cat([crit_exits, crit_fn(final_logits)[None]], dim=0)

    return EEOutputs(
        logits=final_logits,
        exit_logits=exit_logits,
        exit_criteria=exit_criteria,
        gate_inputs=gate_inputs,
        gated_logits=gated_logits,
        lte_scores=lte_scores,
    )


def decide_exits(
    outputs: EEOutputs, exit_cfg: ExitConfig, threshold=None
) -> torch.Tensor:
    """Per-sample exit decision: the first exit whose criterion clears the
    threshold, else the final classifier (index E). ``threshold`` is one
    value or, as the cascade takes it, one per exit (length E)."""
    thr = exit_cfg.global_threshold if threshold is None else threshold
    sign = exit_cfg.inference_strategy.get_sign()
    crit = outputs.exit_criteria
    if not isinstance(thr, (int, float)):
        per_exit = torch.as_tensor(thr, dtype=crit.dtype, device=crit.device)
        thr = torch.cat([per_exit, per_exit.new_zeros(1)])[:, None]
    passed = sign(crit, thr)
    passed[-1] = True  # the final classifier always exits
    # first True along the exits: argmax of an int tensor returns the first max
    return passed.to(torch.int32).argmax(dim=0)
