"""The early-exit model: parameters, batched forward, decisions.

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

What differs between backbone families comes from the family's stages
object, which ``backbone_stages`` picks from the backbone config:
LayoutLMv3's (``models.layoutlmv3.modeling.LayoutLMv3Stages``) or
Moonlight's (``models.moonlight.modeling.CascadeStages``: text alone,
encoder exits only, each head on the last real token through a norm of its
own, the classifier on that token after the final norm) or Kimi-VL's
(``models.kimi_vl.modeling.KimiVLStages``: Moonlight's, each row's page
read by a vision tower into its placeholder positions; the page's patch
rows come as ``pixel_values`` and its patch grid as ``image_grid_hws``) or
Kimi-Linear's (``models.kimi_linear.modeling.KimiLinearStages``:
Moonlight's, each layer's token mixer KDA or MLA by its kind).
The exit heads, gating, LTE and the criteria are shared.

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
    LayoutLMv3Stages,
    Linear,
    RngStream,
)

# Forward order of the embedding exits: vision first, then text, then
# concat, whatever order the user listed them in.
EMBEDDING_FORWARD_ORDER = ("vision_avg", "text_avg", "text_visual_concat")


def canonical_exit_order(exit_cfg: ExitConfig) -> Tuple:
    """Exits in the order their logits appear in ``exit_logits``."""
    emb = tuple(e for e in EMBEDDING_FORWARD_ORDER if e in exit_cfg.embedding_exits)
    return emb + exit_cfg.encoder_exits


def backbone_stages(cfg):
    """The stages object of a backbone config: Kimi-VL's for a
    ``KimiVLConfig``, Kimi-Linear's for a ``KimiLinearConfig``, Moonlight's
    for a ``MoonlightConfig``, else LayoutLMv3's. The one place that tells
    the backbone families apart."""
    from multi_modal_early_exit_tpu_torch.models.kimi_linear.config import KimiLinearConfig
    from multi_modal_early_exit_tpu_torch.models.kimi_linear.modeling import KimiLinearStages
    from multi_modal_early_exit_tpu_torch.models.kimi_vl.config import KimiVLConfig
    from multi_modal_early_exit_tpu_torch.models.kimi_vl.modeling import KimiVLStages
    from multi_modal_early_exit_tpu_torch.models.moonlight.config import MoonlightConfig
    from multi_modal_early_exit_tpu_torch.models.moonlight.modeling import CascadeStages

    if isinstance(cfg, KimiVLConfig):
        return KimiVLStages(cfg)
    if isinstance(cfg, KimiLinearConfig):
        return KimiLinearStages(cfg)
    return CascadeStages(cfg) if isinstance(cfg, MoonlightConfig) else LayoutLMv3Stages(cfg)


def page_inputs(image_grid_hws: Optional[torch.Tensor]) -> dict:
    """The keyword a stages object takes for each row's patch grid: none
    unless given (a backbone that reads no pages takes none)."""
    return {} if image_grid_hws is None else {"image_grid_hws": image_grid_hws}


class EEModel(nn.Module):
    """Backbone + exit heads, uninitialised, on ``device`` (``cuda`` by
    default). ``encoder_exits[i]`` is the head of the i-th encoder exit;
    ``embedding_exits`` is keyed by exit name; ``lte`` exists with
    ``use_lte``. ``with_text``/``with_vision`` prune a LayoutLMv3
    backbone's towers (the dense ``dit`` and ``bert`` variants, which have
    no exits). The backbone module, the norm each head applies first and
    the exits a backbone refuses come from its stages object
    (``backbone_stages``)."""

    def __init__(self, cfg: EEModelConfig, device=None, with_text: bool = True,
                 with_vision: bool = True):
        super().__init__()
        device = resolve_device(device)
        backbone, exit_cfg = cfg.backbone, cfg.exit
        stages = backbone_stages(backbone)
        self.backbone = stages.backbone(exit_cfg, with_text=with_text, with_vision=with_vision)
        emb = {
            name: ExitHead(backbone, exit_cfg, stages.head_norm())
            for name in EMBEDDING_FORWARD_ORDER
            if name in exit_cfg.embedding_exits
        }
        self.embedding_exits = nn.ModuleDict(emb) if emb else None
        self.encoder_exits = (
            nn.ModuleList(ExitHead(backbone, exit_cfg, stages.head_norm())
                          for _ in exit_cfg.encoder_exits)
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
    ``with_text``/``with_vision`` as in ``EEModel``. Where they are
    allocated and drawn is the backbone's stages' choice (``init_model``):
    a LayoutLMv3 model is drawn on the CPU and moved, a Moonlight model
    allocated on ``device`` and drawn there."""
    generator = generator or torch.Generator().manual_seed(0)
    return backbone_stages(cfg.backbone).init_model(
        lambda dev: EEModel(cfg, device=dev, with_text=with_text, with_vision=with_vision),
        generator, resolve_device(device), dtype)


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
    last_hidden_state: Optional[torch.Tensor] = None  # (B, S', H), collect_hidden only

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
    collect_hidden: bool = False,
    seq_pad_multiple: Optional[int] = None,
    image_grid_hws: Optional[torch.Tensor] = None,
) -> EEOutputs:
    """Every exit's logits and criterion from one batched forward, on the
    device of the model and inputs. With ``deterministic=False`` every
    dropout draws its seed from ``rng`` (a CPU generator).
    ``collect_hidden`` fills ``last_hidden_state`` with the encoder's output
    (at the padded width S' when ``seq_pad_multiple`` pads, pad rows
    included). ``image_grid_hws`` (B, 2), each row's patch grid, is for a
    backbone that reads pages (Kimi-VL)."""
    backbone_cfg, exit_cfg = cfg.backbone, cfg.exit
    stages = backbone_stages(backbone_cfg)
    b = input_ids.shape[0]
    order = canonical_exit_order(exit_cfg)
    exit_inputs, final_input, last_hidden = stages.forward(
        model, order, input_ids, bbox, pixel_values, attention_mask, deterministic, rng,
        collect_hidden, seq_pad_multiple, **page_inputs(image_grid_hws),
    )
    # dropout seeds after the backbone's: the heads' in exit order, then
    # the classifier's
    rngs = RngStream(None if deterministic else rng, getattr(model, "mesh", None))
    n_emb = sum(isinstance(e, str) for e in order)
    heads = [model.embedding_exits[name] for name in order[:n_emb]]
    heads += list(model.encoder_exits or ())
    exit_logit_list = [exit_head_apply(head, backbone_cfg, x, deterministic, rngs)
                       for head, x in zip(heads, exit_inputs)]
    final_logits = stages.classify(model, final_input, deterministic, rngs)
    exit_logits = (
        torch.stack(exit_logit_list)
        if exit_logit_list
        else final_logits.new_zeros((0, b, backbone_cfg.num_labels))
    )

    gate_inputs = gated_logits = None
    if exit_cfg.apply_gating and exit_inputs:
        gate_inputs = torch.stack(exit_inputs)  # (E, B, H)
        gated_logits = stages.classify(model, gate_inputs)

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
        last_hidden_state=last_hidden if collect_hidden else None,
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
