"""Early-exit losses and training-strategy combination, as one differentiable
objective: the counterpart of the JAX package's ``training/losses.py``.

- ramp: per-exit cross-entropy on exit logits;
- gate: per-exit BCE-with-logits whose 2-class target is "was the final
  classifier, applied to this exit's input, correct?";
- lte: cumulative losses: exit j's loss is the sum of the CE losses of exits
  0..j, plus the final CE, plus MSE(lte_score_j, 1 - correctness_j);
- strategies: ``joint_weighted_avg`` sums every loss; the
  ``one_stage_subgraphs*`` family is the weighted sum
  Σ_j w_j γ/E · exit_loss_j + (1 - γ) · final_loss; entropyreg scales the
  exit branches' gradients afterwards (``subgraphs.apply_entropyreg``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from multi_modal_early_exit_tpu_torch.config.exit_config import EarlyExitStrategy, ExitConfig
from multi_modal_early_exit_tpu_torch.device import resolve_device
from multi_modal_early_exit_tpu_torch.models.ee.model import (
    EEModel,
    EEOutputs,
    canonical_exit_order,
    ee_forward,
)
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import EEModelConfig

SEQ_PAD_MULTIPLE = 128  # the training forward pads the sequence once to this


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch, in f32."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean element-wise binary CE with logits, in f32."""
    x = logits.to(torch.float32)
    return (torch.clamp(x, min=0) - x * targets + torch.log1p(torch.exp(-x.abs()))).mean()


def exit_losses_from_outputs(
    outputs: EEOutputs, cfg: EEModelConfig, labels: torch.Tensor
) -> torch.Tensor:
    """Per-exit loss vector (E,) according to the head strategy."""
    exit_cfg = cfg.exit
    if outputs.num_exits == 0:
        return torch.zeros((0,), device=labels.device)
    if exit_cfg.apply_gating:
        correct = outputs.gated_logits.argmax(dim=-1) == labels[None, :]
        targets = F.one_hot(correct.long(), 2).to(torch.float32)  # (E, B, 2)
        return torch.stack([
            bce_with_logits(lg, t) for lg, t in zip(outputs.exit_logits, targets)
        ])
    if exit_cfg.use_lte and outputs.lte_scores is not None:
        return _lte_losses(outputs, cfg, labels)
    return torch.stack([cross_entropy(lg, labels) for lg in outputs.exit_logits])


def _lte_losses(outputs: EEOutputs, cfg: EEModelConfig, labels: torch.Tensor) -> torch.Tensor:
    """Cumulative LTE losses; the MSE term only for exits that have an LTE
    score (the concat embedding exit and the encoder exits). The last exit
    is judged by the final classifier's prediction."""
    num_exits = outputs.num_exits
    inter = torch.stack([cross_entropy(lg, labels) for lg in outputs.exit_logits])
    final_loss = cross_entropy(outputs.logits, labels)
    order = canonical_exit_order(cfg.exit)
    lte_exit_ids = [
        i for i, name in enumerate(order)
        if isinstance(name, int) or name == "text_visual_concat"
    ]
    cum = torch.cumsum(inter, dim=0)
    losses = []
    lte_ptr = 0
    for j in range(num_exits):
        loss_j = cum[j] + final_loss
        if j in lte_exit_ids:
            layer_logits = outputs.logits if j == num_exits - 1 else outputs.exit_logits[j]
            correct = (layer_logits.argmax(dim=-1) == labels).to(torch.float32)
            loss_j = loss_j + (outputs.lte_scores[lte_ptr] - (1.0 - correct)).square().mean()
            lte_ptr += 1
        losses.append(loss_j)
    return torch.stack(losses)


def combine_losses(
    final_loss: torch.Tensor,
    exit_losses: torch.Tensor,
    exit_cfg: ExitConfig,
    exit_weights: Optional[torch.Tensor] = None,
    gamma: Optional[float] = None,
) -> torch.Tensor:
    """Combine the final and exit losses by the training strategy."""
    strategy = exit_cfg.training_strategy
    gamma = exit_cfg.gamma if gamma is None else gamma
    num_exits = exit_losses.shape[0]
    if strategy in (EarlyExitStrategy.JOINT_W_AVG, EarlyExitStrategy.JOINT):
        return final_loss + exit_losses.sum()
    if "subgraphs" in strategy.value:
        scaled = exit_losses
        if strategy.is_weighted and exit_weights is not None:
            scaled = scaled * exit_weights.to(scaled.device)
        if gamma != 0 and num_exits > 0:
            scaled = scaled * (gamma / num_exits)
            final_loss = final_loss * (1.0 - gamma)
        return final_loss + scaled.sum()
    # raw / two-stage / alternating / layerwise: the final CE; the stage
    # structure is the trainer's parameter freezing
    return final_loss


def batch_to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy arrays or tensors onto ``device``."""
    return {
        k: (torch.from_numpy(np.asarray(v)) if not isinstance(v, torch.Tensor) else v).to(device)
        for k, v in batch.items() if v is not None
    }


def ee_loss_fn(
    model: EEModel,
    cfg: EEModelConfig,
    batch: Dict[str, Any],
    rng: Optional[torch.Generator] = None,
    exit_weights: Optional[torch.Tensor] = None,
    deterministic: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The full EE objective: ``(total_loss, aux)``, differentiable in the
    model's parameters.

    Runs on ``device`` (``cuda`` unless the caller passes ``"cpu"``), where
    the model must live; the batch (numpy arrays or tensors) is moved there.
    ``compute_dtype=torch.bfloat16`` is mixed precision: the floating
    parameters and ``pixel_values`` are cast inside the differentiated
    function (``torch.func.functional_call`` on bf16 copies), so the forward
    runs in bf16 and the gradients come back in the parameters' f32. The
    sequence is padded once to a multiple of 128, as the JAX kernel path
    does; the losses are computed in f32.
    """
    device = resolve_device(device)
    param_device = next(model.parameters()).device
    if param_device.type != device.type or device.index not in (None, param_device.index):
        raise ValueError(f"the model lives on {param_device}, the loss runs on {device}")
    batch = batch_to_device(batch, device)
    pixel_values = batch["pixel_values"]
    args = (batch["input_ids"], batch["bbox"])
    kwargs = dict(attention_mask=batch.get("attention_mask"), deterministic=deterministic,
                  rng=rng, seq_pad_multiple=SEQ_PAD_MULTIPLE)
    if compute_dtype is not None:
        params = {
            name: p.to(compute_dtype) if p.is_floating_point() else p
            for name, p in model.named_parameters()
        }
        outputs = functional_call(
            model, params, (cfg, *args, pixel_values.to(compute_dtype)), kwargs
        )
    else:
        outputs = ee_forward(model, cfg, *args, pixel_values, **kwargs)
    labels = batch["labels"].long()
    final_loss = cross_entropy(outputs.logits, labels)
    exit_losses = exit_losses_from_outputs(outputs, cfg, labels)
    total = combine_losses(final_loss, exit_losses, cfg.exit, exit_weights)
    aux = {
        "final_loss": final_loss,
        "exit_losses": exit_losses,
        "logits": outputs.logits,
        "exit_logits": outputs.exit_logits,
        "gated_logits": outputs.gated_logits,
        "accuracy": (outputs.logits.argmax(dim=-1) == labels).to(torch.float32).mean(),
    }
    return total, aux
