"""EE trainer: AdamW with a linear schedule, gradient accumulation over
micro-batches, entropyreg and two-stage freezing. The counterpart of the JAX
package's ``training/trainer.py`` (optax + jit there, eager PyTorch here).

- the per-exit backward loop of the reference is one backward of the
  strategy-combined loss (``losses.ee_loss_fn``);
- entropyreg scales the exit branches' gradients (``apply_entropyreg``);
- two-stage freezing leaves every parameter whose name lacks
  ``exit``/``classifier`` (and is not ``lte``) out of the optimizer: no
  update, no weight decay, and no share in the clipping norm;
- gradient clipping is optax's ``clip_by_global_norm``: scale by
  max_norm / norm when the norm exceeds max_norm (``clip_grad_norm_`` adds
  1e-6 to the norm, optax does not).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from multi_modal_early_exit_tpu_torch.device import resolve_device
from multi_modal_early_exit_tpu_torch.models.ee.model import EEModel
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import EEModelConfig
from multi_modal_early_exit_tpu_torch.ops.criteria import entropy as entropy_fn
from multi_modal_early_exit_tpu_torch.training.losses import batch_to_device, ee_loss_fn
from multi_modal_early_exit_tpu_torch.training.subgraphs import (
    apply_entropyreg,
    exit_loss_weights,
    subgraph_param_counts,
)


@dataclasses.dataclass
class TrainingArguments:
    """The JAX package's training knobs that the train step reads (the batch
    size is the batch's own; the exit loss's gamma is ``cfg.exit.gamma``)."""

    learning_rate: float = 2e-5
    gradient_accumulation_steps: int = 1
    weight_decay: float = 0.0
    warmup_ratio: float = 0.0
    max_grad_norm: float = 0.0  # 0 disables clipping
    bf16: bool = False  # mixed precision: bf16 forward, f32 master params
    bf16_momentum: bool = False  # bf16 Adam first moment: not in the port


def _is_trainable_two_stage(name: str) -> bool:
    """Second-stage trainables: exit heads, classifier, LTE head."""
    return "exit" in name or "classifier" in name or name.startswith("lte")


def linear_schedule(args: TrainingArguments, total_steps: int) -> Callable[[int], float]:
    """The learning rate at a step: linear warmup over
    ``int(total_steps * warmup_ratio)`` steps, then linear decay to 0 at
    ``total_steps``; with no warmup the full rate at step 0."""
    warmup = int(total_steps * args.warmup_ratio)
    lr = args.learning_rate

    def schedule(step: int) -> float:
        if warmup > 0 and step < warmup:
            return lr * step / warmup
        decay = max(total_steps - warmup, 1)
        return lr * (1.0 - min(max(step - warmup, 0), decay) / decay)

    return schedule


@dataclasses.dataclass
class Optimizer:
    """AdamW over the trainable parameters, its schedule and clipping."""

    adamw: torch.optim.AdamW
    params: Dict[str, torch.nn.Parameter]  # the trainable ones, by name
    schedule: Callable[[int], float]
    max_grad_norm: float
    step: int = 0

    def apply(self, grads: Dict[str, torch.Tensor]) -> None:
        """One update from ``grads`` (by name; only trainable names are read)."""
        gs = [grads[n] for n in self.params]
        if self.max_grad_norm > 0:
            norm = torch.sqrt(sum(g.to(torch.float32).square().sum() for g in gs))
            gs = [torch.where(norm < self.max_grad_norm, g, g / norm * self.max_grad_norm)
                  for g in gs]
        for p, g in zip(self.params.values(), gs):
            p.grad = g.to(p.dtype)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.step)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.step += 1


def make_optimizer(
    model: EEModel,
    args: TrainingArguments,
    total_steps: int,
    freeze_backbone: bool = False,
) -> Optimizer:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay) with the
    linear schedule; ``freeze_backbone`` leaves out every parameter that is
    not a second-stage trainable."""
    if args.bf16_momentum:
        raise NotImplementedError(
            "bf16_momentum (a bf16 Adam first moment) has no torch.optim "
            "counterpart in the port yet"
        )
    params = {
        n: p for n, p in model.named_parameters()
        if not freeze_backbone or _is_trainable_two_stage(n)
    }
    adamw = torch.optim.AdamW(
        list(params.values()), lr=args.learning_rate, betas=(0.9, 0.999),
        eps=1e-8, weight_decay=args.weight_decay,
    )
    return Optimizer(adamw, params, linear_schedule(args, total_steps), args.max_grad_norm)


def make_train_step(
    cfg: EEModelConfig,
    optimizer: Optimizer,
    exit_weights: Optional[torch.Tensor],
    accum_steps: int = 1,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
) -> Callable:
    """The train step ``step(model, batch, rng) -> (loss, aux)``.

    Each array of ``batch`` is (accum_steps, micro_bs, ...). Every
    micro-batch's gradients (entropyreg applied) are summed, divided by
    ``accum_steps`` and applied once; the loss is the micro-batch mean and
    ``aux`` the last micro-batch's."""
    device = resolve_device(device)
    use_entropyreg = cfg.exit.training_strategy.uses_entropyreg

    def loss_and_grads(model, micro, rng):
        loss, aux = ee_loss_fn(
            model, cfg, micro, rng=rng, exit_weights=exit_weights,
            compute_dtype=compute_dtype, device=device,
        )
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        gs = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named, gs)}
        if use_entropyreg:
            with torch.no_grad():
                crit = torch.cat([
                    torch.stack([entropy_fn(lg).mean() for lg in aux["exit_logits"]])
                    if aux["exit_logits"].shape[0] else aux["logits"].new_zeros((0,)),
                    entropy_fn(aux["logits"]).mean()[None],
                ])
                norm = torch.softmax(crit, dim=0) * crit.shape[0]
                grads = apply_entropyreg(grads, cfg, 1.0 - torch.clamp(norm, max=1.0))
        return loss.detach(), {k: v.detach() if isinstance(v, torch.Tensor) else v
                               for k, v in aux.items()}, grads

    def train_step(model: EEModel, batch: Dict[str, Any], rng: Optional[torch.Generator]):
        batch = batch_to_device(batch, device)
        total, grads = None, None
        for i in range(accum_steps):
            micro = {k: v[i] for k, v in batch.items()}
            loss, aux, g = loss_and_grads(model, micro, rng)
            total = loss if total is None else total + loss
            grads = g if grads is None else {n: grads[n] + g[n] for n in grads}
        if accum_steps > 1:
            grads = {n: g / accum_steps for n, g in grads.items()}
        with torch.no_grad():
            optimizer.apply(grads)
        return total / accum_steps, aux

    return train_step


class EETrainer:
    """Train and evaluate an ``EEModel`` over batches of numpy arrays or
    tensors, on ``device`` (``cuda`` unless the caller passes ``"cpu"``;
    the model is moved there). ``train_step`` takes one (accum, micro_bs,
    ...) batch and a CPU ``torch.Generator`` for the dropout seeds."""

    def __init__(
        self,
        cfg: EEModelConfig,
        model: EEModel,
        args: TrainingArguments,
        total_steps: int,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg, self.args = cfg, args
        self.model = model.to(self.device)
        strategy = cfg.exit.training_strategy
        self.exit_weights = (
            exit_loss_weights(subgraph_param_counts(model, cfg)).to(self.device)
            if strategy.is_weighted else None
        )
        self.optimizer = make_optimizer(
            model, args, total_steps, freeze_backbone=strategy.is_two_stage
        )
        self._step_fn = make_train_step(
            cfg, self.optimizer, self.exit_weights, args.gradient_accumulation_steps,
            compute_dtype=torch.bfloat16 if args.bf16 else None, device=self.device,
        )
        self.step = 0

    def train_step(self, batch: Dict[str, Any], rng: Optional[torch.Generator]) -> Tuple[float, Dict]:
        """batch arrays shaped (accum, micro_bs, ...)."""
        loss, aux = self._step_fn(self.model, batch, rng)
        self.step += 1
        return float(loss), aux

    @torch.no_grad()
    def evaluate(self, batches: Iterable[Dict[str, Any]]) -> Dict[str, float]:
        """Final and per-exit accuracy, and each exit's share of the batch
        under the max-softmax policy at the config's global threshold. The
        forward runs in the training's compute dtype (bf16 with ``bf16``,
        which the CUDA kernels need)."""
        thr = float(self.cfg.exit.global_threshold)
        dtype = torch.bfloat16 if self.args.bf16 else torch.float32
        params = {n: p.to(dtype) for n, p in self.model.named_parameters()}
        correct, total = 0, 0
        exit_correct: Optional[np.ndarray] = None
        exit_counts: Optional[np.ndarray] = None
        for batch in batches:
            b = batch_to_device(batch, self.device)
            out = functional_call(self.model, params, (
                self.cfg, b["input_ids"], b["bbox"], b["pixel_values"].to(dtype),
                b.get("attention_mask"),
            ))
            store = out.policy_logits().to(torch.float64).cpu().numpy()
            labels = b["labels"].cpu().numpy()
            preds = store.argmax(-1)
            if exit_correct is None:
                exit_correct = np.zeros(store.shape[0])
                exit_counts = np.zeros(store.shape[0], np.int64)
            exit_correct += (preds == labels[None]).sum(-1)
            correct += int((preds[-1] == labels).sum())
            total += len(labels)
            e = np.exp(store - store.max(-1, keepdims=True))
            passed = (e / e.sum(-1, keepdims=True)).max(-1) > thr
            passed[-1] = True
            exit_counts += np.bincount(passed.argmax(0), minlength=store.shape[0])
        results = {"accuracy": correct / max(total, 1)}
        for j in range(len(exit_correct) - 1):
            results[f"exit_{j}_accuracy"] = exit_correct[j] / max(total, 1)
        for j in range(len(exit_counts)):
            results[f"exit_{j}_share"] = exit_counts[j] / max(total, 1)
        return results
