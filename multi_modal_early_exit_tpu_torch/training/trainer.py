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
  1e-6 to the norm, optax does not);
- ``bf16_momentum`` stores Adam's first moment in bf16 (``AdamWBf16Mu``,
  optax's ``adamw(mu_dtype=bfloat16)``); the second moment and the master
  weights stay f32;
- a dense config without ``.exit`` (``LayoutLMv2Config``) trains with its
  cross-entropy (``layoutlmv2.modeling.sequence_classification_loss``), and
  ``evaluate`` reads a single-row (1, B, K) store;
- under a ``parallel.mesh.Mesh`` (``EETrainer(..., mesh=...)``) each rank
  computes on its rows and its parameter shards, and the step does by hand
  what the JAX package's GSPMD step does: it averages every gradient over
  the data group, sums the three relative-position tables' gradients over
  the model group (each model rank reaches only its heads' columns), takes
  the entropyreg statistics and the clipping norm over the whole mesh, and
  weights the exits by the unsharded parameter counts. At dropout rate 0 a
  step under any mesh is the single-device step, to reduction order.
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
from multi_modal_early_exit_tpu_torch.models.registry import refuse_ee_trainer
from multi_modal_early_exit_tpu_torch.ops.criteria import entropy as entropy_fn
from multi_modal_early_exit_tpu_torch.parallel.layers import (
    all_reduce,
    all_reduce_many,
    broadcast_many,
)
from multi_modal_early_exit_tpu_torch.parallel.sharding import _spec_for, full_numels, shard_model
from multi_modal_early_exit_tpu_torch.training.losses import batch_to_device, ee_loss_fn
from multi_modal_early_exit_tpu_torch.training.subgraphs import (
    BIAS_TABLES,
    apply_entropyreg,
    exit_loss_weights,
    subgraph_param_counts,
)


@dataclasses.dataclass
class TrainingArguments:
    """The JAX package's training arguments, its fields in its order with its
    defaults (the knobs of EETrainingArguments, EE_modules.py:288-298, and
    the HF TrainingArguments subset the reference uses, IC_only.py:144-168).
    As in the JAX package, the train step reads none of ``num_epochs``,
    ``train_batch_size``, ``eval_batch_size``, ``alpha``, ``temperature``,
    ``gamma``, ``seed`` and ``log_every``: the batch size is the batch's
    own, and the exit loss's gamma is ``cfg.exit.gamma``."""

    learning_rate: float = 2e-5
    num_epochs: int = 1
    train_batch_size: int = 2
    eval_batch_size: int = 8
    gradient_accumulation_steps: int = 1
    weight_decay: float = 0.0
    warmup_ratio: float = 0.0
    max_grad_norm: float = 0.0  # 0 disables clipping
    alpha: float = 1.0
    temperature: float = 1.0
    gamma: float = 0.0
    seed: int = 42
    log_every: int = 10
    bf16: bool = False  # mixed precision: bf16 forward, f32 master params
    bf16_momentum: bool = False  # Adam's first moment stored in bf16


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


class AdamWBf16Mu(torch.optim.Optimizer):
    """AdamW whose first moment is stored in bf16: optax's ``adamw(...,
    mu_dtype=jnp.bfloat16)`` step by step, in its order and types. With g
    the f32 gradient and t the step count after the increment:

        mu  = 0.1 g + f32(bf16(0.9) * mu_bf16)   (the product in bf16, as
                                                  XLA takes the weakly typed
                                                  b1 in mu's type)
        nu  = 0.001 g^2 + 0.999 nu                (f32)
        u   = (mu / (1 - 0.9^t)) / (sqrt(nu / (1 - 0.999^t)) + eps)
        u   = u + wd p;  p = p + (-lr) u
        mu_bf16 = bf16(mu)

    The second moment and the parameters stay in their (f32) type. Its
    state per parameter: ``step`` (an int64 tensor), ``exp_avg`` (bf16) and
    ``exp_avg_sq``."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    def load_state_dict(self, state_dict) -> None:
        """``torch.optim.Optimizer.load_state_dict``, which casts every
        moment to its parameter's type, then the first moments back to bf16
        (exact: they were bf16 when saved)."""
        super().load_state_dict(state_dict)
        for state in self.state.values():
            state["exp_avg"] = state["exp_avg"].to(torch.bfloat16)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.to(torch.float32)
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.int64)
                    state["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                state["step"] += 1
                t = int(state["step"])
                b1_mu = torch.tensor(b1, dtype=torch.bfloat16, device=p.device)
                mu = g * (1 - b1) + (state["exp_avg"] * b1_mu).to(torch.float32)
                nu = g * g * (1 - b2) + state["exp_avg_sq"] * b2
                f32 = dict(dtype=torch.float32, device=p.device)
                bc1 = 1 - torch.tensor(b1, **f32) ** t
                bc2 = 1 - torch.tensor(b2, **f32) ** t
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + group["eps"])
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                p.add_(torch.tensor(-group["lr"], **f32) * u)
                state["exp_avg"] = mu.to(torch.bfloat16)
                state["exp_avg_sq"] = nu
        return None


@dataclasses.dataclass
class Optimizer:
    """AdamW over the trainable parameters, its schedule and clipping. Under
    a ``mesh`` the parameters are this rank's shards and the clipping norm
    is the global one: the squares of the split parameters summed over the
    model group, the replicated ones counted once."""

    adamw: torch.optim.Optimizer
    params: Dict[str, torch.nn.Parameter]  # the trainable ones, by name
    schedule: Callable[[int], float]
    max_grad_norm: float
    step: int = 0
    mesh: Any = None

    def _global_norm(self, gs) -> torch.Tensor:
        squares = [g.to(torch.float32).square().sum() for g in gs]
        mesh = self.mesh
        if mesh is None or mesh.model_size == 1:
            return torch.sqrt(sum(squares))
        split = [_spec_for(n, p.ndim) is not None for n, p in self.params.items()]
        replicated = sum(s for s, sp in zip(squares, split) if not sp)
        sharded = all_reduce(sum(s for s, sp in zip(squares, split) if sp),
                             mesh.model_group, mesh.model_size)
        return torch.sqrt(replicated + sharded)

    def apply(self, grads: Dict[str, torch.Tensor]) -> None:
        """One update from ``grads`` (by name; only trainable names are read)."""
        gs = [grads[n] for n in self.params]
        if self.max_grad_norm > 0:
            norm = self._global_norm(gs)
            gs = [torch.where(norm < self.max_grad_norm, g, g / norm * self.max_grad_norm)
                  for g in gs]
        for p, g in zip(self.params.values(), gs):
            p.grad = g.to(p.dtype)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.step)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.step += 1

    def state_dict(self) -> Dict[str, Any]:
        """The moments and the schedule's step: tensors, ints and plain
        containers only (``torch.load(weights_only=True)`` reads them)."""
        return {"adamw": self.adamw.state_dict(), "step": self.step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.step = int(state["step"])


def make_optimizer(
    model: EEModel,
    args: TrainingArguments,
    total_steps: int,
    freeze_backbone: bool = False,
    mesh=None,
) -> Optimizer:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay) with the
    linear schedule, its first moment in bf16 with ``bf16_momentum``
    (``AdamWBf16Mu``); ``freeze_backbone`` leaves out every parameter that
    is not a second-stage trainable. ``mesh``: the model is sharded over
    it (the clipping norm spans the model group)."""
    params = {
        n: p for n, p in model.named_parameters()
        if not freeze_backbone or _is_trainable_two_stage(n)
    }
    adam = AdamWBf16Mu if args.bf16_momentum else torch.optim.AdamW
    adamw = adam(
        list(params.values()), lr=args.learning_rate, betas=(0.9, 0.999),
        eps=1e-8, weight_decay=args.weight_decay,
    )
    return Optimizer(adamw, params, linear_schedule(args, total_steps), args.max_grad_norm,
                     mesh=mesh)


def data_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``x`` over the data group (``x`` without one)."""
    if mesh is None or mesh.data_size == 1:
        return x
    return all_reduce(x, mesh.data_group, mesh.data_size) / mesh.data_size


def reduce_gradients(grads: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The mesh's gradient reductions (the gradients unchanged without
    one): every gradient averaged over the data group; then, over the model
    group, the relative-position tables' gradients summed (each rank holds
    only its heads' columns) and every other replicated gradient taken from
    the group's first rank, so the replicas stay bit-identical whatever
    order a device's own reductions take."""
    if mesh is None:
        return grads
    names = list(grads)
    vals = [grads[n] for n in names]
    if mesh.data_size > 1:
        vals = [v / mesh.data_size
                for v in all_reduce_many(vals, mesh.data_group, mesh.data_size)]
    if mesh.model_size > 1:
        tables = [i for i, n in enumerate(names) if n.rsplit(".", 1)[-1] in BIAS_TABLES]
        for i, v in zip(tables, all_reduce_many([vals[i] for i in tables], mesh.model_group,
                                                mesh.model_size)):
            vals[i] = v
        replicated = [i for i, n in enumerate(names)
                      if _spec_for(n, vals[i].ndim) is None and i not in tables]
        first = mesh.data_index * mesh.model_size  # the model group's first rank
        for i, v in zip(replicated, broadcast_many([vals[i] for i in replicated], first,
                                                   mesh.model_group)):
            vals[i] = v
    return dict(zip(names, vals))


def make_train_step(
    cfg: EEModelConfig,
    optimizer: Optimizer,
    exit_weights: Optional[torch.Tensor],
    accum_steps: int = 1,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
    loss_fn: Optional[Callable] = None,
    mesh=None,
) -> Callable:
    """The train step ``step(model, batch, rng) -> (loss, aux)``.

    Each array of ``batch`` is (accum_steps, micro_bs, ...). Every
    micro-batch's gradients (entropyreg applied) are summed, divided by
    ``accum_steps`` and applied once; the loss is the micro-batch mean and
    ``aux`` the last micro-batch's. ``loss_fn`` (``ee_loss_fn`` by default,
    the same signature) lets a dense baseline train through the same step.

    Under a ``mesh`` the model is sharded over it and ``batch`` holds this
    rank's rows (``parallel.sharding.shard_batch(..., axis=1)``): the
    entropyreg statistics are averaged over the data group before the
    softmax, the gradients reduced by ``reduce_gradients``, and the loss is
    the mean over the data group (the same on every rank)."""
    device = resolve_device(device)
    strategy = cfg.exit.training_strategy if hasattr(cfg, "exit") else None
    use_entropyreg = strategy is not None and strategy.uses_entropyreg
    loss_fn = loss_fn if loss_fn is not None else ee_loss_fn

    def loss_and_grads(model, micro, rng):
        loss, aux = loss_fn(
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
                crit = data_mean(crit, mesh)
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
            grads = reduce_gradients(grads, mesh)
            optimizer.apply(grads)
            loss = data_mean(total / accum_steps, mesh)
        return loss, aux

    return train_step


class EETrainer:
    """Train and evaluate an ``EEModel`` (or, for a config without
    ``.exit``, a dense ``LayoutLMv2Model``) over batches of numpy arrays or
    tensors, on ``device`` (``cuda`` unless the caller passes ``"cpu"``;
    the model is moved there). ``train_step`` takes one (accum, micro_bs,
    ...) batch and a CPU ``torch.Generator`` for the dropout seeds.

    With a ``mesh`` (``parallel.mesh.create_mesh``) the model is sharded
    over it (``parallel.sharding.shard_model``, unless it already is) and
    ``train_step`` takes this rank's rows; every rank passes a generator in
    the same state. ``evaluate`` runs every batch whole on every rank.

    A model ``models.registry.build_model`` made for ``dit``, ``dit_rvl`` or
    ``bert`` raises ``NotImplementedError`` naming it
    (``registry.trains_through_ee_trainer``)."""

    def __init__(
        self,
        cfg: EEModelConfig,
        model: EEModel,
        args: TrainingArguments,
        total_steps: int,
        device=None,
        mesh=None,
    ):
        # a model build_model made carries its name: refuse, before any
        # step, the variants whose loss cannot run (ROADMAP.md C12)
        if getattr(model, "model_name", None) is not None:
            refuse_ee_trainer(model.model_name)
        self.device = resolve_device(device)
        self.cfg, self.args, self.mesh = cfg, args, mesh
        if mesh is not None and getattr(model, "mesh", None) is None:
            heads = getattr(getattr(cfg, "backbone", cfg), "num_attention_heads", None)
            model = shard_model(model, mesh, heads)
        self.model = model.to(self.device)
        # dense configs (LayoutLMv2Config) carry no .exit: a plain CE
        # objective through the same step (the reference trains dense
        # AutoModels through its generic trainer, EE/IC_only.py:176-178)
        self.is_ee = hasattr(cfg, "exit")
        strategy = cfg.exit.training_strategy if self.is_ee else None
        loss_fn = None
        if not self.is_ee:
            from multi_modal_early_exit_tpu_torch.models.layoutlmv2.modeling import (
                sequence_classification_loss as loss_fn,
            )
        # the weights of the unsharded model's parameter counts
        self.exit_weights = (
            exit_loss_weights(subgraph_param_counts(
                model, cfg, numel=full_numels(self.model, mesh))).to(self.device)
            if strategy is not None and strategy.is_weighted else None
        )
        self.optimizer = make_optimizer(
            model, args, total_steps,
            freeze_backbone=strategy is not None and strategy.is_two_stage, mesh=mesh,
        )
        self._step_fn = make_train_step(
            cfg, self.optimizer, self.exit_weights, args.gradient_accumulation_steps,
            compute_dtype=torch.bfloat16 if args.bf16 else None, device=self.device,
            loss_fn=loss_fn, mesh=mesh,
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
        which the CUDA kernels need). A dense model's store is its logits
        alone, (1, B, K)."""
        thr = float(self.cfg.exit.global_threshold) if self.is_ee else 1.0
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
            logits = out.policy_logits() if self.is_ee else out.logits[None]
            store = logits.to(torch.float64).cpu().numpy()
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
