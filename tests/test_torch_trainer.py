"""PyTorch port, the training slice as a whole against the JAX package:
``EETrainer`` steps (AdamW, the linear schedule, global-norm clipping,
gradient accumulation, two-stage freezing) on the tiny config, f32, every
dropout rate 0, the same batches on both sides; the train step's entropyreg
scaling through SGD; and the pieces of the optimizer against optax."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from _torch_parity import jax_params, no_dropout, port_model, tiny_configs, train_batch
from multi_modal_early_exit_tpu.training import trainer as JT
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.convert import jax_tree_to_state_dict
from multi_modal_early_exit_tpu_torch.training import subgraphs as TS
from multi_modal_early_exit_tpu_torch.training import trainer as TT

torch.set_num_threads(2)

STEPS, S = 3, 12

CASES = {
    # accumulation over 2 micro-batches, warmup, clipping and weight decay
    "one_stage_weighted": dict(
        exit=dict(exits=("text_avg", "vision_avg", 1),
                  training_strategy="one_stage_subgraphs_weighted", gamma=0.4),
        args=dict(gradient_accumulation_steps=2, warmup_ratio=0.34, max_grad_norm=0.5,
                  weight_decay=0.01),
    ),
    "two_stage_gate": dict(
        exit=dict(exits=("text_avg", 1), encoder_layer_strategy="gate",
                  training_strategy="two_stage_subgraphs_weighted"),
        args=dict(gradient_accumulation_steps=1, weight_decay=0.01),
    ),
}

LR = 1e-3


def _batches(jcfg, accum, micro=2):
    """STEPS batches, each array shaped (accum, micro, ...)."""
    out = []
    for step in range(STEPS):
        micros = [train_batch(100 * step + i, micro, S, jcfg, masked_tail=2)
                  for i in range(accum)]
        out.append({k: np.stack([m[k] for m in micros]) for k in micros[0]})
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_steps_match_jax(case):
    """Three ``EETrainer.train_step``s: the loss of each step to 1e-5 and
    the final parameters to 2e-4 of each tensor's largest value, plus 1e-3
    lr: where a gradient is f32 rounding noise (the key biases, whose true
    gradient is zero), Adam scales it up towards steps of lr in either
    package. Under two-stage freezing the backbone does not move at all."""
    spec = CASES[case]
    jcfg, tcfg = no_dropout(*tiny_configs(**spec["exit"]))
    params, tree = jax_params(jcfg)
    model = port_model(tcfg, tree)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    args = dict(learning_rate=LR, **spec["args"])
    batches = _batches(jcfg, args["gradient_accumulation_steps"])

    jtrainer = JT.EETrainer(jcfg, params, JT.TrainingArguments(**args), total_steps=STEPS)
    ttrainer = TT.EETrainer(tcfg, model, TT.TrainingArguments(**args), total_steps=STEPS,
                            device="cpu")
    key, gen = jax.random.key(1), torch.Generator().manual_seed(1)
    for step, batch in enumerate(batches):
        want = jtrainer.train_step({k: jnp.asarray(v) for k, v in batch.items()}, key)[0]
        got = ttrainer.train_step(batch, gen)[0]
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"loss of step {step}")

    final = {n: p.detach() for n, p in model.named_parameters()}
    want = jax_tree_to_state_dict(jax.tree.map(np.asarray, jtrainer.params))
    assert final.keys() == want.keys()
    for n, a in final.items():
        w = want[n]
        np.testing.assert_allclose(a.numpy(), w, atol=2e-4 * np.abs(w).max() + 1e-3 * LR,
                                   rtol=2e-4, err_msg=f"{case} {n}")
    moved = {n for n in final if not torch.equal(final[n], before[n])}
    if tcfg.exit.training_strategy.is_two_stage:
        assert moved == {n for n in final if TT._is_trainable_two_stage(n)}
    else:
        assert moved == set(final)


def test_entropyreg_train_step_matches_jax():
    """The train step's entropyreg branch scaling, through SGD at lr 1 on
    both sides (optax.sgd there), so that the parameter change is the
    scaled gradient: to 2e-4 of each tensor's largest value, 2e-3 for the
    exit branches (see below)."""
    jcfg, tcfg = no_dropout(*tiny_configs(
        exits=("text_avg", "vision_avg", 1), gamma=0.4,
        training_strategy="one_stage_subgraphs_weighted_entropyreg"))
    params, tree = jax_params(jcfg)
    model = port_model(tcfg, tree)
    batch = _batches(jcfg, 1)[0]
    j_weights = JT.exit_loss_weights(JT.subgraph_param_counts(params, jcfg))
    tx = optax.sgd(1.0)
    j_step = jax.jit(JT.make_train_step(jcfg, tx, j_weights, 1))
    new, _, want_loss, _ = j_step(params, tx.init(params),
                                  {k: jnp.asarray(v) for k, v in batch.items()},
                                  jax.random.key(1))
    want = jax_tree_to_state_dict(jax.tree.map(lambda a, b: np.asarray(a - b), params, new))

    t_params = dict(model.named_parameters())
    opt = TT.Optimizer(torch.optim.SGD(list(t_params.values()), lr=1.0), t_params,
                       lambda step: 1.0, 0.0)
    t_weights = torch.tensor(np.asarray(j_weights))
    before = {n: p.detach().clone() for n, p in t_params.items()}
    step = TT.make_train_step(tcfg, opt, t_weights, 1, device="cpu")
    loss, _ = step(model, batch, torch.Generator().manual_seed(1))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    branches = tuple(TS.exit_branch_scales(tcfg, torch.zeros(4)))
    for n, p in t_params.items():
        w = want[n]
        got = (before[n] - p.detach()).numpy()
        # A branch's factor 1 - min(norm, 1) is a difference of nearly equal
        # f32 numbers at random init (norm near 1), good to about 1e-3 of
        # itself: 2e-3 there. Plus 2 f32 ulps of the largest parameter (the
        # change is read off the parameters, whose f32 spacing quantizes it
        # on both sides) and 1e-9 for the key biases, whose true gradient is
        # zero.
        tol = 2e-3 if n.startswith(branches) else 2e-4
        ulp = np.spacing(np.float32(before[n].abs().max()))
        np.testing.assert_allclose(got, w, atol=tol * np.abs(w).max() + 2 * ulp + 1e-9,
                                   rtol=tol, err_msg=n)


@pytest.mark.parametrize("warmup_ratio", [0.0, 0.25])
def test_linear_schedule_matches_optax(warmup_ratio):
    args = TT.TrainingArguments(learning_rate=3e-4, warmup_ratio=warmup_ratio)
    total = 20
    mine = TT.linear_schedule(args, total)
    warmup = int(total * warmup_ratio)
    if warmup:
        ref = optax.join_schedules(
            [optax.linear_schedule(0.0, 3e-4, warmup),
             optax.linear_schedule(3e-4, 0.0, total - warmup)], [warmup])
    else:
        ref = optax.linear_schedule(3e-4, 0.0, total)
    for step in range(total + 3):
        np.testing.assert_allclose(mine(step), float(ref(step)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("max_norm", [0.1, 100.0])
def test_clipping_matches_optax(max_norm):
    """The optimizer's clipping is optax's ``clip_by_global_norm`` (no 1e-6
    on the norm, as ``clip_grad_norm_`` adds): one SGD step at lr 1 through
    the optimizer's gradient hand-off moves each parameter by minus the
    clipped gradient."""
    rng = np.random.default_rng(0)
    grads = {"a": rng.standard_normal((3, 4)).astype(np.float32),
             "b": rng.standard_normal(5).astype(np.float32)}
    want, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, None)
    params = {k: torch.nn.Parameter(torch.zeros(v.shape)) for k, v in grads.items()}
    opt = TT.Optimizer(torch.optim.SGD(list(params.values()), lr=1.0), params,
                       lambda step: 1.0, max_norm)
    opt.apply({k: torch.from_numpy(v) for k, v in grads.items()})
    for k, p in params.items():
        np.testing.assert_allclose(-p.detach().numpy(), np.asarray(want[k]), rtol=1e-6)


def test_evaluate_matches_jax():
    jcfg, tcfg = tiny_configs(exits=("text_avg", "vision_avg", 1), global_threshold=0.3)
    params, tree = jax_params(jcfg)
    model = port_model(tcfg, tree)
    batches = [train_batch(7 + i, 4, S, jcfg, masked_tail=3) for i in range(2)]
    args = dict(learning_rate=LR)
    want = JT.EETrainer(jcfg, params, JT.TrainingArguments(**args), 1).evaluate(
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches])
    got = TT.EETrainer(tcfg, model, TT.TrainingArguments(**args), 1, device="cpu").evaluate(batches)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), abs=1e-12), k


def test_trainer_refuses_what_the_port_lacks():
    """No card: an entry point that is not asked for the CPU raises.
    ``bf16_momentum``, once refused here, builds its bf16-moment AdamW
    (tests/test_torch_checkpoint.py holds it against optax)."""
    jcfg, tcfg = tiny_configs(exits=("text_avg", 1))
    _, tree = jax_params(jcfg)
    model = port_model(tcfg, tree)
    trainer = TT.EETrainer(tcfg, model, TT.TrainingArguments(bf16_momentum=True), 1,
                           device="cpu")
    assert isinstance(trainer.optimizer.adamw, TT.AdamWBf16Mu)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TT.EETrainer(tcfg, model, TT.TrainingArguments(bf16=True), 1)
