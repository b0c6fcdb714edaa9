"""PyTorch port, the EE objective against the JAX package (tiny config, f32,
every dropout rate 0 so that the two training forwards compute the same
function): the per-exit losses of ramp, gate and LTE heads, the value and
gradients of ``ee_loss_fn`` under each kind of strategy, the subgraph
accounting, and one bf16 mixed-precision gradient check."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    assert_state_close,
    chained,
    jax_params,
    no_dropout,
    port_model,
    tiny_configs,
    train_batch,
)
from multi_modal_early_exit_tpu.models.ee.model import ee_forward as j_ee_forward
from multi_modal_early_exit_tpu.ops.criteria import entropy as j_entropy
from multi_modal_early_exit_tpu.training import losses as JL
from multi_modal_early_exit_tpu.training import subgraphs as JS
from multi_modal_early_exit_tpu_torch.models.ee.model import ee_forward
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.convert import jax_tree_to_state_dict
from multi_modal_early_exit_tpu_torch.ops.criteria import entropy
from multi_modal_early_exit_tpu_torch.training import losses as TL
from multi_modal_early_exit_tpu_torch.training import subgraphs as TS

torch.set_num_threads(2)

B, S = 3, 12

HEADS = {
    "ramp": dict(exits=("text_avg", "vision_avg", 1)),
    "gate": dict(exits=("text_avg", 1), encoder_layer_strategy="gate"),
    "lte": dict(exits=("text_visual_concat", "vision_avg", 1), use_lte=True,
                inference_strategy="lte", exit_head_num_layers=1),
}


def _setup(heads="ramp", **exit_kwargs):
    jcfg, tcfg = no_dropout(*tiny_configs(**HEADS[heads], **exit_kwargs))
    params, tree = jax_params(jcfg)
    batch = train_batch(5, B, S, jcfg, masked_tail=3)
    return jcfg, tcfg, params, port_model(tcfg, tree), batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_grads(model, loss):
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, params, grads)}


def _entropy_scales(exit_logits, logits, ent, xp):
    """entropyreg's per-branch factors, as both trainers compute them."""
    crit = xp.concatenate([
        xp.stack([ent(lg).mean() for lg in exit_logits]),
        ent(logits).mean()[None],
    ])
    e = xp.exp(crit - crit.max())
    norm = e / e.sum() * crit.shape[0]
    return 1.0 - xp.minimum(norm, xp.ones_like(norm))


@pytest.mark.parametrize("heads", ["ramp", "gate", "lte"])
def test_exit_losses_match_jax(heads):
    """Final CE and the per-exit losses of one deterministic forward, f32:
    to 1e-5 relative (the same forward in another order of f32 sums)."""
    jcfg, tcfg, params, model, batch = _setup(heads)

    @jax.jit
    def j_losses(p, b):
        out = j_ee_forward(p, jcfg, b["input_ids"], b["bbox"], b["pixel_values"],
                           b["attention_mask"])
        return (JL.cross_entropy(out.logits, b["labels"]),
                JL.exit_losses_from_outputs(out, jcfg, b["labels"]))

    want_final, want_exits = j_losses(params, _jax_batch(batch))
    t = TL.batch_to_device(batch, torch.device("cpu"))
    with torch.no_grad():
        out = ee_forward(model, tcfg, t["input_ids"], t["bbox"], t["pixel_values"],
                         t["attention_mask"])
        labels = t["labels"].long()
        final = TL.cross_entropy(out.logits, labels)
        exits = TL.exit_losses_from_outputs(out, tcfg, labels)
    assert exits.shape == (tcfg.exit.num_exits,)
    np.testing.assert_allclose(float(final), float(want_final), rtol=1e-5)
    np.testing.assert_allclose(exits.numpy(), np.asarray(want_exits), rtol=1e-5, atol=1e-6)


STRATEGIES = [
    ("ramp", "joint_weighted_avg"),
    ("ramp", "one_stage_subgraphs_weighted"),
    ("ramp", "one_stage_subgraphs_weighted_entropyreg"),
    ("gate", "two_stage_subgraphs_weighted"),
]


@pytest.mark.parametrize("heads,strategy", STRATEGIES)
def test_ee_loss_value_and_grad_match_jax(heads, strategy):
    """``jax.value_and_grad(ee_loss_fn)`` against the port's training
    forward (chained attention: ``deterministic=False``, every layer in one
    step) and one backward, f32, entropyreg's branch scaling applied on both
    sides: the loss to 1e-5, each gradient to 2e-4 of its own largest value
    (f32 sums through two layers and the softmax backward in another
    order)."""
    jcfg, tcfg, params, model, batch = _setup(heads, training_strategy=strategy, gamma=0.4)
    jcfg, tcfg = chained(jcfg, tcfg)
    weights = None
    if tcfg.exit.training_strategy.is_weighted:
        counts = TS.subgraph_param_counts(model, tcfg)
        np.testing.assert_array_equal(counts, JS.subgraph_param_counts(params, jcfg))
        weights = TS.exit_loss_weights(counts)
        np.testing.assert_array_equal(weights.numpy(), np.asarray(JS.exit_loss_weights(counts)))
    entropyreg = tcfg.exit.training_strategy.uses_entropyreg

    @jax.jit
    def j_value_and_grad(p, b):
        (loss, aux), g = jax.value_and_grad(JL.ee_loss_fn, has_aux=True)(
            p, jcfg, b, rng=None,
            exit_weights=None if weights is None else jnp.asarray(weights.numpy()),
            deterministic=False,
        )
        if entropyreg:
            scales = _entropy_scales(aux["exit_logits"], aux["logits"], j_entropy, jnp)
            g = JS.apply_entropyreg(g, jcfg, scales)
        return loss, aux["exit_losses"], g

    want_loss, want_exits, want_grads = j_value_and_grad(params, _jax_batch(batch))
    loss, aux = TL.ee_loss_fn(model, tcfg, batch, rng=torch.Generator().manual_seed(0),
                              exit_weights=weights, device="cpu")
    grads = _port_grads(model, loss)
    if entropyreg:
        with torch.no_grad():
            scales = _entropy_scales(aux["exit_logits"], aux["logits"], entropy, torch)
        grads = TS.apply_entropyreg(grads, tcfg, scales)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(aux["exit_losses"].detach().numpy(), np.asarray(want_exits),
                               rtol=1e-5, atol=1e-6)
    assert_state_close(grads, want_grads, 2e-4, strategy)


def test_exit_named_parameters_cover_the_counted_subgraphs():
    """Each exit's named parameters add up to its subgraph count, which is
    the JAX package's."""
    jcfg, tcfg = tiny_configs(exits=("vision_avg", "text_visual_concat", 1, 2))
    params, tree = jax_params(jcfg)
    model = port_model(tcfg, tree)
    counts = TS.subgraph_param_counts(model, tcfg)
    np.testing.assert_array_equal(counts, JS.subgraph_param_counts(params, jcfg))
    sizes = dict((n, p.numel()) for n, p in model.named_parameters())
    named = TS.exit_named_parameters(model, tcfg)
    assert list(named) == ["vision_avg", "text_visual_concat", "1", "2"]
    assert [sum(sizes[n] for n in names) for names in named.values()] == counts.tolist()


def test_bf16_mixed_precision_grads_match_jax():
    """``compute_dtype`` bf16 (f32 master parameters, the cast inside the
    differentiated function) against the JAX package's mixed precision:
    f32 gradients within 3e-2, the bar at which the JAX package holds its
    bf16 kernel-path gradients against its XLA path, taken relative to each
    tensor's largest value (this batch's gradients reach 1e2, where one bf16
    step is 0.5), plus 1e-6 for the key biases, whose true gradient is zero
    and whose bf16 values are rounding noise near 1e-8."""
    jcfg, tcfg, params, model, batch = _setup(
        "ramp", training_strategy="one_stage_subgraphs_weighted", gamma=0.4)
    weights = TS.exit_loss_weights(TS.subgraph_param_counts(model, tcfg))

    @jax.jit
    def j_value_and_grad(p, b):
        return jax.value_and_grad(JL.ee_loss_fn, has_aux=True)(
            p, jcfg, b, rng=None, exit_weights=jnp.asarray(weights.numpy()),
            deterministic=False, compute_dtype=jnp.bfloat16,
        )

    (want_loss, _), want_grads = j_value_and_grad(params, _jax_batch(batch))
    loss, _ = TL.ee_loss_fn(model, tcfg, batch, rng=torch.Generator().manual_seed(0),
                            exit_weights=weights, compute_dtype=torch.bfloat16, device="cpu")
    grads = _port_grads(model, loss)
    assert {g.dtype for g in grads.values()} == {torch.float32}
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=3e-2, rtol=3e-2)
    want = jax_tree_to_state_dict(jax.tree.map(np.asarray, want_grads))
    for name, g in grads.items():
        w = np.asarray(want[name], np.float32)
        np.testing.assert_allclose(g.numpy(), w, atol=3e-2 * np.abs(w).max() + 1e-6,
                                   rtol=3e-2, err_msg=name)


def test_training_forward_dropout_is_seeded():
    """With dropout on, ``ee_forward(deterministic=False)`` is a function of
    the generator's seed: the same seed gives the same logits, another seed
    or the deterministic forward others; the gradient reaches every layer."""
    jcfg, tcfg = tiny_configs(**HEADS["ramp"])
    _, tree = jax_params(jcfg)
    model = port_model(tcfg, tree)
    t = TL.batch_to_device(train_batch(2, B, S, jcfg), torch.device("cpu"))
    args = (t["input_ids"], t["bbox"], t["pixel_values"], t["attention_mask"])

    def run(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return ee_forward(model, tcfg, *args, deterministic=seed is None, rng=gen).logits

    a, b, c, d = run(1), run(1), run(2), run(None)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.allclose(a, c) and not torch.allclose(a, d)
    grads = _port_grads(model, a.square().sum())
    for i in range(tcfg.backbone.num_hidden_layers):
        g = grads[f"backbone.encoder.layers.{i}.intermediate.weight"]
        assert float(g.abs().max()) > 0


def test_loss_runs_on_cuda_unless_told_otherwise():
    jcfg, tcfg = tiny_configs(**HEADS["ramp"])
    _, tree = jax_params(jcfg)
    model = port_model(tcfg, tree)
    batch = train_batch(2, B, S, jcfg)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.ee_loss_fn(model, tcfg, batch)
