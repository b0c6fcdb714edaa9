"""PyTorch port, the training schedules against the JAX package: the fold
(``effective_scan_fold``, ``MMEE_LAYERS_PER_STEP``), the chained bias
cotangent's switch (``use_chained_dbias``, ``MMEE_CHAINED_DBIAS``) and the
attention ``backbone_apply`` selects from them; ``EETrainer`` steps with and
without the chained cotangent; and gradient checkpointing, bit-equal to the
same step without it and within tolerance of the JAX package's
``gradient_checkpointing``. Tiny config, inputs from numpy seeds."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    assert_state_close,
    jax_params,
    no_dropout,
    port_model,
    tiny_configs,
    train_batch,
    with_backbone,
)
from multi_modal_early_exit_tpu.models.layoutlmv3 import modeling as JM
from multi_modal_early_exit_tpu.models.layoutlmv3.config import (
    LayoutLMv3Config as JLayoutLMv3Config,
)
from multi_modal_early_exit_tpu.ops import flash_attention as jfa
from multi_modal_early_exit_tpu.training import losses as JL
from multi_modal_early_exit_tpu.training import trainer as JT
from multi_modal_early_exit_tpu_torch.models.layoutlmv3 import modeling as TM
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import LayoutLMv3Config
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.convert import jax_tree_to_state_dict
from multi_modal_early_exit_tpu_torch.ops import flash_attention as tfa
from multi_modal_early_exit_tpu_torch.training import losses as TL
from multi_modal_early_exit_tpu_torch.training import subgraphs as TS
from multi_modal_early_exit_tpu_torch.training import trainer as TT

torch.set_num_threads(2)

SWITCHES = ("MMEE_CHAINED_DBIAS", "MMEE_LAYERS_PER_STEP", "MMEE_TABLE_GRADS", "MMEE_FUSED_BIAS")
EXITS = dict(exits=("text_avg", "vision_avg", 1), training_strategy="one_stage_subgraphs_weighted")
L = LayoutLMv3Config.tiny().num_hidden_layers
B, S = 2, 12


@pytest.fixture(autouse=True)
def _switches_unset(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name`` (the callers' global)."""
    fn = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)
    return calls


def _set(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


# ---------------------------------------------------------------------------
# the switches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value", [None, "", "x", "0", "1", "2", "3", "4", "-2"])
def test_effective_scan_fold_matches_jax(monkeypatch, value):
    """MMEE_LAYERS_PER_STEP over cfg.scan_fold, and the fallback to 1 for a
    value that does not divide the layer count, at 2 and 12 layers."""
    _set(monkeypatch, "MMEE_LAYERS_PER_STEP", value)
    for ctor in ("tiny", "base"):
        for fold in (1, 2, 3, 5, 12):
            theirs = getattr(JLayoutLMv3Config, ctor)().replace(scan_fold=fold)
            mine = getattr(LayoutLMv3Config, ctor)().replace(scan_fold=fold)
            assert TM.effective_scan_fold(mine) == JM.effective_scan_fold(theirs), (ctor, fold)


@pytest.mark.parametrize("value", [None, "", "0", "1", "yes"])
def test_use_chained_dbias_matches_jax(monkeypatch, value):
    """MMEE_CHAINED_DBIAS: 1 (or any other non-empty value but 0) on, 0 off,
    unset or empty the call site's default."""
    _set(monkeypatch, "MMEE_CHAINED_DBIAS", value)
    for default in (False, True):
        assert TM.use_chained_dbias(default) == JM.use_chained_dbias(default)


class _Stop(Exception):
    pass


def _encoder_bias_kind(monkeypatch, module, run):
    """The kind of bias ``module.backbone_apply`` hands ``encoder_apply``:
    'chained', 'tables' or 'tensor'. The run stops there."""
    seen = []

    def spy(p, cfg, hidden, attn_bias, *args, **kwargs):
        kind = {"ChainedBiasContext": "chained", "TrainBiasContext": "tables"}
        seen.append(kind.get(type(attn_bias).__name__, "tensor"))
        raise _Stop

    monkeypatch.setattr(module, "encoder_apply", spy)
    with pytest.raises(_Stop):
        run()
    return seen[0]


@pytest.mark.parametrize("fold", [1, L])
@pytest.mark.parametrize("switch", [None, "0", "1"])
def test_backbone_selection_matches_jax(monkeypatch, fold, switch):
    """The attention ``backbone_apply`` selects for a training forward and a
    deterministic one equals the JAX package's, for scan_fold 1 and L and
    every setting of MMEE_CHAINED_DBIAS: chained exactly when not
    deterministic and ``use_chained_dbias(default=fold == L)``. The JAX
    package runs its kernel branch (flash forced on, bf16, Pallas
    interpreted), the only one where it chains."""
    from jax.experimental.pallas import tpu as pltpu

    jcfg, tcfg = with_backbone(*tiny_configs(**EXITS), scan_fold=fold)
    params, tree = jax_params(jcfg)
    model = port_model(tcfg, tree)
    ids, bbox, px, mask = (train_batch(3, B, S, jcfg)[k]
                           for k in ("input_ids", "bbox", "pixel_values", "attention_mask"))
    _set(monkeypatch, "MMEE_CHAINED_DBIAS", switch)
    monkeypatch.setattr(jfa, "use_flash_attention", lambda: True)
    bb16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x,
                        params["backbone"])
    for deterministic in (False, True):
        def run_jax():
            with pltpu.force_tpu_interpret_mode():
                JM.backbone_apply(bb16, jcfg.backbone, jnp.asarray(ids), jnp.asarray(bbox),
                                  jnp.asarray(px, jnp.bfloat16), jnp.asarray(mask),
                                  deterministic=deterministic, rng=jax.random.key(0))

        def run_port():
            TM.backbone_apply(model.backbone, tcfg.backbone, torch.from_numpy(ids),
                              torch.from_numpy(bbox), torch.from_numpy(px),
                              torch.from_numpy(mask), deterministic=deterministic,
                              rng=torch.Generator().manual_seed(0))

        want = _encoder_bias_kind(monkeypatch, JM, run_jax)
        got = _encoder_bias_kind(monkeypatch, TM, run_port)
        assert got == want, (deterministic, fold, switch)
        expect_chained = not deterministic and switch != "0" and (switch == "1" or fold == L)
        assert (got == "chained") == expect_chained


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------

STEPS, LR = 2, 1e-3


@pytest.mark.parametrize("fold", [1, L])
def test_trainer_steps_match_jax(monkeypatch, fold):
    """``EETrainer`` steps at dropout 0 with scan_fold 1 (the JAX package's
    default schedule: the bias tensor in every layer, the attention's
    backward through the head-form forward and backward) and L (the chained
    cotangent) against the JAX trainer: losses to 1e-5, final parameters to
    tests/test_torch_trainer.py's bars."""
    jcfg, tcfg = with_backbone(*no_dropout(*tiny_configs(**EXITS)), scan_fold=fold)
    params, tree = jax_params(jcfg)
    model = port_model(tcfg, tree)
    batches = [{k: v[None] for k, v in train_batch(10 + i, B, S, jcfg, masked_tail=2).items()}
               for i in range(STEPS)]
    jtrainer = JT.EETrainer(jcfg, params, JT.TrainingArguments(learning_rate=LR),
                            total_steps=STEPS)
    ttrainer = TT.EETrainer(tcfg, model, TT.TrainingArguments(learning_rate=LR),
                            total_steps=STEPS, device="cpu")
    headform = _spy(monkeypatch, tfa, "flash_attention_bwd_plain")
    chained = _spy(monkeypatch, tfa, "flash_attention_packed_train_bwd_plain")
    key, gen = jax.random.key(1), torch.Generator().manual_seed(1)
    for step, batch in enumerate(batches):
        want = jtrainer.train_step({k: jnp.asarray(v) for k, v in batch.items()}, key)[0]
        got = ttrainer.train_step(batch, gen)[0]
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"loss of step {step}")
    layers_run = STEPS * L
    assert (len(headform), len(chained)) == ((layers_run, 0) if fold == 1 else (0, layers_run))
    final = {n: p.detach() for n, p in model.named_parameters()}
    want = jax_tree_to_state_dict(jax.tree.map(np.asarray, jtrainer.params))
    for n, a in final.items():
        w = want[n]
        np.testing.assert_allclose(a.numpy(), w, atol=2e-4 * np.abs(w).max() + 1e-3 * LR,
                                   rtol=2e-4, err_msg=n)


def _loss_grads(model, tcfg, batch, weights, seed, compute_dtype=None):
    loss, _ = TL.ee_loss_fn(model, tcfg, batch, rng=torch.Generator().manual_seed(seed),
                            exit_weights=weights, compute_dtype=compute_dtype, device="cpu")
    names, tensors = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    return loss.item(), {n: torch.zeros_like(p) if g is None else g
                         for n, p, g in zip(names, tensors, grads)}


@pytest.mark.parametrize("fold,compute_dtype", [(1, None), (1, torch.bfloat16), (L, None)])
def test_gradient_checkpointing_is_bit_equal(monkeypatch, fold, compute_dtype):
    """With dropout on (hidden and attention 0.1, the same generator seed),
    the gradients with ``gradient_checkpointing`` equal those without it bit
    for bit: the seeds are drawn before each checkpointed group and the
    recompute takes the group's parameters as they were (the bf16 copies
    under mixed precision). Each layer's attention forward runs twice, its
    backward once; at scan_fold L the chained cotangent passes the
    checkpoint."""
    jcfg, tcfg = with_backbone(*tiny_configs(**EXITS), scan_fold=fold)
    _, tree = jax_params(jcfg)
    model = port_model(tcfg, tree)
    weights = TS.exit_loss_weights(TS.subgraph_param_counts(model, tcfg))
    batch = train_batch(4, B, S, jcfg, masked_tail=3)
    fwd = _spy(monkeypatch, tfa, "flash_attention_packed_train_fwd_plain")
    bwd = _spy(monkeypatch, tfa, "flash_attention_packed_train_bwd_plain")
    want_loss, want = _loss_grads(model, tcfg, batch, weights, 5, compute_dtype)
    assert (len(fwd), len(bwd)) == (L, L)
    remat = tcfg.replace(backbone=tcfg.backbone.replace(gradient_checkpointing=True))
    loss, grads = _loss_grads(model, remat, batch, weights, 5, compute_dtype)
    assert (len(fwd), len(bwd)) == (3 * L, 2 * L)
    assert loss == want_loss
    for name, g in grads.items():
        assert torch.equal(g, want[name]), name
    assert grads["backbone.encoder.rel_pos_bias"].abs().max() > 0


@pytest.mark.parametrize("fold", [1, L])
def test_gradient_checkpointing_matches_jax(fold):
    """``ee_loss_fn``'s value and gradients with ``gradient_checkpointing``
    on both sides, dropout 0, f32: the loss to 1e-5 and each gradient to 2e-4
    of its own largest value (tests/test_torch_losses.py's bars)."""
    jcfg, tcfg = with_backbone(*no_dropout(*tiny_configs(**EXITS)), scan_fold=fold,
                               gradient_checkpointing=True)
    params, tree = jax_params(jcfg)
    model = port_model(tcfg, tree)
    weights = TS.exit_loss_weights(TS.subgraph_param_counts(model, tcfg))
    batch = train_batch(6, B, S, jcfg, masked_tail=3)

    @jax.jit
    def j_value_and_grad(p, b):
        return jax.value_and_grad(JL.ee_loss_fn, has_aux=True)(
            p, jcfg, b, rng=None, exit_weights=jnp.asarray(weights.numpy()),
            deterministic=False)

    (want_loss, _), want = j_value_and_grad(params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _loss_grads(model, tcfg, batch, weights, 0)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    assert_state_close(grads, want, 2e-4, f"remat, scan_fold {fold}")
