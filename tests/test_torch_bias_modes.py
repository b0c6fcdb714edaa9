"""PyTorch port, the two opt-in bias modes against the JAX package.

- ``MMEE_FUSED_BIAS``: ``fused_bias_attention`` (the bias built inside the
  attention kernel) against JAX's two-step reference and its Pallas kernel in
  interpret mode; ``ee_forward`` and the cascade with the switch on against
  the JAX package.
- ``MMEE_TABLE_GRADS``: ``flash_attention_packed_train_tables`` (the table
  gradients reduced in the attention backward) against ``jax.grad`` of the
  jnp composition; ``ee_loss_fn``'s gradients with the switch on against the
  JAX package and against the port's own chained path.
- The switches' semantics, and that no fused context is built under autograd.

On CPU tensors the ops run their plain versions; tiny config, f32, inputs
from numpy seeds.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    assert_state_close,
    jax_params,
    make_batch,
    no_dropout,
    port_model,
    tiny_configs,
    to_jax,
    to_torch,
    train_batch,
)
from multi_modal_early_exit_tpu.models.ee.cascade import (
    make_cascade_forward as j_make_cascade,
)
from multi_modal_early_exit_tpu.models.ee.model import ee_forward as j_ee_forward
from multi_modal_early_exit_tpu.models.layoutlmv3 import modeling as JM
from multi_modal_early_exit_tpu.models.layoutlmv3.config import (
    LayoutLMv3Config as JLayoutLMv3Config,
)
from multi_modal_early_exit_tpu.ops import flash_attention as jfa
from multi_modal_early_exit_tpu.ops import fused_bias_attention as jfba
from multi_modal_early_exit_tpu.training import losses as JL
from multi_modal_early_exit_tpu_torch.models.ee.cascade import make_cascade_forward
from multi_modal_early_exit_tpu_torch.models.ee.model import ee_forward
from multi_modal_early_exit_tpu_torch.models.layoutlmv3 import modeling as TM
from multi_modal_early_exit_tpu_torch.ops import flash_attention as tfa
from multi_modal_early_exit_tpu_torch.ops import fused_bias_attention as tfba
from multi_modal_early_exit_tpu_torch.training import losses as TL
from multi_modal_early_exit_tpu_torch.training import subgraphs as TSG

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _switches_unset(monkeypatch):
    """Each test starts with both switches unset."""
    monkeypatch.delenv("MMEE_FUSED_BIAS", raising=False)
    monkeypatch.delenv("MMEE_TABLE_GRADS", raising=False)


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name`` (the caller's global)."""
    fn = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)
    return calls


# ---------------------------------------------------------------------------
# fused_bias_attention
# ---------------------------------------------------------------------------

FB, FH, FS, FD = 2, 4, 22, 8  # ragged S: the JAX kernel pads it to 24


def _fused_case(seed=0):
    cfg = JLayoutLMv3Config.tiny()
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((FB, FS, FH, FD)).astype(np.float32) for _ in range(3)]
    pos = np.broadcast_to(np.arange(FS, dtype=np.int32), (FB, FS)).copy()
    x0 = rng.integers(0, 900, (FB, FS, 1))
    y0 = rng.integers(0, 900, (FB, FS, 1))
    bbox = np.concatenate([x0, y0, x0 + 50, y0 + 30], -1).astype(np.int32)
    mask = np.ones((FB, FS), np.int32)
    mask[1, -5:] = 0
    tables = [rng.standard_normal((n, FH)).astype(np.float32)
              for n in (cfg.rel_pos_bins, cfg.rel_2d_pos_bins, cfg.rel_2d_pos_bins)]
    return cfg, qkv, pos, bbox, mask, tables


def _port_fused(cfg, qkv, pos, bbox, mask, tables, layout):
    """The port's op on (B, H, S, D) tensors made contiguous or as the
    transposed view of a (B, S, H, D) tensor (the packed projections)."""
    def heads(a):
        t = torch.from_numpy(a).transpose(1, 2)
        return t.contiguous() if layout == "contiguous" else t

    scale = 1.0 / math.sqrt(FD)
    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return tfba.fused_bias_attention(
        *(heads(a) for a in qkv), tt(pos), tt(bbox[:, :, 0]), tt(bbox[:, :, 3]), tt(mask),
        *(tt(t) * scale for t in tables), rel_bins=cfg.rel_pos_bins,
        max_rel=cfg.max_rel_pos, rel2d_bins=cfg.rel_2d_pos_bins, max_rel2d=cfg.max_rel_2d_pos,
    )


@pytest.mark.parametrize("layout", ["contiguous", "packed"])
def test_fused_bias_attention_plain_matches_jax_two_step(layout):
    """The plain version against ``fused_rel_pos_bias`` + mask +
    ``reference_attention`` (the JAX package's own two-step reference), f32:
    within 1e-5 (f32 sums in another order). A packed-view input gives a
    packed-view output."""
    cfg, qkv, pos, bbox, mask, tables = _fused_case()
    scale = 1.0 / math.sqrt(FD)
    enc = dict(zip(("rel_pos_bias", "rel_pos_x_bias", "rel_pos_y_bias"),
                   (jnp.asarray(t) for t in tables)))
    bias = JM.fused_rel_pos_bias(enc, cfg, jnp.asarray(pos), jnp.asarray(bbox), scale=scale)
    bias = bias + ((1 - jnp.asarray(mask)) * jnp.finfo(jnp.float32).min)[:, None, None, :]
    want = np.asarray(jfa.reference_attention(
        *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in qkv), bias))
    got = _port_fused(cfg, qkv, pos, bbox, mask, tables, layout)
    assert got.shape == (FB, FH, FS, FD) and got.dtype == torch.float32
    if layout == "packed":
        assert got.transpose(1, 2).is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_fused_bias_attention_plain_matches_pallas_kernel():
    """The plain version against the Pallas kernel in interpret mode, whose
    table lookups and bias tile are bf16: the JAX test's 5e-3 / 1e-2, on the
    rows of real tokens."""
    from jax.experimental.pallas import tpu as pltpu

    cfg, qkv, pos, bbox, mask, tables = _fused_case(1)
    scale = 1.0 / math.sqrt(FD)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfba.fused_bias_attention(
            *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in qkv), jnp.asarray(pos),
            jnp.asarray(bbox[:, :, 0]), jnp.asarray(bbox[:, :, 3]), jnp.asarray(mask),
            *(jnp.asarray(t) * scale for t in tables), block_q=8, block_k=8,
            rel_bins=cfg.rel_pos_bins, max_rel=cfg.max_rel_pos,
            rel2d_bins=cfg.rel_2d_pos_bins, max_rel2d=cfg.max_rel_2d_pos,
        ))
    got = _port_fused(cfg, qkv, pos, bbox, mask, tables, "packed").numpy()
    np.testing.assert_allclose(got[0], want[0], atol=5e-3, rtol=1e-2)
    np.testing.assert_allclose(got[1, :, :-5], want[1, :, :-5], atol=5e-3, rtol=1e-2)


# ---------------------------------------------------------------------------
# flash_attention_packed_train_tables
# ---------------------------------------------------------------------------

AB, AH, AS, AD = 2, 4, 24, 16  # the table tests' shapes
BINS = dict(rel_bins=8, max_rel=16, rel2d_bins=8, max_rel2d=32)


def _tables_case(seed=40):
    """The inputs of tests/test_flash_attention.py's table-gradient test."""
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((AB, AS, AH * AD)).astype(np.float32) for _ in range(3)]
    tables = [rng.standard_normal((n, AH)).astype(np.float32)
              for n in (BINS["rel_bins"], BINS["rel2d_bins"], BINS["rel2d_bins"])]
    vecs = [rng.integers(0, hi, (AB, AS)).astype(np.int32) for hi in (50, 100, 100)]
    mask = np.ones((AB, AS), np.int32)
    mask[1, -5:] = 0
    return qkv, tables, vecs, mask


def _jax_table_loss(qkv, tables, vecs, mask, seed, rate):
    """jax.grad of the jnp composition that builds the bias from the tables:
    (loss, grads of q, k, v, t1, tx, ty)."""
    pos, cx, cy = (jnp.asarray(a) for a in vecs)
    jmask = jnp.asarray(mask)

    def build_bias(t1, tx, ty):
        def table_bias(table, vec, bins, max_d):
            rel = vec[:, None, :] - vec[:, :, None]  # key minus query
            return table[jfba._bucket(rel, bins, max_d)].transpose(0, 3, 1, 2)

        bias = (table_bias(t1, pos, BINS["rel_bins"], BINS["max_rel"])
                + table_bias(tx, cx, BINS["rel2d_bins"], BINS["max_rel2d"])
                + table_bias(ty, cy, BINS["rel2d_bins"], BINS["max_rel2d"]))
        return bias + jnp.where(jmask == 0, -1e30, 0.0)[:, None, None, :]

    def split(x):
        return x.reshape(AB, AS, AH, AD).transpose(0, 2, 1, 3)

    def loss(q, k, v, t1, tx, ty):
        bias = build_bias(t1, tx, ty)
        if rate > 0.0:
            out = jfa.reference_attention_hash_dropout(
                split(q), split(k), split(v), bias, jnp.asarray([seed], jnp.int32), rate)
        else:
            out = jfa.reference_attention(split(q), split(k), split(v), bias)
        return (out.transpose(0, 2, 1, 3).reshape(AB, AS, AH * AD) ** 2).sum()

    args = [jnp.asarray(a) for a in (*qkv, *tables)]
    return jax.value_and_grad(loss, argnums=tuple(range(6)))(*args)


def _port_tables(qkv, tables, vecs, mask, seed, rate):
    """The port's op on the port's own (detached) bias: (out, loss, grads of
    q, k, v, t1, tx, ty)."""
    ts = [torch.from_numpy(a).requires_grad_() for a in (*qkv, *tables)]
    tv = [torch.from_numpy(a) for a in vecs]
    with torch.no_grad():
        bias = tfba.materialize_bias(*tv, torch.from_numpy(mask), *ts[3:], **BINS,
                                     out_dtype=torch.float32)
    out = tfa.flash_attention_packed_train_tables(*ts[:3], bias, *ts[3:], *tv, seed, AH,
                                                  rate, **BINS)
    loss = out.square().sum()
    loss.backward()
    return out.detach(), bias, loss.item(), [t.grad for t in ts]


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_train_tables_plain_matches_jax_grad(rate):
    """dq, dk, dv and the three table gradients against jax.grad of the
    composition (the bias built from the tables, then reference attention
    with the same position-hash dropout), f32: within the JAX test's 2e-3.
    The forward equals the port's ``flash_attention_packed_train``."""
    qkv, tables, vecs, mask = _tables_case()
    seed = 3
    want_loss, wants = _jax_table_loss(qkv, tables, vecs, mask, seed, rate)
    out, bias, loss, grads = _port_tables(qkv, tables, vecs, mask, seed, rate)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    for g, w in zip(grads, wants):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3, rtol=2e-3)
    plain = tfa.flash_attention_packed_train(
        *(torch.from_numpy(a) for a in qkv), bias, seed, AH, rate)
    assert torch.equal(out, plain)


def test_train_tables_backward_is_the_chained_backward_bucketed():
    """The plain tables backward equals the chained op's dq/dk/dv and
    ``table_grads`` of its dbias (the two paths it replaces)."""
    qkv, tables, vecs, mask = _tables_case(41)
    tq, tk, tv_ = (torch.from_numpy(a) for a in qkv)
    vec_t = [torch.from_numpy(a) for a in vecs]
    bias = tfba.materialize_bias(*vec_t, torch.from_numpy(mask),
                                 *(torch.from_numpy(t) for t in tables), **BINS,
                                 out_dtype=torch.float32)
    o, lse = tfa.flash_attention_packed_train_fwd(tq, tk, tv_, bias, 9, AH, 0.25)
    do = torch.from_numpy(np.random.default_rng(2).standard_normal(o.shape).astype(np.float32))
    got = tfa.flash_attention_packed_train_tables_bwd(tq, tk, tv_, bias, *vec_t, 9, o, lse, do,
                                                      AH, 0.25, **BINS)
    dq, dk, dv, dbias = tfa.flash_attention_packed_train_bwd(tq, tk, tv_, bias, 9, o, lse, do,
                                                             AH, 0.25)
    want = (dq, dk, dv, *tfba.table_grads(*vec_t, dbias, *BINS.values()))
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-6 * w.abs().max().item(), rtol=1e-6)


@pytest.mark.slow
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_train_tables_plain_matches_pallas_kernel(rate):
    """The port's op against the Pallas op in interpret mode, f32, gradients
    included: within 2e-3."""
    from jax.experimental.pallas import tpu as pltpu

    qkv, tables, vecs, mask = _tables_case(42)
    seed = 5
    _, bias, _, grads = _port_tables(qkv, tables, vecs, mask, seed, rate)
    jbias = jnp.asarray(bias.numpy()[:, :, :AS, :AS])
    pos, cx, cy = (jnp.asarray(a) for a in vecs)

    def loss(q, k, v, t1, tx, ty):
        out = jfa.flash_attention_packed_train_tables(
            q, k, v, jbias, t1, tx, ty, pos, cx, cy, jnp.asarray([seed], jnp.int32), AH,
            block_q=8, rate=rate, **BINS)
        return (out ** 2).sum()

    with pltpu.force_tpu_interpret_mode():
        wants = jax.grad(loss, argnums=tuple(range(6)))(
            *(jnp.asarray(a) for a in (*qkv, *tables)))
    for g, w in zip(grads, wants):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3, rtol=2e-3)


def test_train_tables_rejects_a_bias_that_wants_a_gradient():
    qkv, tables, vecs, mask = _tables_case()
    bias = torch.zeros((AB, AH, 128, 128), requires_grad=True)
    with pytest.raises(ValueError, match="detached"):
        tfa.flash_attention_packed_train_tables(
            *(torch.from_numpy(a) for a in qkv), bias,
            *(torch.from_numpy(a) for a in (*tables, *vecs)), 0, AH, **BINS)


# ---------------------------------------------------------------------------
# the model with the switches on
# ---------------------------------------------------------------------------

B, S = 3, 12


def _loss_setup():
    jcfg, tcfg = no_dropout(*tiny_configs(exits=("text_avg", "vision_avg", 1),
                                          training_strategy="one_stage_subgraphs_weighted"))
    params, tree = jax_params(jcfg)
    model = port_model(tcfg, tree)
    weights = TSG.exit_loss_weights(TSG.subgraph_param_counts(model, tcfg))
    return jcfg, tcfg, params, model, weights, train_batch(5, B, S, jcfg, masked_tail=3)


def _port_loss_grads(model, tcfg, batch, weights):
    loss, _ = TL.ee_loss_fn(model, tcfg, batch, rng=torch.Generator().manual_seed(0),
                            exit_weights=weights, device="cpu")
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.item(), {n: torch.zeros_like(p) if g is None else g
                         for n, p, g in zip(names, params, grads)}


def test_ee_loss_grads_with_table_grads_match_jax_and_chained(monkeypatch):
    """``ee_loss_fn`` with MMEE_TABLE_GRADS=1 (dropout 0, f32): the loss and
    every gradient against the JAX package's (tests/test_torch_losses.py's
    bars: 1e-5, and 2e-4 of each tensor's scale), and against the port's
    chained path within f32 rounding (1e-5 of each tensor's scale). Each
    layer runs the tables backward; ``table_grads`` never runs."""
    jcfg, tcfg, params, model, weights, batch = _loss_setup()

    @jax.jit
    def j_value_and_grad(p, b):
        return jax.value_and_grad(JL.ee_loss_fn, has_aux=True)(
            p, jcfg, b, rng=None, exit_weights=jnp.asarray(weights.numpy()),
            deterministic=False)

    (want_loss, _), want_grads = j_value_and_grad(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    chained_loss, chained = _port_loss_grads(model, tcfg, batch, weights)

    monkeypatch.setenv("MMEE_TABLE_GRADS", "1")
    tables_bwd = _spy(monkeypatch, tfa, "flash_attention_packed_train_tables_bwd")
    table_grads = _spy(monkeypatch, tfba, "table_grads")
    loss, grads = _port_loss_grads(model, tcfg, batch, weights)
    assert len(tables_bwd) == tcfg.backbone.num_hidden_layers and not table_grads
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    assert_state_close(grads, want_grads, 2e-4, "tables vs JAX")
    assert loss == chained_loss
    for name, g in grads.items():
        w = chained[name]
        torch.testing.assert_close(g, w, atol=1e-5 * w.abs().max().item() + 1e-12, rtol=1e-5,
                                   msg=name)
    assert grads["backbone.encoder.rel_pos_bias"].abs().max() > 0


@pytest.mark.parametrize("seq_pad_multiple", [None, 128])
def test_ee_forward_with_fused_bias_matches_jax(monkeypatch, seq_pad_multiple):
    """``ee_forward`` under no_grad with MMEE_FUSED_BIAS=1 against the JAX
    package's ``ee_forward`` (tests/test_torch_model.py's bars): every layer
    runs ``fused_bias_attention`` and no bias is built."""
    jcfg, tcfg = tiny_configs(exits=("text_avg", "vision_avg", 1))
    params, tree = jax_params(jcfg, seed=3)
    model = port_model(tcfg, tree)
    batch = make_batch(4, 6, 20, tcfg, masked_tail=3)
    want = jax.jit(lambda p, *b: j_ee_forward(p, jcfg, *b).policy_logits())(
        params, *to_jax(batch))
    monkeypatch.setenv("MMEE_FUSED_BIAS", "1")
    fused = _spy(monkeypatch, TM, "fused_bias_attention")
    built = _spy(monkeypatch, TM, "materialize_bias")
    with torch.no_grad():
        out = ee_forward(model, tcfg, *to_torch(batch), seq_pad_multiple=seq_pad_multiple)
    assert len(fused) == tcfg.backbone.num_hidden_layers and not built
    np.testing.assert_allclose(out.policy_logits().numpy(), np.asarray(want),
                               atol=2e-4, rtol=1e-3)


def test_no_fused_context_under_autograd(monkeypatch):
    """The fused attention has no backward: with the switch on, a forward
    under autograd takes the chained training path, and its gradients equal
    those with the switch off."""
    jcfg, tcfg = tiny_configs(exits=("text_avg", "vision_avg", 1))
    _, tree = jax_params(jcfg, seed=3)
    model = port_model(tcfg, tree)
    batch = to_torch(make_batch(4, 2, 12, tcfg))
    names, params = zip(*model.named_parameters())

    def grads():
        loss = ee_forward(model, tcfg, *batch).logits.square().sum()
        return torch.autograd.grad(loss, params, allow_unused=True)

    want = grads()
    monkeypatch.setenv("MMEE_FUSED_BIAS", "1")
    fused = _spy(monkeypatch, TM, "fused_bias_attention")
    got = grads()
    assert not fused
    for n, g, w in zip(names, got, want):
        assert (g is None) == (w is None), n
        if g is not None:
            assert torch.equal(g, w), n
    assert got[names.index("backbone.encoder.rel_pos_bias")].abs().max() > 0


@pytest.mark.parametrize("caps", [(8, 8), (6, 3)])
def test_cascade_with_fused_bias_matches_jax(monkeypatch, caps):
    """The cascade with MMEE_FUSED_BIAS=1 against the JAX cascade with the
    same switch, its fused Pallas kernel in interpret mode (the cases of
    tests/test_torch_cascade_kernel_path.py): exit ids and capacity exits
    bit-equal, logits within 5e-2. Every stage builds its own context: no
    bias is built or gathered."""
    from jax.experimental.pallas import tpu as pltpu

    import multi_modal_early_exit_tpu.models.ee.cascade as cascade_mod

    jcfg, tcfg = tiny_configs(exits=("text_avg", "vision_avg", 1))
    _, tree = jax_params(jcfg, seed=0)
    for head in (*tree["embedding_exits"].values(), tree["encoder_exits"],
                 tree["backbone"]["classifier"]):
        head["out_proj"]["kernel"] = head["out_proj"]["kernel"] * 40.0
    params = jax.tree.map(jnp.asarray, tree)
    model = port_model(tcfg, tree)
    batch = make_batch(9, 8, 20, tcfg, masked_tail=4)
    with torch.no_grad():
        crit = ee_forward(model, tcfg, *to_torch(batch)).exit_criteria[:-1].numpy()
    v = np.unique(crit)
    k = int(np.argmax(np.diff(v)))
    threshold = float((v[k] + v[k + 1]) / 2)
    assert v[k + 1] - v[k] > 0.02

    monkeypatch.setenv("MMEE_FUSED_BIAS", "1")
    monkeypatch.setattr(jfa, "use_flash_attention", lambda: True)
    monkeypatch.setattr(cascade_mod, "use_flash_attention", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        want = j_make_cascade(jcfg, caps, threshold)(params, *to_jax(batch))
    fused = _spy(monkeypatch, TM, "fused_bias_attention")
    built = _spy(monkeypatch, TM, "materialize_bias")
    got = make_cascade_forward(tcfg, caps, threshold)(model, *to_torch(batch))
    assert len(fused) == tcfg.backbone.num_hidden_layers and not built
    np.testing.assert_array_equal(got.exit_ids.numpy(), np.asarray(want.exit_ids))
    np.testing.assert_array_equal(got.capacity_exited.numpy(), np.asarray(want.capacity_exited))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("value", [None, "", "0", "1", "yes"])
def test_switches_match_jax(monkeypatch, value):
    """MMEE_FUSED_BIAS and MMEE_TABLE_GRADS: 1 (or any other non-empty value
    but 0) forces the mode on, 0 off, unset or empty gives the call site's
    default, as in the JAX package (whose fused switch also needs its TPU
    kernels, forced on here)."""
    monkeypatch.setattr(jfa, "use_flash_attention", lambda: True)
    for name in ("MMEE_FUSED_BIAS", "MMEE_TABLE_GRADS"):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    for default in (False, True):
        assert (TM.use_fused_bias_attention(default)
                == JM.use_fused_bias_attention(default))
        assert (TM.use_table_grad_attention(default)
                == JM.use_table_grad_attention(default))
