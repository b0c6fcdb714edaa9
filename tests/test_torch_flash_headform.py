"""PyTorch port, the head-form attention against the JAX package's Pallas
kernels in interpret mode: ``flash_attention``'s forward, lse and gradients
over ragged S, a pre-padded bias and dropout (`_attn_fwd_kernel`,
`_attn_bwd_fused_kernel`); the backward of ``flash_attention_packed``
against ``jax.grad`` through the JAX op's ``_packed_bwd``; and the slice as
a whole, the gradients of ``ee_loss_fn(deterministic=True)`` against the
JAX package's flash-wiring oracle. f32 inputs from numpy seeds, at the JAX
tests' own bars (tests/test_flash_attention.py); on CPU tensors the port
runs the kernels' plain versions."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import jax_params, port_model, tiny_configs
from multi_modal_early_exit_tpu.ops import flash_attention as jfa
from multi_modal_early_exit_tpu.training import losses as JL
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.convert import jax_tree_to_state_dict
from multi_modal_early_exit_tpu_torch.ops import flash_attention as tfa
from multi_modal_early_exit_tpu_torch.training import losses as TL

torch.set_num_threads(2)

FWD_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=3e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def interpret_mode():
    """The Pallas kernels run interpreted, as the JAX package's tests run them."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name`` (the callers' global)."""
    fn = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)
    return calls


def _case(seed, b, h, s, d, bias_s=None):
    """numpy f32 q, k, v (B, H, S, D), a bias (B, H, S', S') and a
    cotangent of the output."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(4))
    bias_s = bias_s or s
    bias = rng.standard_normal((b, h, bias_s, bias_s)).astype(np.float32)
    return q, k, v, bias, g


def _prepadded(bias, width):
    """The bias at a wider width, -1e30 on the extra keys (and rows)."""
    b, h, s, _ = bias.shape
    pre = np.full((b, h, width, width), -1e30, np.float32)
    pre[:, :, :s, :s] = bias
    return pre


def _port_grads(fn, arrays, g):
    """fn's output and the gradients of <fn(*arrays), g> in the port."""
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_grads(fn, arrays, g):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in arrays))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("s", [16, 27, 130, 200])
def test_forward_and_lse_match_pallas(s):
    """Ragged S (27 pads to 32 inside the Pallas kernel; 130 and 200 are the
    lengths whose bias widths, 192 and 320, end the CUDA forward in a
    half-filled 128-row tile): the output and the f32 lse of the real
    rows."""
    q, k, v, bias, _ = _case(0, 2, 3, s, 8)
    seed = jnp.zeros((1,), jnp.int32)
    want_o, want_lse = jfa._flash_attention_fwd_impl(
        *(jnp.asarray(a) for a in (q, k, v, bias)), seed, 16, 0.0, with_lse=True)
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    out, lse = tfa.flash_attention_fwd(tq, tk, tv, tb, with_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 3, s)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_o), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., :s, 0], **FWD_TOL)
    np.testing.assert_array_equal(tfa.flash_attention(tq, tk, tv, tb, block_q=16).numpy(),
                                  out.numpy())


@pytest.mark.parametrize("s", [16, 27])
def test_gradients_match_pallas(s):
    """dq, dk, dv and dbias against the Pallas backward, with a
    non-trivial cotangent."""
    arrays = _case(3, 2, 2, s, 8)
    want_o, wants = _jax_grads(lambda q, k, v, b: jfa.flash_attention(q, k, v, b, 16),
                               arrays[:4], arrays[4])
    got_o, gots = _port_grads(lambda q, k, v, b: tfa.flash_attention(q, k, v, b, 16),
                              arrays[:4], arrays[4])
    np.testing.assert_allclose(got_o, want_o, **FWD_TOL)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), gots, wants):
        np.testing.assert_allclose(a, w, err_msg=name, **GRAD_TOL)


def test_prepadded_bias_matches_pallas():
    """A bias pre-padded wider than S (-1e30 on the extra keys): the same
    output and gradients as the Pallas kernels, dbias at the caller's shape
    and exactly zero in the pad; keys past S carry no weight."""
    q, k, v, bias, g = _case(4, 1, 2, 11, 8)
    pre = _prepadded(bias, 32)
    fn_j = lambda q, k, v, b: jfa.flash_attention(q, k, v, b, 8)  # noqa: E731
    want_o, wants = _jax_grads(fn_j, (q, k, v, pre), g)
    got_o, gots = _port_grads(lambda q, k, v, b: tfa.flash_attention(q, k, v, b, 8),
                              (q, k, v, pre), g)
    np.testing.assert_allclose(got_o, want_o, **FWD_TOL)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), gots, wants):
        np.testing.assert_allclose(a, w, err_msg=name, **GRAD_TOL)
    dbias = gots[3]
    assert dbias.shape == pre.shape
    assert np.all(dbias[:, :, 11:, :] == 0) and np.all(dbias[:, :, :, 11:] == 0)
    # the unpadded bias gives the same output
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    np.testing.assert_allclose(tfa.flash_attention(tq, tk, tv, torch.from_numpy(bias)).numpy(),
                               got_o, **FWD_TOL)


@pytest.mark.parametrize("rate", [0.25, 0.3])
def test_dropout_matches_pallas_and_hash_oracle(rate):
    """In-kernel position-hash dropout: the output and the gradients against
    the Pallas pair and against ``jax.grad`` of the JAX oracle
    ``reference_attention_hash_dropout`` with the same mask; the mask is not
    trivial."""
    q, k, v, bias, g = _case(5, 2, 3, 32, 8)
    seed = 17
    j_seed = jnp.asarray([seed], jnp.int32)
    kernel = lambda q, k, v, b: jfa.flash_attention(  # noqa: E731
        q, k, v, b, 16, dropout_rate=rate, dropout_seed=j_seed)
    oracle = lambda q, k, v, b: jfa.reference_attention_hash_dropout(  # noqa: E731
        q, k, v, b, seed, rate)
    got_o, gots = _port_grads(
        lambda q, k, v, b: tfa.flash_attention(q, k, v, b, 16, dropout_rate=rate,
                                               dropout_seed=np.asarray([seed], np.int32)),
        (q, k, v, bias), g)
    for fn in (kernel, oracle):
        want_o, wants = _jax_grads(fn, (q, k, v, bias), g)
        np.testing.assert_allclose(got_o, want_o, **FWD_TOL)
        for name, a, w in zip(("dq", "dk", "dv", "dbias"), gots, wants):
            np.testing.assert_allclose(a, w, err_msg=name, **GRAD_TOL)
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    assert np.abs(got_o - tfa.flash_attention(tq, tk, tv, tb).numpy()).max() > 1e-3


def test_references_match_jax():
    """The port's two oracles equal the JAX package's."""
    q, k, v, bias, _ = _case(6, 2, 2, 20, 8, bias_s=24)
    args_j = [jnp.asarray(a) for a in (q, k, v, bias)]
    args_t = [torch.from_numpy(a) for a in (q, k, v, bias)]
    np.testing.assert_allclose(
        tfa.reference_attention(*args_t[:3], args_t[3][:, :, :20, :20]).numpy(),
        np.asarray(jfa.reference_attention(*args_j[:3], args_j[3][:, :, :20, :20])),
        atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        tfa.reference_attention_hash_dropout(*args_t, 9, 0.2).numpy(),
        np.asarray(jfa.reference_attention_hash_dropout(*args_j, 9, 0.2)),
        atol=1e-6, rtol=1e-6)


def test_dropout_needs_a_seed():
    q, k, v, bias, _ = _case(7, 1, 1, 8, 8)
    with pytest.raises(ValueError, match="dropout_seed"):
        tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)), dropout_rate=0.1)
    with pytest.raises(ValueError, match="dropout_seed"):
        jfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v, bias)), dropout_rate=0.1)


@pytest.mark.parametrize("width", [24, 128])
def test_packed_backward_matches_pallas_packed_vjp(monkeypatch, width):
    """``flash_attention_packed``'s gradients against ``jax.grad`` of the
    JAX op (its VJP ``_packed_bwd`` recomputes the head-form forward, then
    runs the head-form backward), at S = 24 with the bias at S and
    pre-padded to 128; the port's backward runs the head-form forward and
    backward once each and no training op."""
    b, h, s, d = 2, 4, 24, 16
    rng = np.random.default_rng(8)
    q, k, v, g = (rng.standard_normal((b, s, h * d)).astype(np.float32) for _ in range(4))
    bias = rng.standard_normal((b, h, s, s)).astype(np.float32)
    bias[1, :, :, s - 3:] = -1e30  # masked keys
    if width > s:
        bias = _prepadded(bias, width)
    want_o, wants = _jax_grads(lambda q, k, v, bb: jfa.flash_attention_packed(q, k, v, bb, h),
                               (q, k, v, bias), g)
    calls = {name: _spy(monkeypatch, tfa, name) for name in (
        "flash_attention_fwd_plain", "flash_attention_bwd_plain",
        "flash_attention_packed_train_fwd_plain", "flash_attention_packed_train_bwd_plain")}
    got_o, gots = _port_grads(lambda q, k, v, bb: tfa.flash_attention_packed(q, k, v, bb, h),
                              (q, k, v, bias), g)
    assert [len(c) for c in calls.values()] == [1, 1, 0, 0]
    np.testing.assert_allclose(got_o, want_o, **FWD_TOL)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), gots, wants):
        np.testing.assert_allclose(a, w, err_msg=name, **GRAD_TOL)
    assert gots[3].shape == bias.shape and np.all(gots[3][:, :, s:, :] == 0)


def test_ee_loss_deterministic_grads_match_jax_flash_wiring(monkeypatch):
    """The slice as a whole: the gradients of ``ee_loss_fn(deterministic=
    True)`` on the tiny config against the JAX package's wiring oracle
    (tests/test_flash_attention.py: flash forced on, Pallas kernels
    interpreted, atol 5e-5 / rtol 5e-4). Every layer's backward runs the
    head-form forward and backward once."""
    jcfg, tcfg = tiny_configs(exits=("text_avg", 1))
    params, tree = jax_params(jcfg)
    model = port_model(tcfg, tree)
    rng = np.random.default_rng(7)
    B, S = 2, 16
    batch = {
        "input_ids": rng.integers(3, 1000, (B, S)).astype(np.int32),
        "bbox": np.sort(rng.integers(0, 500, (B, S, 4)), -1).astype(np.int32),
        "pixel_values": rng.standard_normal((B, 3, 32, 32)).astype(np.float32),
        "attention_mask": np.ones((B, S), np.int32),
        "labels": rng.integers(0, 4, (B,)).astype(np.int32),
    }
    monkeypatch.setattr(jfa, "use_flash_attention", lambda: True)
    (want_loss, _), want = jax.value_and_grad(JL.ee_loss_fn, has_aux=True)(
        params, jcfg, {k: jnp.asarray(a) for k, a in batch.items()}, rng=jax.random.key(3),
        deterministic=True)
    fwd = _spy(monkeypatch, tfa, "flash_attention_fwd_plain")
    bwd = _spy(monkeypatch, tfa, "flash_attention_bwd_plain")
    loss, _ = TL.ee_loss_fn(model, tcfg, batch, deterministic=True, device="cpu")
    names, tensors = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    layers = tcfg.backbone.num_hidden_layers
    assert len(fwd) == layers and len(bwd) == layers
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = jax_tree_to_state_dict(jax.tree.map(np.asarray, want))
    assert set(names) == set(want)
    for name, p, grad in zip(names, tensors, grads):
        got = torch.zeros_like(p) if grad is None else grad
        np.testing.assert_allclose(got.numpy(), want[name], atol=5e-5, rtol=5e-4, err_msg=name)
