"""PyTorch port, training primitives: the position-hash dropout against the
JAX package bit for bit, and the hand-written LayerNorm and GELU backwards
against ``jax.vjp``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_modal_early_exit_tpu.models.layoutlmv3 import modeling as JM
from multi_modal_early_exit_tpu.ops import hashing as jh
from multi_modal_early_exit_tpu_torch.models.layoutlmv3 import modeling as TM
from multi_modal_early_exit_tpu_torch.ops import hashing as th

torch.set_num_threads(2)

SEEDS = [0, 1, 7, -5, 2 ** 31 - 1, -2 ** 31, 123456789]


@pytest.mark.parametrize("seed", SEEDS)
def test_dropout_uniform_bit_equal_to_jax(seed):
    rng = np.random.default_rng(abs(seed) % 1000)
    bh = (np.arange(24) * 7919)[:, None, None].astype(np.int32)
    rows = rng.integers(0, 100_000, (1, 33, 1)).astype(np.int32)
    cols = rng.integers(0, 100_000, (1, 1, 45)).astype(np.int32)
    want = np.asarray(jh.dropout_uniform(
        jnp.int32(seed), jnp.asarray(bh), jnp.asarray(rows), jnp.asarray(cols)))
    got = th.dropout_uniform(seed, torch.from_numpy(bh), torch.from_numpy(rows),
                             torch.from_numpy(cols))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_hash_dropout_forward_and_grad_bit_equal(dtype, rate):
    """The same seed gives JAX's mask and scaling bit for bit, and the
    backward regenerates that mask."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 40)).astype(np.float32)
    g = rng.standard_normal((3, 5, 40)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    seed = 2024
    core = lambda a: jh._hash_dropout_core(a, jnp.int32(seed), rate)  # noqa: E731
    want, vjp = jax.vjp(core, jnp.asarray(x, jdt))
    (want_g,) = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    got = th.hash_dropout(xt, rate, seed)
    got.backward(torch.from_numpy(g).to(tdt))
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want, np.float32))
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(want_g, np.float32))


def test_dropout_is_identity_when_off():
    x = torch.randn(4, 8)
    assert TM.dropout(x, 0.1, True, 5) is x
    assert TM.dropout(x, 0.0, False, 5) is x
    assert TM.dropout(x, 0.1, False, None) is x


def test_rng_stream_draws_int32_seeds_from_its_generator():
    a = TM.RngStream(torch.Generator().manual_seed(3))
    b = TM.RngStream(torch.Generator().manual_seed(3))
    seeds = [a.next() for _ in range(5)]
    assert seeds == [b.next() for _ in range(5)]
    assert all(isinstance(s, int) and 0 <= s < 2 ** 31 for s in seeds)
    assert len(set(seeds)) == 5
    assert TM.RngStream(None).next() is None


def _ln_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 7, 32)) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(32)).astype(np.float32)
    g = rng.standard_normal((2, 7, 32)).astype(np.float32)
    return x, scale, bias, g


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_layer_norm_vjp_matches_jax(dtype, tol):
    """The one-pass forward and the hand VJP (dx, dscale, dbias) against
    jax.vjp of the JAX package's layer_norm: f32 to 2e-5 (sums in another
    order), bf16 to one bf16 step of the largest value (2e-2, relative)."""
    x, scale, bias, g = _ln_inputs()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    fn = lambda a, s, b: JM.layer_norm({"scale": s, "bias": b}, a, 1e-5)  # noqa: E731
    want, vjp = jax.vjp(fn, *(jnp.asarray(a, jdt) for a in (x, scale, bias)))
    want_grads = vjp(jnp.asarray(g, jdt))
    xt, st, bt = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (x, scale, bias))
    got = TM.layer_norm(xt, st, bt, 1e-5)
    got.backward(torch.from_numpy(g).to(tdt))
    for a, w in [(got.detach(), want)] + list(zip((xt.grad, st.grad, bt.grad), want_grads)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(a.float().numpy(), w, atol=tol * np.abs(w).max(), rtol=tol)


def test_layer_norm_inference_keeps_two_pass_moments():
    """Without autograd the LayerNorm is the two-pass primal, the serving
    path's arithmetic."""
    x, scale, bias, _ = _ln_inputs(1)
    with torch.no_grad():
        got = TM.layer_norm(*(torch.from_numpy(a) for a in (x, scale, bias)), 1e-5)
    want = JM._layer_norm_core(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-2)])
def test_gelu_vjp_matches_jax(dtype, tol):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4, 64)) * 3).astype(np.float32)
    g = rng.standard_normal((4, 64)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want, vjp = jax.vjp(JM.gelu_exact, jnp.asarray(x, jdt))
    (want_g,) = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    got = TM.gelu_exact(xt)
    got.backward(torch.from_numpy(g).to(tdt))
    for a, w in ((got.detach(), want), (xt.grad, want_g)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(a.float().numpy(), w, atol=tol * np.abs(w).max(), rtol=tol)
