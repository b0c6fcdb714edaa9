"""PyTorch port, training ops against the JAX package: the bias-table
gradients (``table_grads``, the backward of ``materialize_bias``) and the
packed training attention, forward and backward, plain and chained, with and
without dropout."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_modal_early_exit_tpu.models.layoutlmv3 import modeling as JM
from multi_modal_early_exit_tpu.models.layoutlmv3.config import (
    LayoutLMv3Config as JLayoutLMv3Config,
)
from multi_modal_early_exit_tpu.ops import flash_attention as jfa
from multi_modal_early_exit_tpu_torch.ops import flash_attention as tfa
from multi_modal_early_exit_tpu_torch.ops.fused_bias_attention import (
    materialize_bias,
    table_grads,
    table_grads_plain,
)

torch.set_num_threads(2)


def _bias_case(seed=11, b=2, s=20, h=4, p=128):
    cfg = JLayoutLMv3Config.tiny()
    rng = np.random.default_rng(seed)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    x0 = rng.integers(0, 900, (b, s, 1))
    y0 = rng.integers(0, 900, (b, s, 1))
    bbox = np.concatenate([x0, y0, x0 + 40, y0 + 25], -1).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, -5:] = 0
    tables = [rng.standard_normal((n, h)).astype(np.float32)
              for n in (cfg.rel_pos_bins, cfg.rel_2d_pos_bins, cfg.rel_2d_pos_bins)]
    g = rng.standard_normal((b, h, p, p)).astype(np.float32)  # pad region too
    return cfg, pos, bbox, mask, tables, g


def _jax_table_grads(cfg, pos, bbox, mask, tables, g):
    """jax.vjp of the tables through the XLA bias chain, padded to P."""
    def bias_fn(t1, tx, ty):
        params = {"encoder": {"rel_pos_bias": t1, "rel_pos_x_bias": tx,
                              "rel_pos_y_bias": ty}}
        return JM.make_attention_bias(
            params, cfg, jnp.asarray(pos), jnp.asarray(bbox), jnp.asarray(mask),
            dtype=jnp.float32, pad_to=g.shape[-1],
        )
    _, vjp = jax.vjp(bias_fn, *(jnp.asarray(t) for t in tables))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def test_table_grads_plain_matches_jax_bias_vjp():
    """dT of the unscaled tables = scale * table_grads(g): equal to the JAX
    gradient to 1e-5 of its scale (f32 sums of up to B*S*S terms in another
    order). The finite pad rows and the pad columns of g carry no gradient."""
    cfg, pos, bbox, mask, tables, g = _bias_case()
    want = _jax_table_grads(cfg, pos, bbox, mask, tables, g)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = table_grads_plain(
        tt(pos), tt(bbox[:, :, 0]), tt(bbox[:, :, 3]), tt(g),
        cfg.rel_pos_bins, cfg.max_rel_pos, cfg.rel_2d_pos_bins, cfg.max_rel_2d_pos,
    )
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy() * scale, w, atol=1e-5 * np.abs(w).max(), rtol=1e-5)


def test_materialize_bias_backward_is_table_grads():
    """Autograd through the port's bias builder (CPU) lands on table_grads,
    which on CPU tensors is the plain version."""
    cfg, pos, bbox, mask, tables, g = _bias_case(seed=12, b=3, s=30)
    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    ts = [tt(t).requires_grad_() for t in tables]
    vecs = (tt(pos), tt(bbox[:, :, 0]), tt(bbox[:, :, 3]))
    buckets = (cfg.rel_pos_bins, cfg.max_rel_pos, cfg.rel_2d_pos_bins, cfg.max_rel_2d_pos)
    bias = materialize_bias(*vecs, tt(mask), *ts, *buckets, out_dtype=torch.float32)
    bias.backward(tt(g))
    want = table_grads(*vecs, tt(g), *buckets)
    for t, w in zip(ts, want):
        torch.testing.assert_close(t.grad, w, atol=0, rtol=0)


B, H, S, D, P = 2, 3, 20, 16, 128


def _attn_case(seed=0, dtype=np.float32, s=S, p=P):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, s, H * D)).astype(dtype) for _ in range(4))
    bias = rng.standard_normal((B, H, p, p)).astype(np.float32)
    bias[:, :, :, s:] = -1e30  # pad keys
    bias[0, :, :, 15:s] = -1e30  # masked keys
    gbias = rng.standard_normal((B, H, p, p)).astype(np.float32)
    return q, k, v, do, bias, gbias


def _jax_reference(q, k, v, bias, seed, rate):
    """jax.vjp of reference_attention_hash_dropout on the packed layout."""
    def split(x):
        return x.reshape(B, S, H, D).transpose(0, 2, 1, 3)

    def fn(q, k, v, b):
        o = jfa.reference_attention_hash_dropout(split(q), split(k), split(v), b,
                                                 jnp.int32(seed), rate)
        return o.transpose(0, 2, 1, 3).reshape(B, S, H * D)

    return jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v, bias)))


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("chained", [False, True])
def test_train_attention_plain_matches_jax_reference(rate, chained):
    """Forward and dq/dk/dv/dbias against the jnp reference with the same
    position-hash mask, f32: to 1e-5 of each tensor's scale (f32 sums in
    another order). Chained: dbias = gbias + ds over the whole P x P plane,
    ds being zero in the pad rows and columns."""
    q, k, v, do, bias, gbias = _attn_case()
    seed = 31
    want, vjp = _jax_reference(q, k, v, bias, seed, rate)
    wq, wk, wv, wb = (np.asarray(x) for x in vjp(jnp.asarray(do)))
    wb = np.where((np.arange(P) < S)[:, None] & (np.arange(P) < S)[None, :], wb, 0.0)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    if chained:
        out, bias_out = tfa.flash_attention_packed_train_chained(*ts, seed, H, rate)
        assert torch.equal(bias_out.detach(), ts[3].detach())
        ((out * torch.from_numpy(do)).sum()
         + (bias_out * torch.from_numpy(gbias)).sum()).backward()
        wb = wb + gbias
    else:
        out = tfa.flash_attention_packed_train(*ts, seed, H, rate)
        (out * torch.from_numpy(do)).sum().backward()
    for a, w in [(out.detach(), want)] + list(zip((t.grad for t in ts), (wq, wk, wv, wb))):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=1e-5)


def test_train_forward_lse_and_dropout_semantics():
    """lse is the undropped logsumexp of the scores (+inf past S), and at
    rate r about r of the probabilities are dropped."""
    q, k, v, _, bias, _ = _attn_case(1)
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    _, lse = tfa.flash_attention_packed_train_fwd_plain(tq, tk, tv, tb, 5, H, 0.5)
    scores = (tfa._heads(tq, H) @ tfa._heads(tk, H).transpose(-1, -2)) / math.sqrt(D)
    want = torch.logsumexp(scores + tb[:, :, :S, :S], dim=-1)
    torch.testing.assert_close(lse[:, :, :S], want, atol=1e-5, rtol=1e-6)
    assert torch.isinf(lse[:, :, S:]).all()
    c = tfa.attention_dropout_scale(5, 8, 4, 64, 0.25, "cpu")
    assert set(c.unique().tolist()) == {0.0, np.float32(1 / 0.75)}
    assert abs((c == 0).float().mean().item() - 0.25) < 0.01


def _check_chained_against_pallas(case, rate):
    """The chained op's output and gradients (a non-trivial bias cotangent
    in) against the Pallas kernel pair in interpret mode: to 1e-4 of each
    tensor's scale."""
    from jax.experimental.pallas import tpu as pltpu

    q, k, v, do, bias, gbias = case
    seed = jnp.asarray([17], jnp.int32)

    def fn(q, k, v, b):
        return jfa.flash_attention_packed_train_chained(q, k, v, b, seed, H, rate=rate)

    with pltpu.force_tpu_interpret_mode():
        (want_o, want_b), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v, bias)))
        wants = vjp((jnp.asarray(do), jnp.asarray(gbias)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    out, bias_out = tfa.flash_attention_packed_train_chained(*ts, 17, H, rate)
    ((out * torch.from_numpy(do)).sum() + (bias_out * torch.from_numpy(gbias)).sum()).backward()
    for a, w in [(out.detach(), want_o)] + list(zip((t.grad for t in ts), wants)):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=1e-4)


@pytest.mark.slow
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_train_attention_matches_pallas_kernel(rate):
    """The chained op against the Pallas kernel pair in interpret mode,
    f32, gradients included: to 1e-4 of each tensor's scale."""
    _check_chained_against_pallas(_attn_case(2), rate)


@pytest.mark.parametrize("s,p", [(70, 128), (130, 192)])
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_train_attention_matches_pallas_kernel_at_ragged_s(s, p, rate):
    """The same at an S that is not a multiple of 64, so the CUDA kernels'
    64-row tiles end ragged, and (130 in 192) at an odd P / 64: the plain
    version the card holds the kernels to, against the Pallas pair."""
    _check_chained_against_pallas(_attn_case(3, s=s, p=p), rate)
