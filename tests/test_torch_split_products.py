"""PyTorch port, the arithmetic of the f32 attention kernels on the CPU: f32
operands split into three bf16 parts (``split_bf16x3_plain``), and a product
of split operands as six bf16 products summed in f32 (``split_matmul_plain``),
then the f32 forwards with their two products and the f32 backwards with
their five taken that way against the JAX package's Pallas kernels in
interpret mode."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from multi_modal_early_exit_tpu.ops import flash_attention as jfa
from multi_modal_early_exit_tpu_torch.ops import flash_attention as tfa

# the f32 kernels against their f32 reference, over each output's largest
# value (chip_smoke.py's bar)
F32_BAR = 1e-4
# f32 accumulation over a depth of 64: 64 * 2^-24 = 3.8e-6 of the scale
DEPTH64_BAR = 4e-6
# the forwards' lse against the Pallas forward's, absolute (lse is of order
# 5 here, where one f32 ulp is 4.8e-7)
LSE_ATOL = 1e-6

# normal f32 magnitudes at which the split is exact: lo stays a normal
# bf16 above 2^-100 (its exponent is x's less 23 at the least), and bf16
# rounding of x stays finite up to 2^127
MAGNITUDES = st.floats(min_value=2.0 ** -100, max_value=2.0 ** 127, width=32,
                       allow_subnormal=False)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.tuples(MAGNITUDES, st.booleans()), min_size=1, max_size=64))
def test_split_restores_x_bit_for_bit(values):
    """hi + (mid + lo) is x in f32, bit for bit: both differences of the
    split are exact in f32, and the three parts carry x's 24 bits."""
    x = torch.tensor([-m if neg else m for m, neg in values], dtype=torch.float32)
    hi, mid, lo = tfa.split_bf16x3_plain(x).to(torch.float32)
    assert torch.equal(hi + (mid + lo), x)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    assert (mid.abs() <= 2.0 ** -8 * hi.abs()).all() and (lo.abs() <= 2.0 ** -8 * mid.abs()).all()


def test_split_products_are_exact_in_f32():
    """Each part is cast to f32 before it is multiplied: a bf16 x bf16
    product is exact in f32, as in the tensor cores (a product in bf16 would
    round it to 8 bits). At depth 1 the six-term product is therefore the
    six exact products of ``SPLIT_TERMS`` summed in that order in f32."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((64, 1)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((1, 64)).astype(np.float32))
    pa = tfa.split_bf16x3_plain(a).double()
    pb = tfa.split_bf16x3_plain(b).double()
    want = None
    for i, j in tfa.SPLIT_TERMS:
        exact = pa[i] @ pb[j]
        assert torch.equal(exact.float().double(), exact)  # representable in f32
        want = exact.float() if want is None else want + exact.float()
    assert torch.equal(tfa.split_matmul_plain(a, b), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("spread", [0.0, 3.0])
def test_six_term_product_at_depth_64(seed, spread):
    """At depth 64 the six-term product is within ``DEPTH64_BAR`` of the f64
    product's scale (f32 accumulation's 64 * 2^-24), also for operands whose
    magnitudes spread over e^+-3; one bf16 product misses that bar by far."""
    rng = np.random.default_rng(seed)

    def operand(shape):
        x = rng.standard_normal(shape) * np.exp(spread * rng.uniform(-1, 1, shape))
        return torch.from_numpy(x.astype(np.float32))

    a, b = operand((3, 96, 64)), operand((3, 64, 80))
    want = a.double() @ b.double()
    scale = want.abs().max()
    err = ((tfa.split_matmul_plain(a, b).double() - want).abs().max() / scale).item()
    assert err <= DEPTH64_BAR, err
    bf16 = a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    assert ((bf16.double() - want).abs().max() / scale).item() > 100 * DEPTH64_BAR


B, H, D, S, P = 2, 2, 64, 70, 128
SEED = 17


def _case(seed, layout):
    """f32 q, k, v, do (packed (B, S, H*D) or head form (B, H, S, D)), a
    bias with masked pad keys and a masked tail of keys, and a gbias."""
    rng = np.random.default_rng(seed)
    shape = (B, S, H * D) if layout == "packed" else (B, H, S, D)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    bias = rng.standard_normal((B, H, P, P)).astype(np.float32)
    bias[:, :, :, S:] = -1e30
    bias[0, :, :, 50:S] = -1e30
    gbias = (rng.standard_normal((B, H, P, P)) * 1e-3).astype(np.float32)
    return q, k, v, do, bias, gbias


def _assert_within_bar(got, wants):
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, wants):
        w = np.asarray(w)
        a = a.numpy()
        assert a.shape == w.shape, name
        err = np.abs(a - w).max() / np.abs(w).max()
        assert err <= F32_BAR, (name, err)


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("chained", [False, True])
def test_split_backward_matches_pallas_packed_backward(interpret_mode, rate, chained):
    """The packed f32 backward, plain and chained, with its five products
    through ``split_matmul_plain`` (the f32 kernels' arithmetic), against
    ``_flash_packed_bwd_impl`` in interpret mode on the same o and lse, at
    a ragged S (70 in P = 128): within ``F32_BAR`` of each output's scale."""
    q, k, v, do, bias, gbias = _case(3, "packed")
    seed = jnp.asarray([SEED], jnp.int32)
    o, lse = jfa._flash_packed_train_fwd_impl(
        *(jnp.asarray(a) for a in (q, k, v, bias)), seed, H, P, rate)
    wants = jfa._flash_packed_bwd_impl(
        *(jnp.asarray(a) for a in (q, k, v, bias)), seed, o, lse, jnp.asarray(do), H, P, rate,
        gbias=jnp.asarray(gbias) if chained else None)
    tq, tk, tv, tdo, tb, tg = (torch.from_numpy(a) for a in (q, k, v, do, bias, gbias))
    got = tfa.flash_attention_packed_train_bwd_plain(
        tq, tk, tv, tb, SEED, torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse)),
        tdo, H, rate, tg if chained else None, matmul=tfa.split_matmul_plain)
    _assert_within_bar(got, wants)


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_split_backward_matches_pallas_headform_backward(interpret_mode, rate):
    """The head-form f32 backward through ``split_matmul_plain`` against
    ``_flash_attention_bwd_impl`` in interpret mode on the same o and lse:
    within ``F32_BAR`` of each output's scale."""
    q, k, v, do, bias, _ = _case(4, "head")
    seed = jnp.asarray([SEED], jnp.int32)
    o, lse = jfa._flash_attention_fwd_impl(
        *(jnp.asarray(a) for a in (q, k, v, bias)), seed, P, rate, with_lse=True)
    wants = jfa._flash_attention_bwd_impl(
        *(jnp.asarray(a) for a in (q, k, v, bias)), seed, o, lse, jnp.asarray(do), P, rate)
    got = tfa.flash_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v, bias)), SEED, torch.from_numpy(np.array(o)),
        torch.from_numpy(np.array(lse)[..., 0]), torch.from_numpy(do), rate,
        matmul=tfa.split_matmul_plain)
    _assert_within_bar(got, wants)


def _assert_fwd_within_bar(out, want_out, lse=None, want_lse=None):
    """out within ``F32_BAR`` of its scale; the lse of the S real rows
    within ``LSE_ATOL``."""
    want_out = np.asarray(want_out)
    assert out.shape == want_out.shape
    err = np.abs(out.numpy() - want_out).max() / np.abs(want_out).max()
    assert err <= F32_BAR, ("out", err)
    if lse is not None:
        lse_err = np.abs(lse[:, :, :S].numpy() - np.asarray(want_lse)[:, :, :S]).max()
        assert lse_err <= LSE_ATOL, ("lse", lse_err)


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_split_forward_matches_pallas_packed_train_forward(interpret_mode, rate):
    """The packed f32 training forward (#7) with both products through
    ``split_matmul_plain`` (the f32 kernels' arithmetic) against
    ``_flash_packed_train_fwd_impl`` in interpret mode at a ragged S (70 in
    P = 128): out within ``F32_BAR`` of its scale, lse within ``LSE_ATOL``."""
    q, k, v, _, bias, _ = _case(5, "packed")
    o, lse = jfa._flash_packed_train_fwd_impl(
        *(jnp.asarray(a) for a in (q, k, v, bias)), jnp.asarray([SEED], jnp.int32), H, P, rate)
    got_o, got_lse = tfa.flash_attention_packed_train_fwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v, bias)), SEED, H, rate,
        matmul=tfa.split_matmul_plain)
    _assert_fwd_within_bar(got_o, o, got_lse, lse)


def test_split_forward_matches_pallas_headform_forward(interpret_mode):
    """The head-form f32 forward (#5) with the lse, through
    ``split_matmul_plain``, against ``_flash_attention_fwd_impl`` in
    interpret mode."""
    q, k, v, _, bias, _ = _case(6, "head")
    o, lse = jfa._flash_attention_fwd_impl(
        *(jnp.asarray(a) for a in (q, k, v, bias)), jnp.asarray([SEED], jnp.int32), P, 0.0,
        with_lse=True)
    got_o, got_lse = tfa.flash_attention_fwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v, bias)), SEED, 0.0,
        matmul=tfa.split_matmul_plain)
    _assert_fwd_within_bar(got_o, o, got_lse, np.asarray(lse)[..., 0])


def test_split_forward_matches_pallas_packed_forward(interpret_mode):
    """The serving forward ``flash_attention_packed`` (#2) in f32 through
    ``split_matmul_plain`` against ``_flash_packed_impl`` in interpret
    mode."""
    q, k, v, _, bias, _ = _case(7, "packed")
    want = jfa._flash_packed_impl(*(jnp.asarray(a) for a in (q, k, v, bias)), H, P)
    got = tfa.flash_attention_packed_plain(
        *(torch.from_numpy(a) for a in (q, k, v, bias)), H, matmul=tfa.split_matmul_plain)
    _assert_fwd_within_bar(got, want)


@pytest.fixture
def interpret_mode():
    """The Pallas kernels run interpreted, as the JAX package's tests run them."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield
