"""PyTorch port, ops: bucketing, the bias kernel, packed attention and the
exit criteria against the JAX package (Pallas kernels in interpret mode)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multi_modal_early_exit_tpu.models.layoutlmv3 import modeling as JM
from multi_modal_early_exit_tpu.models.layoutlmv3.config import (
    LayoutLMv3Config as JLayoutLMv3Config,
)
from multi_modal_early_exit_tpu.ops import criteria as jcrit
from multi_modal_early_exit_tpu.ops import flash_attention as jfa
from multi_modal_early_exit_tpu.ops import fused_bias_attention as jfb
from multi_modal_early_exit_tpu_torch.ops import criteria as tcrit
from multi_modal_early_exit_tpu_torch.ops.flash_attention import (
    flash_attention_packed,
    flash_attention_packed_plain,
)
from multi_modal_early_exit_tpu_torch.ops.fused_bias_attention import (
    materialize_bias,
    relative_position_bucket,
)
from multi_modal_early_exit_tpu_torch.utils.profiling import launch_counts

torch.set_num_threads(2)


@pytest.mark.parametrize(
    "num_buckets,max_distance",
    [(8, 32), (16, 64), (32, 128), (64, 256)],  # tiny 1D/2D, base 1D/2D
)
def test_bucket_lookup_equals_jax_exactly(num_buckets, max_distance):
    rel = np.arange(-1100, 1101, dtype=np.int32)
    want = np.asarray(
        JM.relative_position_bucket(jnp.asarray(rel), num_buckets, max_distance)
    )
    got = relative_position_bucket(torch.from_numpy(rel), num_buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), want)


def _bias_inputs(seed, b=2, s=20, h=4):
    cfg = JLayoutLMv3Config.tiny()
    rng = np.random.default_rng(seed)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    x0 = rng.integers(0, 900, (b, s, 1))
    y0 = rng.integers(0, 900, (b, s, 1))
    bbox = np.concatenate([x0, y0, x0 + 40, y0 + 25], -1).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[0, -4:] = 0
    t1 = rng.standard_normal((cfg.rel_pos_bins, h)).astype(np.float32)
    tx = rng.standard_normal((cfg.rel_2d_pos_bins, h)).astype(np.float32)
    ty = rng.standard_normal((cfg.rel_2d_pos_bins, h)).astype(np.float32)
    return cfg, pos, bbox, mask, t1, tx, ty


def _port_bias(cfg, pos, bbox, mask, t1, tx, ty, out_dtype=torch.float32):
    scale = 1.0 / math.sqrt(cfg.head_dim)
    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return materialize_bias(
        tt(pos), tt(bbox[:, :, 0]), tt(bbox[:, :, 3]), tt(mask),
        tt(t1) * scale, tt(tx) * scale, tt(ty) * scale,
        rel_bins=cfg.rel_pos_bins, max_rel=cfg.max_rel_pos,
        rel2d_bins=cfg.rel_2d_pos_bins, max_rel2d=cfg.max_rel_2d_pos,
        out_dtype=out_dtype,
    ).float().numpy()


def test_plain_bias_matches_make_attention_bias():
    """f32 plain bias vs the XLA chain make_attention_bias(pad_to=P):
    within 1e-6 on unmasked entries, <= -1e29 on masked and pad keys."""
    cfg, pos, bbox, mask, t1, tx, ty = _bias_inputs(4)
    s = pos.shape[1]
    params = {"encoder": {"rel_pos_bias": jnp.asarray(t1),
                          "rel_pos_x_bias": jnp.asarray(tx),
                          "rel_pos_y_bias": jnp.asarray(ty)}}
    want = np.asarray(JM.make_attention_bias(
        params, cfg, jnp.asarray(pos), jnp.asarray(bbox), jnp.asarray(mask),
        dtype=jnp.float32, pad_to=128,
    ))
    got = _port_bias(cfg, pos, bbox, mask, t1, tx, ty)
    assert got.shape == want.shape == (2, 4, 128, 128)
    np.testing.assert_allclose(got[1, :, :s, :s], want[1, :, :s, :s], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[0, :, :s, :s - 4], want[0, :, :s, :s - 4],
                               atol=1e-6, rtol=0)
    assert (got[:, :, :, s:] <= -1e29).all()
    assert (got[0, :, :, s - 4:s] <= -1e29).all()
    assert np.isfinite(got).all()  # -1e30 sentinels, finite pad rows


def test_plain_bias_matches_pallas_kernel():
    """bf16 plain bias vs the Pallas kernel (interpret mode), at the bars
    of tests/test_fused_bias_attention.py."""
    from jax.experimental.pallas import tpu as pltpu

    cfg, pos, bbox, mask, t1, tx, ty = _bias_inputs(5)
    s = pos.shape[1]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfb.materialize_bias(
            jnp.asarray(pos), jnp.asarray(bbox[:, :, 0]), jnp.asarray(bbox[:, :, 3]),
            jnp.asarray(mask), jnp.asarray(t1 * scale), jnp.asarray(tx * scale),
            jnp.asarray(ty * scale),
            rel_bins=cfg.rel_pos_bins, max_rel=cfg.max_rel_pos,
            rel2d_bins=cfg.rel_2d_pos_bins, max_rel2d=cfg.max_rel_2d_pos,
        ), np.float32)
    got = _port_bias(cfg, pos, bbox, mask, t1, tx, ty, out_dtype=torch.bfloat16)
    np.testing.assert_allclose(got[1, :, :s, :s], want[1, :, :s, :s], atol=5e-3, rtol=1e-2)
    np.testing.assert_allclose(got[0, :, :s, :s - 4], want[0, :, :s, :s - 4],
                               atol=5e-3, rtol=1e-2)
    assert (got[:, :, :s, s:] <= -1e29).all() and (want[:, :, :s, s:] < -1e29).all()


def _qkvb(seed, b, s, h, d, p, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h * d)).astype(dtype) for _ in range(3))
    bias = rng.standard_normal((b, h, p, p)).astype(np.float32)
    bias[:, :, :, s:] = -1e30
    bias[1, :, :, s - 3:s] = -1e30  # masked keys
    return q, k, v, bias


def test_plain_attention_matches_reference_attention_f32():
    b, s, h, d = 2, 24, 4, 16
    q, k, v, bias = _qkvb(0, b, s, h, d, s)
    heads = lambda x: jnp.asarray(x).reshape(b, s, h, d).transpose(0, 2, 1, 3)  # noqa
    want = np.asarray(jfa.reference_attention(heads(q), heads(k), heads(v),
                                              jnp.asarray(bias)))
    want = want.transpose(0, 2, 1, 3).reshape(b, s, h * d)
    got = flash_attention_packed(*(torch.from_numpy(x) for x in (q, k, v, bias)), h)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


# bf16: a bf16 output step; f32: the CUDA kernel's f32 bar (1e-4 of scale)
# is held against this plain version, which must agree with the Pallas
# kernel's f32 products to f32 rounding
PACKED_DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16, 2e-2),
                 "f32": (jnp.float32, torch.float32, 1e-5)}


@pytest.mark.parametrize("dtype", sorted(PACKED_DTYPES))
@pytest.mark.parametrize("s,p", [(24, 24), (20, 128)])  # p > s: pre-padded bias
def test_plain_attention_matches_pallas_packed_kernel(s, p, dtype):
    """The same inputs in ``dtype`` through the Pallas packed kernel
    (interpret mode) and the plain version."""
    from jax.experimental.pallas import tpu as pltpu

    jdt, tdt, tol = PACKED_DTYPES[dtype]
    b, h, d = 2, 4, 32
    q, k, v, bias = _qkvb(1, b, s, h, d, p)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfa.flash_attention_packed(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt),
            jnp.asarray(v, jdt), jnp.asarray(bias, jdt), h,
        ), np.float32)
    tb = lambda x: torch.from_numpy(x).to(tdt)  # noqa: E731
    got = flash_attention_packed(tb(q), tb(k), tb(v), tb(bias), h).float().numpy()
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_wrapper_cpu_path_is_the_plain_version():
    b, s, h, d = 2, 16, 2, 8
    q, k, v, bias = (torch.from_numpy(x) for x in _qkvb(2, b, s, h, d, 128))
    before = launch_counts().get("flash_attention_packed", 0)
    a = flash_attention_packed(q, k, v, bias, h)
    torch.testing.assert_close(a, flash_attention_packed_plain(q, k, v, bias, h),
                               rtol=0, atol=0)
    assert launch_counts().get("flash_attention_packed", 0) == before  # no kernel on the CPU


@pytest.mark.parametrize("fn", ["entropy", "max_confidence", "lte"])
def test_criteria_match_jax(fn):
    rng = np.random.default_rng(7)
    x = (3 * rng.standard_normal((3, 5, 16))).astype(np.float32)
    want = np.asarray(getattr(jcrit, fn)(jnp.asarray(x)))
    got = getattr(tcrit, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_patience_counts_match_jax():
    rng = np.random.default_rng(8)
    store = rng.integers(0, 3, (6, 10, 3)).astype(np.float32)  # many ties
    want = np.asarray(jcrit.patience_counts(jnp.asarray(store)))
    np.testing.assert_array_equal(
        tcrit.patience_counts(torch.from_numpy(store)).numpy(), want
    )
