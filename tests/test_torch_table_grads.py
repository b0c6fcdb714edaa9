"""PyTorch port, ``table_grads_plain`` against the Pallas ``_table_grads``
kernel of the JAX package (interpret mode on the CPU), in both of its
arithmetics: ``index_add_`` over the bucket maps, and the one-hot products
that the CUDA kernel runs (f32 g as three bf16 parts)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multi_modal_early_exit_tpu.ops import fused_bias_attention as jfba
from multi_modal_early_exit_tpu_torch.ops.fused_bias_attention import table_grads_plain

torch.set_num_threads(2)

BINS = (32, 128, 64, 256)  # rel_bins, max_rel, rel2d_bins, max_rel2d


@pytest.fixture(autouse=True)
def interpret_mode():
    """CPU has no Mosaic TPU compiler; run the kernel interpreted."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _case(dtype, b=2, s=70, p=128, h=4, seed=5):
    """Ragged S inside P, positions in order and x0 / y1 in random word
    order; g of the given dtype, finite in the pad rows and columns."""
    rng = np.random.default_rng(seed)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    cx = rng.integers(0, 1000, (b, s)).astype(np.int32)
    cy = rng.integers(0, 1000, (b, s)).astype(np.int32)
    g = rng.standard_normal((b, h, p, p)).astype(np.float32)
    g_t = torch.from_numpy(g).to(dtype)
    g_j = jnp.asarray(g_t.float().numpy(), jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return pos, cx, cy, g_t, g_j


@pytest.mark.parametrize("onehot", [False, True], ids=["index_add", "onehot"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_table_grads_plain_matches_pallas(dtype, onehot):
    """Both sum the same g values into the same buckets in f32, in other
    orders: within 1e-5 of each table's scale. A bf16 g needs no wider bar:
    the Pallas kernel's bf16 one-hot products are exact, and so are the
    port's f32 sums of the bf16 values; the one-hot arithmetic's three bf16
    parts of an f32 g sum to it exactly."""
    pos, cx, cy, g_t, g_j = _case(dtype)
    want = jfba._table_grads(jnp.asarray(pos), jnp.asarray(cx), jnp.asarray(cy), g_j,
                             64, 64, *BINS)
    tt = torch.from_numpy
    got = table_grads_plain(tt(pos), tt(cx), tt(cy), g_t, *BINS, onehot=onehot)
    for a, w in zip(got, want):
        w = np.asarray(w)
        assert a.dtype == torch.float32 and a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0)
