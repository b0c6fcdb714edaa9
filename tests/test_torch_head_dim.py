"""PyTorch port, head dims other than the kernels' 64 (the tiny configs'
D = 16; D = 96 from a checkpoint's config; 128; and the wide mode's head
dims above 128).

On CUDA tensors every attention entry point pads q, k and v's head dim D
with zeros to the smallest kernel width that holds it (``at_kernel_head_dim``:
``pad_head_dim``, 16 -> 64, 96 -> 128, 200 -> 256; a multiple of 64 above
128 is a width of the kernels' wide mode), runs there with the scale of the
true D and slices the output; autograd slices the gradients. Here
``_kernel_layout`` is forced on, so the entry points take that path on CPU
tensors: pad, the plain versions at the kernel width, slice. Each is held
against the JAX package's Pallas kernels in interpret mode (as
tests/test_flash_attention.py runs them) at D = 16 and 32 (H = 4) and at
D = 96, 128, 192, 256 and 320 (H = 2), S = 70 inside P = 128, within the
bars the D = 64 tests of the same functions use. f32 inputs from numpy
seeds.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_modal_early_exit_tpu.models.layoutlmv3.config import (
    LayoutLMv3Config as JLayoutLMv3Config,
)
from multi_modal_early_exit_tpu.ops import flash_attention as jfa
from multi_modal_early_exit_tpu.ops import fused_bias_attention as jfba
from multi_modal_early_exit_tpu_torch.ops import flash_attention as tfa
from multi_modal_early_exit_tpu_torch.ops import fused_bias_attention as tfba

torch.set_num_threads(2)

B, H, S, P = 2, 4, 70, 128
FWD_TOL = dict(atol=2e-5, rtol=1e-4)   # tests/test_torch_flash_headform.py
GRAD_TOL = dict(atol=3e-5, rtol=1e-4)
HEAD_DIMS = [16, 32, 96, 128, 192, 256, 320]


def _h(d):
    """Heads of the case at head dim d: 4 up to 64, 2 above."""
    return H if d <= 64 else 2


@pytest.fixture(autouse=True)
def interpret_mode():
    """The Pallas kernels run interpreted, as the JAX package's tests run them."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture
def kernel_layout(monkeypatch):
    """The entry points pad as for the kernels; returns the head dims the
    plain versions saw (they run where the kernels would)."""
    seen = []
    for name in ("flash_attention_packed_plain", "flash_attention_fwd_plain",
                 "flash_attention_bwd_plain", "flash_attention_packed_train_fwd_plain",
                 "flash_attention_packed_train_bwd_plain"):
        fn = getattr(tfa, name)
        packed = "packed" in name  # packed (B, S, H*D), else (B, H, S, D)

        def spy(*args, _fn=fn, _packed=packed, **kwargs):
            heads = args[3].shape[1] if _packed else 1  # the bias is (B, H, P, P)
            seen.append(args[0].shape[-1] // heads)
            return _fn(*args, **kwargs)

        monkeypatch.setattr(tfa, name, spy)
    monkeypatch.setattr(tfa, "_kernel_layout", lambda x: True)
    return seen


def _packed_case(seed, d, dtype=np.float32):
    """numpy f32 packed q, k, v and a cotangent (B, S, h*d), a (B, h, P, P)
    bias with masked pad keys and a masked tail of keys in one sample, and
    a bias cotangent; h = _h(d)."""
    rng = np.random.default_rng(seed)
    h = _h(d)
    q, k, v, do = (rng.standard_normal((B, S, h * d)).astype(dtype) for _ in range(4))
    bias = rng.standard_normal((B, h, P, P)).astype(np.float32)
    bias[:, :, :, S:] = -1e30
    bias[0, :, :, 50:S] = -1e30
    gbias = rng.standard_normal((B, h, P, P)).astype(np.float32)
    return q, k, v, do, bias, gbias


def _heads(x, d):
    return x.reshape(B, S, _h(d), d).transpose(0, 2, 1, 3)


def _jax_grads(fn, arrays, g):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in arrays))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port_grads(fn, arrays, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_packed_attention_at_the_kernel_head_dim_matches_pallas(kernel_layout, d):
    """#2 ``flash_attention_packed`` and its gradients (the head-form pair
    #5/#6 in its backward) against ``jax.vjp`` of the Pallas op."""
    q, k, v, do, bias, _ = _packed_case(0, d)
    h = _h(d)
    want_o, wants = _jax_grads(lambda q, k, v, b: jfa.flash_attention_packed(q, k, v, b, h),
                               (q, k, v, bias), do)
    got_o, gots = _port_grads(lambda q, k, v, b: tfa.flash_attention_packed(q, k, v, b, h),
                              (q, k, v, bias), do)
    assert kernel_layout and set(kernel_layout) == {tfa.kernel_head_dim(d)}
    assert got_o.shape == (B, S, h * d)
    np.testing.assert_allclose(got_o, want_o, **FWD_TOL)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), gots, wants):
        np.testing.assert_allclose(a, w, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_headform_attention_at_the_kernel_head_dim_matches_pallas(kernel_layout, d):
    """#5/#6 ``flash_attention`` on (B, H, S, D) tensors, forward and
    gradients, against ``jax.vjp`` of the Pallas op."""
    q, k, v, do, bias, _ = _packed_case(1, d)
    arrays = [np.ascontiguousarray(_heads(x, d)) for x in (q, k, v)] + [bias]
    g = np.ascontiguousarray(_heads(do, d))
    want_o, wants = _jax_grads(lambda q, k, v, b: jfa.flash_attention(q, k, v, b, 16), arrays, g)
    got_o, gots = _port_grads(lambda q, k, v, b: tfa.flash_attention(q, k, v, b, 16), arrays, g)
    assert kernel_layout and set(kernel_layout) == {tfa.kernel_head_dim(d)}
    np.testing.assert_allclose(got_o, want_o, **FWD_TOL)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), gots, wants):
        np.testing.assert_allclose(a, w, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("chained", [False, True])
def test_train_attention_at_the_kernel_head_dim_matches_pallas(kernel_layout, d, rate, chained):
    """#7/#8 ``flash_attention_packed_train`` and its chained twin (a
    non-trivial bias cotangent in), forward and gradients, against the
    Pallas pair: to 1e-4 of each tensor's scale, as at D = 64
    (tests/test_torch_train_ops.py). The dropout hash does not see D."""
    q, k, v, do, bias, gbias = _packed_case(2, d)
    h = _h(d)
    seed = jnp.asarray([17], jnp.int32)
    arrays = [jnp.asarray(a) for a in (q, k, v, bias)]
    if chained:
        def fn(q, k, v, b):
            return jfa.flash_attention_packed_train_chained(q, k, v, b, seed, h, rate=rate)

        (want_o, _), vjp = jax.vjp(fn, *arrays)
        wants = vjp((jnp.asarray(do), jnp.asarray(gbias)))
    else:
        want_o, vjp = jax.vjp(
            lambda q, k, v, b: jfa.flash_attention_packed_train(q, k, v, b, seed, h, rate=rate),
            *arrays)
        wants = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    if chained:
        out, bias_out = tfa.flash_attention_packed_train_chained(*ts, 17, h, rate)
        loss = (out * torch.from_numpy(do)).sum() + (bias_out * torch.from_numpy(gbias)).sum()
    else:
        out = tfa.flash_attention_packed_train(*ts, 17, h, rate)
        loss = (out * torch.from_numpy(do)).sum()
    loss.backward()
    assert kernel_layout and set(kernel_layout) == {tfa.kernel_head_dim(d)}
    assert out.shape == (B, S, h * d)
    for a, w in [(out.detach(), want_o)] + list(zip((t.grad for t in ts), wants)):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=1e-4)


def _fused_case(seed, d):
    cfg = JLayoutLMv3Config.tiny()
    rng = np.random.default_rng(seed)
    h = _h(d)
    qkv = [rng.standard_normal((B, S, h, d)).astype(np.float32) for _ in range(3)]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    x0 = rng.integers(0, 900, (B, S, 1))
    y0 = rng.integers(0, 900, (B, S, 1))
    bbox = np.concatenate([x0, y0, x0 + 50, y0 + 30], -1).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, -9:] = 0
    scale = 1.0 / math.sqrt(d)
    tables = [(rng.standard_normal((n, h)) * scale).astype(np.float32)
              for n in (cfg.rel_pos_bins, cfg.rel_2d_pos_bins, cfg.rel_2d_pos_bins)]
    bins = dict(rel_bins=cfg.rel_pos_bins, max_rel=cfg.max_rel_pos,
                rel2d_bins=cfg.rel_2d_pos_bins, max_rel2d=cfg.max_rel_2d_pos)
    return qkv, [pos, bbox[:, :, 0].copy(), bbox[:, :, 3].copy(), mask], tables, bins


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_fused_bias_attention_at_the_kernel_head_dim_matches_pallas(monkeypatch, d):
    """#3 ``fused_bias_attention`` through the padding (its plain version at
    64 with the true scale, then sliced) against the Pallas kernel, whose
    table lookups and bias tile are bf16: the 5e-3 / 1e-2 of the D = 8
    test (tests/test_torch_bias_modes.py), on the rows of real tokens."""
    qkv, vecs, tables, bins = _fused_case(3, d)
    want = np.asarray(jfba.fused_bias_attention(
        *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in qkv), *(jnp.asarray(a) for a in vecs),
        *(jnp.asarray(t) for t in tables), block_q=8, block_k=8, **bins))
    seen = []
    plain = tfba.fused_bias_attention_plain

    def spy(q, *args, **kwargs):
        seen.append(q.shape[-1])
        return plain(q, *args, **kwargs)

    monkeypatch.setattr(tfba, "fused_bias_attention_plain", spy)
    monkeypatch.setattr(tfa, "_kernel_layout", lambda x: True)
    got = tfba.fused_bias_attention(
        *(torch.from_numpy(a).transpose(1, 2) for a in qkv), *(torch.from_numpy(a) for a in vecs),
        *(torch.from_numpy(t) for t in tables), **bins).numpy()
    assert seen == [tfa.kernel_head_dim(d)] and got.shape == (B, _h(d), S, d)
    np.testing.assert_allclose(got[0], want[0], atol=5e-3, rtol=1e-2)
    np.testing.assert_allclose(got[1, :, :-9], want[1, :, :-9], atol=5e-3, rtol=1e-2)


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("layout", ["contiguous", "packed"])
def test_fused_plain_is_bit_equal_to_the_pair(d, layout):
    """``fused_bias_attention_plain`` is ``materialize_bias_plain`` in q's
    dtype then ``flash_attention_packed_plain``, f32: bit-equal to the pair
    on the packed projections, as the card holds the kernel to the kernels
    of the pair."""
    qkv, vecs, tables, bins = _fused_case(4, d)
    packed = [torch.from_numpy(a.reshape(B, S, H * d)) for a in qkv]
    views = [x.view(B, S, H, d).transpose(1, 2) for x in packed]
    if layout == "contiguous":
        views = [x.contiguous() for x in views]
    args = [torch.from_numpy(a) for a in vecs] + [torch.from_numpy(t) for t in tables]
    got = tfba.fused_bias_attention(*views, *args, **bins)
    bias = tfba.materialize_bias_plain(*args, **bins, out_dtype=torch.float32)
    pair = tfa.flash_attention_packed_plain(*packed, bias, H)
    assert torch.equal(got.transpose(1, 2).reshape(B, S, H * d), pair)


def _entries(d):
    """Each entry point as a call on tensors of head dim ``d``."""
    q, k, v, do, bias, _ = _packed_case(5, d)
    h = _h(d)
    qkv = [torch.from_numpy(a) for a in (q, k, v)]
    tb = torch.from_numpy(bias)
    heads = [torch.from_numpy(np.ascontiguousarray(_heads(a, d))) for a in (q, k, v)]
    fq, vecs, tables, bins = _fused_case(6, d)
    vt = [torch.from_numpy(a) for a in vecs]
    tt = [torch.from_numpy(t) for t in tables]
    return {
        "flash_attention_packed": lambda: tfa.flash_attention_packed(*qkv, tb, h),
        "flash_attention_packed_train": lambda: tfa.flash_attention_packed_train(
            *qkv, tb, 3, h, 0.1),
        "flash_attention_packed_train_chained": lambda: tfa.flash_attention_packed_train_chained(
            *qkv, tb, 3, h, 0.1),
        "flash_attention_packed_train_tables": lambda: tfa.flash_attention_packed_train_tables(
            *qkv, tb, *tt, *vt[:3], 3, h, 0.1, **bins),
        "flash_attention": lambda: tfa.flash_attention(*heads, tb),
        "fused_bias_attention": lambda: tfba.fused_bias_attention(
            *(torch.from_numpy(a).transpose(1, 2) for a in fq), *vt, *tt, **bins),
    }


ENTRIES = list(_entries(8))


@pytest.mark.parametrize("entry", ENTRIES)
def test_a_head_dim_above_the_kernels_raises(monkeypatch, entry):
    """Above 128, where the entry points raised before the kernels' wide
    mode: D = 320 runs at the wide width 320 as it is, and D = 200 runs
    padded to 256, its output sliced back to 200."""
    monkeypatch.setattr(tfa, "_kernel_layout", lambda x: True)
    pad = tfa.pad_head_dim
    for d, width in ((320, 320), (200, 256)):
        widths = []
        monkeypatch.setattr(tfa, "pad_head_dim",
                            lambda x, *a: widths.append(pad(x, *a).shape[-1]) or pad(x, *a))
        out = _entries(d)[entry]()
        out = out[0] if isinstance(out, tuple) else out
        assert out.shape[-1] in (d, _h(d) * d) and torch.isfinite(out).all()
        want = set() if width == d else ({width} if out.shape[-1] == d else {_h(d) * width})
        assert set(widths) == want, (d, widths)


@pytest.mark.parametrize("entry", ENTRIES)
def test_a_head_dim_between_the_kernel_widths_runs_padded(monkeypatch, entry):
    """D = 96 (where D = 64 and 128 have kernels) runs: padded to 128, its
    output sliced back to 96."""
    monkeypatch.setattr(tfa, "_kernel_layout", lambda x: True)
    widths = []
    pad = tfa.pad_head_dim
    monkeypatch.setattr(tfa, "pad_head_dim",
                        lambda x, *a: widths.append(pad(x, *a).shape[-1]) or pad(x, *a))
    out = _entries(96)[entry]()
    out = out[0] if isinstance(out, tuple) else out
    assert out.shape[-1] in (96, _h(96) * 96) and widths
    assert set(widths) == ({128} if out.shape[-1] == 96 else {_h(96) * 128})


@pytest.mark.parametrize("entry", ENTRIES)
def test_cpu_entries_run_the_head_dim_as_it_is(monkeypatch, entry):
    """Without the kernels' layout (CPU tensors) nothing is padded, and a
    head dim of 96 runs."""
    calls = []
    pad = tfa.pad_head_dim
    monkeypatch.setattr(tfa, "pad_head_dim", lambda *a: calls.append(1) or pad(*a))
    out = _entries(96)[entry]()
    out = out[0] if isinstance(out, tuple) else out
    assert out.shape[-1] in (96, _h(96) * 96) and not calls


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_pad_head_dim_adds_zero_columns(d):
    """Both layouts: the first d columns of each head are x, the rest 0, up
    to the next kernel width."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((B, S, H * d)).astype(np.float32))
    width = tfa.kernel_head_dim(d)
    packed = tfa.pad_head_dim(x, H).view(B, S, H, width)
    assert torch.equal(packed[..., :d], x.view(B, S, H, d)) and not packed[..., d:].any()
    heads = x.view(B, S, H, d).transpose(1, 2)
    padded = tfa.pad_head_dim(heads)
    assert padded.is_contiguous() and padded.shape == (B, H, S, width)
    assert torch.equal(padded[..., :d], heads) and not padded[..., d:].any()
