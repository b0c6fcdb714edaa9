"""PyTorch port, CUDA kernels against their plain versions on an sm_90 card.

Every test here needs an NVIDIA Hopper card and skips elsewhere; run them
on the card with ``python -m pytest tests/test_torch_cuda_kernels.py -q``.
"""

import math

import pytest
import torch

from multi_modal_early_exit_tpu_torch.ops.flash_attention import (
    flash_attention_packed,
    flash_attention_packed_plain,
    flash_attention_packed_train,
    flash_attention_packed_train_bwd,
    flash_attention_packed_train_bwd_plain,
    flash_attention_packed_train_fwd,
    flash_attention_packed_train_fwd_plain,
    flash_attention_packed_train_tables,
    flash_attention_packed_train_tables_bwd,
    flash_attention_packed_train_tables_bwd_plain,
)
from multi_modal_early_exit_tpu_torch.ops.fused_bias_attention import (
    fused_bias_attention,
    fused_bias_attention_plain,
    materialize_bias,
    materialize_bias_plain,
    table_grads,
    table_grads_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) CUDA device")
    return torch.device("cuda")


def _bias_args(device, b, s, h, bins=(32, 64), seed=0):
    g = torch.Generator().manual_seed(seed)
    pos = torch.arange(s, dtype=torch.int32).repeat(b, 1)
    cx = torch.randint(0, 1000, (b, s), generator=g, dtype=torch.int32)
    cy = torch.randint(0, 1000, (b, s), generator=g, dtype=torch.int32)
    mask = torch.ones((b, s), dtype=torch.int32)
    mask[0, s // 2:] = 0
    scale = 1.0 / math.sqrt(64)
    t1 = torch.randn((bins[0], h), generator=g) * scale
    tx = torch.randn((bins[1], h), generator=g) * scale
    ty = torch.randn((bins[1], h), generator=g) * scale
    return [x.to(device) for x in (pos, cx, cy, mask, t1, tx, ty)]


@pytest.mark.parametrize("b,s,h", [(2, 20, 4), (3, 300, 12), (16, 709, 12)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_materialize_bias_kernel_is_bit_equal_to_plain(cuda, b, s, h, dtype):
    args = _bias_args(cuda, b, s, h)
    before = materialize_bias.launches
    got = materialize_bias(*args, out_dtype=dtype)
    assert materialize_bias.launches == before + 1
    want = materialize_bias_plain(*args, out_dtype=dtype)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.equal(got, want)


def _qkv(device, b, s, h, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, s, h * 64), generator=g).to(device, torch.bfloat16)
            for _ in range(3)]


@pytest.mark.parametrize("b,s,p,h", [(2, 64, 64, 2), (2, 20, 128, 4),
                                     (3, 709, 768, 12), (1, 130, 130, 3)])
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_matches_plain(cuda, b, s, p, h, bias_dtype):
    q, k, v = _qkv(cuda, b, s, h)
    g = torch.Generator().manual_seed(1)
    bias = torch.randn((b, h, p, p), generator=g)
    bias[:, :, :, s:] = -1e30
    bias[0, :, :, s // 3:] = -1e30  # masked keys
    bias[-1, 0, 1, :] = -1e30       # one query row with every key masked
    bias = bias.to(cuda, bias_dtype)
    before = flash_attention_packed.launches
    got = flash_attention_packed(q, k, v, bias, h)
    assert flash_attention_packed.launches == before + 1
    want = flash_attention_packed_plain(q, k, v, bias, h)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    # the two round p to bf16 at different points (unnormalised in the
    # kernel): one bf16 step of the output, relative
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)


def test_wrappers_never_fall_back_on_cuda(cuda):
    """A CUDA tensor launches the kernel or raises; it never runs the plain
    version."""
    q, k, v = _qkv(cuda, 1, 64, 2)
    bias = torch.zeros((1, 2, 64, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_attention_packed(q.float(), k.float(), v.float(), bias, 2)
    with pytest.raises(ValueError, match="head dim"):  # 4 heads of 32
        flash_attention_packed(q, k, v, torch.zeros((1, 4, 64, 64), device=cuda), 4)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_packed(q, k, v, bias.transpose(2, 3), 2)
    args = _bias_args(cuda, 1, 16, 2)
    with pytest.raises(TypeError):
        materialize_bias(*[a.long() if i < 4 else a for i, a in enumerate(args)])
    with pytest.raises(TypeError):
        materialize_bias(*args, out_dtype=torch.float16)


def _train_bias(device, b, s, p, h, dtype, seed=1):
    """A (B, H, P, P) bias with masked pad keys, one sample with a masked
    tail of keys, and finite pad rows."""
    g = torch.Generator().manual_seed(seed)
    bias = torch.randn((b, h, p, p), generator=g)
    bias[:, :, :, s:] = -1e30
    bias[0, :, :, (2 * s) // 3:s] = -1e30
    return bias.to(device, dtype)


def _scaled_err(got, want):
    """max |got - want| over the largest |want|."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


TRAIN_SHAPES = [(2, 64, 64, 2), (2, 20, 128, 4), (1, 130, 192, 3), (2, 709, 768, 12)]


@pytest.mark.parametrize("b,s,p,h", TRAIN_SHAPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
def test_train_forward_kernel_matches_plain(cuda, b, s, p, h, rate, bias_dtype):
    q, k, v = _qkv(cuda, b, s, h)
    bias = _train_bias(cuda, b, s, p, h, bias_dtype)
    before = flash_attention_packed_train_fwd.launches
    out, lse = flash_attention_packed_train_fwd(q, k, v, bias, 1234, h, rate)
    assert flash_attention_packed_train_fwd.launches == before + 1
    want_out, want_lse = flash_attention_packed_train_fwd_plain(q, k, v, bias, 1234, h, rate)
    torch.cuda.synchronize()
    assert lse.shape == (b, h, p) and torch.isinf(lse[:, :, s:]).all()
    # the kernel rounds the unnormalised p to bf16: one bf16 step, relative
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-2, rtol=2e-2)
    # f32 online softmax against the dense one
    torch.testing.assert_close(lse[:, :, :s], want_lse[:, :, :s], atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("b,s,p,h", TRAIN_SHAPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("chained", [False, True])
def test_train_backward_kernel_matches_plain(cuda, b, s, p, h, rate, chained):
    q, k, v = _qkv(cuda, b, s, h)
    bias = _train_bias(cuda, b, s, p, h, torch.bfloat16)
    g = torch.Generator().manual_seed(5)
    do = torch.randn((b, s, h * 64), generator=g).to(cuda, torch.bfloat16)
    gbias = (torch.randn((b, h, p, p), generator=g) * 1e-3).to(cuda, torch.bfloat16) if chained else None
    o, lse = flash_attention_packed_train_fwd_plain(q, k, v, bias, 99, h, rate)
    before = flash_attention_packed_train_bwd.launches
    got = flash_attention_packed_train_bwd(q, k, v, bias, 99, o, lse, do, h, rate, gbias)
    assert flash_attention_packed_train_bwd.launches == before + 2  # dq/dbias, dk/dv
    want = flash_attention_packed_train_bwd_plain(q, k, v, bias, 99, o, lse, do, h, rate, gbias)
    torch.cuda.synchronize()
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        assert torch.isfinite(a.float()).all(), name
        # bf16 outputs from f32 sums taken in another order, and ds rounded
        # to bf16 before the dq/dk products in both: 2% of the largest value
        assert _scaled_err(a, w) <= 2e-2, (name, _scaled_err(a, w))
    pad = got[3][:, :, s:, :].float()
    want_pad = 0.0 if gbias is None else gbias[:, :, s:, :].float()
    assert torch.equal(pad, torch.zeros_like(pad) + want_pad)


def test_train_autograd_runs_the_kernels(cuda):
    b, s, p, h = 2, 100, 128, 2
    q, k, v = (x.requires_grad_() for x in _qkv(cuda, b, s, h))
    bias = _train_bias(cuda, b, s, p, h, torch.bfloat16).requires_grad_()
    fwd0, bwd0 = flash_attention_packed_train_fwd.launches, flash_attention_packed_train_bwd.launches
    out = flash_attention_packed_train(q, k, v, bias, 3, h, 0.1)
    out.float().square().sum().backward()
    assert flash_attention_packed_train_fwd.launches == fwd0 + 1
    assert flash_attention_packed_train_bwd.launches == bwd0 + 2
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v, bias))


@pytest.mark.parametrize("b,s,p,h", [(2, 20, 128, 4), (3, 300, 384, 12), (16, 709, 768, 12)])
@pytest.mark.parametrize("g_dtype", [torch.bfloat16, torch.float32])
def test_table_grads_kernel_matches_plain(cuda, b, s, p, h, g_dtype):
    pos, cx, cy = _bias_args(cuda, b, s, h)[:3]
    gen = torch.Generator().manual_seed(2)
    g = torch.randn((b, h, p, p), generator=gen).to(cuda, g_dtype)  # finite pad rows
    before = table_grads.launches
    got = table_grads(pos, cx, cy, g)
    assert table_grads.launches == before + 1
    want = table_grads_plain(pos, cx, cy, g)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        # f32 sums of up to B*S*S terms, added in another (and run-to-run
        # varying) order through float atomics
        torch.testing.assert_close(a, w, atol=1e-4 * w.abs().max().item(), rtol=1e-4)


def test_bias_backward_runs_table_grads(cuda):
    pos, cx, cy, mask, t1, tx, ty = _bias_args(cuda, 2, 100, 4)
    tables = [t.requires_grad_() for t in (t1, tx, ty)]
    bias = materialize_bias(pos, cx, cy, mask, *tables)
    gen = torch.Generator().manual_seed(4)
    g = torch.randn(bias.shape, generator=gen).to(cuda, bias.dtype)
    before = table_grads.launches
    bias.backward(g)
    assert table_grads.launches == before + 1
    for t, w in zip(tables, table_grads_plain(pos, cx, cy, g)):
        torch.testing.assert_close(t.grad, w, atol=1e-4 * w.abs().max().item(), rtol=1e-4)


def test_train_wrappers_never_fall_back_on_cuda(cuda):
    q, k, v = _qkv(cuda, 1, 64, 2)
    bias = torch.zeros((1, 2, 64, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_attention_packed_train_fwd(q.float(), k.float(), v.float(), bias, 0, 2)
    with pytest.raises(ValueError, match="multiple of 64"):
        flash_attention_packed_train_fwd(q, k, v, torch.zeros((1, 2, 96, 96), device=cuda), 0, 2)
    pos, cx, cy = _bias_args(cuda, 1, 64, 2)[:3]
    with pytest.raises(TypeError):
        table_grads(pos, cx, cy, bias.half())
    with pytest.raises(ValueError, match="heads"):
        table_grads(pos, cx, cy, torch.zeros((1, 17, 64, 64), device=cuda))


def test_trainer_on_cuda_needs_bf16(cuda):
    """On the card the attention kernels take bf16 only: an f32 trainer
    raises instead of running the plain path."""
    from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig
    from multi_modal_early_exit_tpu_torch.models.ee.model import init_ee_params
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import (
        EEModelConfig,
        LayoutLMv3Config,
    )
    from multi_modal_early_exit_tpu_torch.training.trainer import EETrainer, TrainingArguments

    # one head of 64: the head dim the kernels take
    cfg = EEModelConfig(backbone=LayoutLMv3Config.tiny(num_labels=4).replace(num_attention_heads=1),
                        exit=ExitConfig(exits=("text_avg", 1)))
    model = init_ee_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="bfloat16"):
        EETrainer(cfg, model, TrainingArguments(bf16=False), 1, device=cuda)
    trainer = EETrainer(cfg, model, TrainingArguments(bf16=True), 1, device=cuda)
    g = torch.Generator().manual_seed(0)
    batch = {
        "input_ids": torch.randint(3, 100, (1, 2, 12), generator=g),
        "bbox": torch.sort(torch.randint(0, 1000, (1, 2, 12, 4), generator=g), -1).values,
        "pixel_values": torch.randn((1, 2, 3, cfg.backbone.input_size,
                                     cfg.backbone.input_size), generator=g),
        "attention_mask": torch.ones((1, 2, 12), dtype=torch.int32),
        "labels": torch.tensor([[0, 3]]),
    }
    before = flash_attention_packed_train_bwd.launches
    loss, _ = trainer.train_step(batch, torch.Generator().manual_seed(1))
    assert math.isfinite(loss)
    assert flash_attention_packed_train_bwd.launches == before + 2 * cfg.backbone.num_hidden_layers


def _heads_view(x, h, layout):
    """(B, S, H*64) -> (B, H, S, 64): the transposed view of the packed
    projections, or that view made contiguous."""
    b, s, _ = x.shape
    view = x.view(b, s, h, 64).transpose(1, 2)
    return view if layout == "packed" else view.contiguous()


@pytest.mark.parametrize("b,s,h", [(2, 20, 4), (1, 130, 3), (3, 709, 12), (2, 768, 12)])
@pytest.mark.parametrize("layout", ["contiguous", "packed"])
def test_fused_bias_attention_kernel_matches_plain(cuda, b, s, h, layout):
    args = _bias_args(cuda, b, s, h)  # one sample with its second half of keys masked
    qkv = _qkv(cuda, b, s, h)
    q4, k4, v4 = (_heads_view(x, h, layout) for x in qkv)
    before = fused_bias_attention.launches
    got = fused_bias_attention(q4, k4, v4, *args)
    assert fused_bias_attention.launches == before + 1
    want = fused_bias_attention_plain(q4, k4, v4, *args)
    pair = flash_attention_packed(*qkv, materialize_bias(*args), h)
    torch.cuda.synchronize()
    assert got.shape == (b, h, s, 64) and got.stride() == q4.stride()
    assert torch.isfinite(got.float()).all()
    # p is rounded to bf16 at other points than in the dense version: one
    # bf16 step of the output, relative, as for flash_attention_packed
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)
    # the pair it replaces reads the same bf16 bias values and shares the
    # kernel's tiling and arithmetic: bit-equal
    assert torch.equal(got.transpose(1, 2).reshape(b, s, -1), pair)


def _tables_bias(args, p, dtype):
    """materialize_bias of the bias inputs, cut to the width P (>= S)."""
    return materialize_bias(*args, out_dtype=dtype)[:, :, :p, :p].contiguous()


# P = S rounded up to 64 and to 128
TABLE_SHAPES = [(2, 20, 64, 4), (2, 20, 128, 4), (1, 130, 192, 3), (1, 130, 256, 3),
                (2, 709, 768, 12)]


@pytest.mark.parametrize("b,s,p,h", TABLE_SHAPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
def test_train_tables_backward_kernel_matches_plain(cuda, b, s, p, h, rate, bias_dtype):
    args = _bias_args(cuda, b, s, h)
    pos, cx, cy = args[:3]
    bias = _tables_bias(args, p, bias_dtype)
    q, k, v = _qkv(cuda, b, s, h)
    g = torch.Generator().manual_seed(5)
    do = torch.randn((b, s, h * 64), generator=g).to(cuda, torch.bfloat16)
    o, lse = flash_attention_packed_train_fwd_plain(q, k, v, bias, 99, h, rate)
    before = flash_attention_packed_train_tables_bwd.launches
    got = flash_attention_packed_train_tables_bwd(q, k, v, bias, pos, cx, cy, 99, o, lse, do,
                                                  h, rate)
    assert flash_attention_packed_train_tables_bwd.launches == before + 3
    again = flash_attention_packed_train_tables_bwd(q, k, v, bias, pos, cx, cy, 99, o, lse, do,
                                                    h, rate)
    want = flash_attention_packed_train_tables_bwd_plain(q, k, v, bias, pos, cx, cy, 99, o,
                                                         lse, do, h, rate)
    torch.cuda.synchronize()
    for name, a, w, a2 in zip(("dq", "dk", "dv", "dt1", "dtx", "dty"), got, want, again):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        assert torch.isfinite(a.float()).all(), name
        assert torch.equal(a, a2), name  # deterministic: no atomics
        # dq/dk/dv as the chained backward's (ds rounded to bf16 before the
        # products); the tables sum the f32 ds that the plain version sums,
        # in another order: 1e-3 of their scale
        limit = 2e-2 if name in ("dq", "dk", "dv") else 1e-3
        assert _scaled_err(a, w) <= limit, (name, _scaled_err(a, w))


def test_train_tables_autograd_runs_the_tables_kernel(cuda):
    b, s, h = 2, 100, 2
    args = _bias_args(cuda, b, s, h)
    pos, cx, cy = args[:3]
    tables = [t.requires_grad_() for t in args[4:]]
    with torch.no_grad():
        bias = materialize_bias(*args[:4], *tables)
    q, k, v = (x.requires_grad_() for x in _qkv(cuda, b, s, h))
    counters = (flash_attention_packed_train_fwd, flash_attention_packed_train_tables_bwd,
                flash_attention_packed_train_bwd, table_grads)
    before = [f.launches for f in counters]
    out = flash_attention_packed_train_tables(q, k, v, bias, *tables, pos, cx, cy, 3, h, 0.1)
    out.float().square().sum().backward()
    assert [f.launches - n for f, n in zip(counters, before)] == [1, 3, 0, 0]
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v, *tables))
    assert all(t.grad.dtype == torch.float32 for t in tables)


def test_bias_mode_wrappers_never_fall_back_on_cuda(cuda):
    """A CUDA tensor launches the kernel or raises; it never runs the plain
    version."""
    args = _bias_args(cuda, 1, 64, 2)
    q4, k4, v4 = (_heads_view(x, 2, "packed") for x in _qkv(cuda, 1, 64, 2))
    with pytest.raises(TypeError):
        fused_bias_attention(q4.float(), k4.float(), v4.float(), *args)
    with pytest.raises(ValueError, match="head dim"):  # 4 heads of 32
        fused_bias_attention(*(x.reshape(1, 4, 64, 32) for x in (q4, k4, v4)),
                             *args[:4], *(torch.zeros((n, 4), device=cuda) for n in (32, 64, 64)))
    unaligned = torch.zeros((1, 2, 64, 72), dtype=torch.bfloat16, device=cuda)[..., 4:68]
    with pytest.raises(ValueError, match="strides"):
        fused_bias_attention(unaligned, k4, v4, *args)
    with pytest.raises(TypeError):
        fused_bias_attention(q4, k4, v4, *[a.long() if i < 4 else a for i, a in enumerate(args)])
    with pytest.raises(ValueError, match="one device"):
        fused_bias_attention(q4, k4, v4, *[a.cpu() for a in args])

    pos, cx, cy = args[:3]
    q, k, v = _qkv(cuda, 1, 64, 2)
    bias = torch.zeros((1, 2, 64, 64), device=cuda)
    lse = torch.zeros((1, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_attention_packed_train_tables_bwd(q.float(), k.float(), v.float(), bias, pos, cx,
                                                cy, 0, q.float(), lse, q.float(), 2)
    with pytest.raises(ValueError, match="multiple of 64"):
        flash_attention_packed_train_tables_bwd(q, k, v, torch.zeros((1, 2, 96, 96), device=cuda),
                                                pos, cx, cy, 0, q, lse, q, 2)
    with pytest.raises(TypeError, match="int32"):
        flash_attention_packed_train_tables_bwd(q, k, v, bias, pos.long(), cx, cy, 0, q, lse,
                                                q, 2)
