"""PyTorch port, CUDA kernels against their plain versions on an sm_90 card.

Every test here needs an NVIDIA Hopper card and skips elsewhere; run them
on the card with ``python -m pytest tests/test_torch_cuda_kernels.py -q``.
"""

import math

import pytest
import torch

from multi_modal_early_exit_tpu_torch.ops import flash_attention as flash_module
from multi_modal_early_exit_tpu_torch.ops import fused_bias_attention as fused_module
from multi_modal_early_exit_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_plain,
    flash_attention_packed,
    flash_attention_packed_plain,
    flash_attention_packed_train,
    flash_attention_packed_train_bwd,
    flash_attention_packed_train_bwd_plain,
    flash_attention_packed_train_chained,
    flash_attention_packed_train_fwd,
    flash_attention_packed_train_fwd_plain,
    flash_attention_packed_train_tables,
    flash_attention_packed_train_tables_bwd,
    flash_attention_packed_train_tables_bwd_plain,
    split_bf16x3,
    split_bf16x3_plain,
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


def _qkv(device, b, s, h, seed=0, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, s, h * 64), generator=g).to(device, dtype)
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
    version. The kernels take bf16 or f32 q/k/v, not float16 or a mix."""
    q, k, v = _qkv(cuda, 1, 64, 2)
    bias = torch.zeros((1, 2, 64, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_attention_packed(q.half(), k.half(), v.half(), bias, 2)
    with pytest.raises(TypeError):
        flash_attention_packed(q.float(), k, v, bias, 2)
    wide = torch.zeros((1, 64, 192), dtype=torch.bfloat16, device=cuda)
    wide_bias = torch.zeros((1, 1, 64, 64), device=cuda)
    before = flash_attention_packed.launches  # one head of 192 runs (the wide mode)
    assert torch.isfinite(flash_attention_packed(wide, wide, wide, wide_bias, 1).float()).all()
    assert flash_attention_packed.launches == before + 1
    _failing_binding_raises(lambda: flash_attention_packed(wide, wide, wide, wide_bias, 1),
                            "_flash_attention_packed_fn", flash_attention_packed)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_packed(q, k, v, bias.transpose(2, 3), 2)
    args = _bias_args(cuda, 1, 16, 2)
    with pytest.raises(TypeError):
        materialize_bias(*[a.long() if i < 4 else a for i, a in enumerate(args)])
    with pytest.raises(TypeError):
        materialize_bias(*args, out_dtype=torch.float16)


def _failing_binding_raises(call, fns_name, counter, module=flash_module):
    """With the binding that ``module.<fns_name>()`` returns patched to fail
    (a CUDA error code), ``call`` raises and launches nothing: no plain
    version runs in the kernel's place."""
    fns = getattr(module, fns_name)()

    def failing(*args):
        return 1  # cudaErrorInvalidValue

    patched = (fns[0],) + tuple(failing for _ in fns[1:])
    before = counter.launches
    mp = pytest.MonkeyPatch()
    mp.setattr(module, fns_name, lambda: patched)
    try:
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            call()
    finally:
        mp.undo()
    assert counter.launches == before


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


# P = S; P rounded up to 64 and to 128; P / 128 not whole (the forward's
# last 128-row tile holds 64 rows); S a multiple of 128; the paths' shape
TRAIN_SHAPES = [(2, 64, 64, 2), (2, 20, 128, 4), (1, 130, 192, 3), (1, 200, 320, 2),
                (2, 256, 256, 4), (2, 709, 768, 12)]


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


def _reading_order(cx, cy):
    """x0 / y1 of boxes in reading order: sorted by y1, then x0."""
    y = torch.sort(cy * 1000 + cx, dim=1).values
    return (y % 1000).to(torch.int32).contiguous(), (y // 1000).to(torch.int32).contiguous()


# (2, 20, 128, 4) has B*H = 8 < 16 planes a box; H = 16 fills the products'
# N; P = 320 and 448 are odd multiples of 64; P = 400 is a multiple of 16 only
@pytest.mark.parametrize("b,s,p,h", [(2, 20, 128, 4), (3, 300, 384, 12), (16, 709, 768, 12),
                                     (2, 300, 320, 16), (3, 390, 400, 16), (1, 445, 448, 7)])
@pytest.mark.parametrize("g_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("order", ["random", "reading"])
def test_table_grads_kernel_matches_plain(cuda, b, s, p, h, g_dtype, order):
    pos, cx, cy = _bias_args(cuda, b, s, h)[:3]
    if order == "reading":
        cx, cy = _reading_order(cx, cy)
    gen = torch.Generator().manual_seed(2)
    g = torch.randn((b, h, p, p), generator=gen).to(cuda, g_dtype)  # finite pad rows
    before = table_grads.launches
    got = table_grads(pos, cx, cy, g)
    assert table_grads.launches == before + 2  # the per-CTA sums, then their sum
    again = table_grads(pos, cx, cy, g)
    want = table_grads_plain(pos, cx, cy, g)
    onehot = table_grads_plain(pos, cx, cy, g, onehot=True)
    torch.cuda.synchronize()
    for a, a2, w, w1 in zip(got, again, want, onehot):
        # f32 sums of up to B*S*S terms, added in another order; the one-hot
        # plain version is the kernel's arithmetic (an f32 g in three bf16
        # parts)
        torch.testing.assert_close(a, w, atol=1e-4 * w.abs().max().item(), rtol=1e-4)
        torch.testing.assert_close(a, w1, atol=1e-4 * w.abs().max().item(), rtol=1e-4)
        assert torch.equal(a2, a)  # deterministic: a fixed order, no atomics


def test_bias_backward_runs_table_grads(cuda):
    pos, cx, cy, mask, t1, tx, ty = _bias_args(cuda, 2, 100, 4)
    tables = [t.requires_grad_() for t in (t1, tx, ty)]
    bias = materialize_bias(pos, cx, cy, mask, *tables)
    gen = torch.Generator().manual_seed(4)
    g = torch.randn(bias.shape, generator=gen).to(cuda, bias.dtype)
    before = table_grads.launches
    bias.backward(g)
    assert table_grads.launches == before + 2
    for t, w in zip(tables, table_grads_plain(pos, cx, cy, g)):
        torch.testing.assert_close(t.grad, w, atol=1e-4 * w.abs().max().item(), rtol=1e-4)


def test_train_wrappers_never_fall_back_on_cuda(cuda):
    q, k, v = _qkv(cuda, 1, 64, 2)
    bias = torch.zeros((1, 2, 64, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_attention_packed_train_fwd(q.half(), k.half(), v.half(), bias, 0, 2)
    with pytest.raises(ValueError, match="multiple of 64"):
        flash_attention_packed_train_fwd(q, k, v, torch.zeros((1, 2, 96, 96), device=cuda), 0, 2)
    pos, cx, cy = _bias_args(cuda, 1, 64, 2)[:3]
    with pytest.raises(TypeError):
        table_grads(pos, cx, cy, bias.half())
    with pytest.raises(ValueError, match="heads"):
        table_grads(pos, cx, cy, torch.zeros((1, 17, 64, 64), device=cuda))


def _tiny_trainer_setup():
    from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig
    from multi_modal_early_exit_tpu_torch.models.ee.model import init_ee_params
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import (
        EEModelConfig,
        LayoutLMv3Config,
    )

    # one head of 64: the head dim the kernels take
    cfg = EEModelConfig(backbone=LayoutLMv3Config.tiny(num_labels=4).replace(num_attention_heads=1),
                        exit=ExitConfig(exits=("text_avg", 1)))
    model = init_ee_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(0)
    batch = {
        "input_ids": torch.randint(3, 100, (1, 2, 12), generator=g),
        "bbox": torch.sort(torch.randint(0, 1000, (1, 2, 12, 4), generator=g), -1).values,
        "pixel_values": torch.randn((1, 2, 3, cfg.backbone.input_size,
                                     cfg.backbone.input_size), generator=g),
        "attention_mask": torch.ones((1, 2, 12), dtype=torch.int32),
        "labels": torch.tensor([[0, 3]]),
    }
    return cfg, model, batch


@pytest.mark.parametrize("bf16", [False, True])
def test_trainer_steps_on_cuda(cuda, bf16):
    """``EETrainer`` trains on the card in f32 (the default) and in mixed
    precision, through the training kernels in every layer."""
    import copy

    from multi_modal_early_exit_tpu_torch.training.trainer import EETrainer, TrainingArguments

    cfg, model, batch = _tiny_trainer_setup()
    trainer = EETrainer(cfg, copy.deepcopy(model), TrainingArguments(bf16=bf16), 1, device=cuda)
    before = flash_attention_packed_train_bwd.launches
    loss, _ = trainer.train_step(batch, torch.Generator().manual_seed(1))
    assert math.isfinite(loss)
    assert flash_attention_packed_train_bwd.launches == before + 2 * cfg.backbone.num_hidden_layers
    assert not torch.equal(trainer.model.backbone.encoder.layers[0].attention.query.weight.cpu(),
                           model.backbone.encoder.layers[0].attention.query.weight)


def test_f32_trainer_gradients_match_the_cpu_path(cuda):
    """An f32 model's loss gradients through the f32 kernels on the card
    against the plain path on the CPU, dropout 0: within 1e-4 of each
    tensor's largest gradient. The key biases' true gradient is 0 (softmax
    ignores a per-row shift), so both paths return rounding noise there,
    held below 1e-10 of the largest gradient instead."""
    import copy

    from multi_modal_early_exit_tpu_torch.training.losses import ee_loss_fn

    cfg, model, batch = _tiny_trainer_setup()
    rates = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                 classifier_dropout=0.0)
    cfg = cfg.replace(backbone=cfg.backbone.replace(**rates))
    small = {k: v[0] for k, v in batch.items()}

    def grads(m, device):
        loss, _ = ee_loss_fn(m, cfg, small, device=device)
        return loss.item(), torch.autograd.grad(loss, list(m.parameters()), allow_unused=True)

    before = flash_attention_packed.launches
    gpu_loss, gpu = grads(copy.deepcopy(model).to(cuda), cuda)
    assert flash_attention_packed.launches > before  # the kernel path ran
    cpu_loss, cpu = grads(model, "cpu")
    assert abs(gpu_loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    big = max(w.abs().max().item() for w in cpu if w is not None)
    for (name, _), a, w in zip(model.named_parameters(), gpu, cpu):
        if w is None:
            assert a is None or not a.any(), name
            continue
        assert torch.isfinite(a).all(), name
        if name.endswith(".key.bias"):
            assert max(a.abs().max().item(), w.abs().max().item()) <= 1e-10 * big, name
        else:
            assert _scaled_err(a.cpu(), w) <= 1e-4, (name, _scaled_err(a.cpu(), w))


def _heads_view(x, h, layout):
    """(B, S, H*D) -> (B, H, S, D): the transposed view of the packed
    projections, or that view made contiguous."""
    b, s, _ = x.shape
    view = x.view(b, s, h, -1).transpose(1, 2)
    return view if layout == "packed" else view.contiguous()


# S = 20 and 64 (P = 64), 130 (odd P / 64), the paths' 709 inside 768 and 768
FUSED_SHAPES = [(2, 20, 4), (2, 64, 2), (1, 130, 3), (3, 709, 12), (2, 768, 12)]


@pytest.mark.parametrize("b,s,h", FUSED_SHAPES)
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
        fused_bias_attention(q4.half(), k4.half(), v4.half(), *args)
    with pytest.raises(TypeError):
        fused_bias_attention(q4.float(), k4, v4, *args)
    wide = torch.zeros((1, 1, 64, 192), dtype=torch.bfloat16, device=cuda)
    wide_args = (*args[:4], *(torch.zeros((n, 1), device=cuda) for n in (32, 64, 64)))
    before = fused_bias_attention.launches  # one head of 192 runs (the wide mode)
    assert torch.isfinite(fused_bias_attention(wide, wide, wide, *wide_args).float()).all()
    assert fused_bias_attention.launches == before + 1
    _failing_binding_raises(lambda: fused_bias_attention(wide, wide, wide, *wide_args),
                            "_fused_bias_attention_fn", fused_bias_attention, fused_module)
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
        flash_attention_packed_train_tables_bwd(q.half(), k.half(), v.half(), bias, pos, cx,
                                                cy, 0, q.half(), lse, q.half(), 2)
    with pytest.raises(ValueError, match="multiple of 64"):
        flash_attention_packed_train_tables_bwd(q, k, v, torch.zeros((1, 2, 96, 96), device=cuda),
                                                pos, cx, cy, 0, q, lse, q, 2)
    with pytest.raises(TypeError, match="int32"):
        flash_attention_packed_train_tables_bwd(q, k, v, bias, pos.long(), cx, cy, 0, q, lse,
                                                q, 2)


# ---------------------------------------------------------------------------
# the head form: the training kernels' bodies with explicit strides
# ---------------------------------------------------------------------------

# P = S, P rounded up to 64 and to 128, P / 128 not whole, S a multiple of
# 128, the paths' shape, and a width the kernels do not tile (27: the
# wrapper pads the bias to 64)
HEADFORM_SHAPES = [(2, 64, 64, 2), (2, 20, 128, 4), (1, 130, 192, 3), (1, 200, 320, 2),
                   (2, 256, 256, 4), (2, 709, 768, 12), (1, 27, 27, 2)]


@pytest.mark.parametrize("b,s,p,h", HEADFORM_SHAPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layout", ["contiguous", "packed"])
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
def test_headform_forward_kernel_matches_plain(cuda, b, s, p, h, rate, layout, bias_dtype):
    q, k, v = (_heads_view(x, h, layout) for x in _qkv(cuda, b, s, h))
    bias = _train_bias(cuda, b, s, p, h, bias_dtype)
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, bias, 1234, rate, with_lse=True)
    assert flash_attention_fwd.launches == before + 1
    want_out, want_lse = flash_attention_fwd_plain(q, k, v, bias, 1234, rate)
    torch.cuda.synchronize()
    assert out.stride() == q.stride() and lse.shape == (b, h, p)
    assert torch.isinf(lse[:, :, s:]).all()
    # as the packed training forward: one bf16 step of the output, relative;
    # the f32 online softmax's lse against the dense one
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse[:, :, :s], want_lse[:, :, :s], atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("layout", ["contiguous", "packed"])
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
def test_forward_row_with_every_key_masked_averages_v(cuda, layout, bias_dtype):
    """A row whose every key carries -1e30 weighs the keys alike, as the
    plain softmax does: its output is the mean of v over the keys < S."""
    b, s, p, h = 2, 200, 256, 2
    q, k, v = (_heads_view(x, h, layout) for x in _qkv(cuda, b, s, h))
    bias = _train_bias(cuda, b, s, p, h, torch.float32)
    bias[-1, 0, 1, :] = -1e30
    bias = bias.to(bias_dtype)
    out, lse = flash_attention_fwd(q, k, v, bias, 0, 0.0, with_lse=True)
    want_out, want_lse = flash_attention_fwd_plain(q, k, v, bias, 0, 0.0)
    torch.cuda.synchronize()
    mean_v = v[-1, 0].float().mean(dim=0)
    torch.testing.assert_close(out[-1, 0, 1].float(), mean_v, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse[:, :, :s], want_lse[:, :, :s], atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layout", ["contiguous", "packed"])
def test_forward_kernels_are_deterministic(cuda, rate, layout):
    """Two runs of the forward give the same bits, in both entries."""
    b, s, p, h = 2, 709, 768, 12
    qkv = _qkv(cuda, b, s, h)
    views = [_heads_view(x, h, layout) for x in qkv]
    bias = _train_bias(cuda, b, s, p, h, torch.bfloat16)
    first = flash_attention_fwd(*views, bias, 5, rate, with_lse=True)
    again = flash_attention_fwd(*views, bias, 5, rate, with_lse=True)
    packed = flash_attention_packed_train_fwd(*qkv, bias, 5, h, rate)
    packed_again = flash_attention_packed_train_fwd(*qkv, bias, 5, h, rate)
    torch.cuda.synchronize()
    for a, w in zip(first + packed, again + packed_again):
        assert torch.equal(a, w)


@pytest.mark.parametrize("b,s,p,h", [(2, 64, 64, 2), (1, 130, 192, 3), (2, 709, 768, 12)])
def test_train_forward_at_rate_0_equals_the_serving_kernel(cuda, b, s, p, h):
    """At dropout 0 the training forward repeats ``flash_attention_packed``'s
    arithmetic (expf, the same rounding points and sums in the same order),
    so the schedules that run one or the other give the same bits."""
    q, k, v = _qkv(cuda, b, s, h)
    bias = _train_bias(cuda, b, s, p, h, torch.bfloat16)
    out, _ = flash_attention_packed_train_fwd(q, k, v, bias, 0, h, 0.0)
    want = flash_attention_packed(q, k, v, bias, h)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("b,s,p,h", HEADFORM_SHAPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layout", ["contiguous", "packed"])
def test_headform_backward_kernel_matches_plain(cuda, b, s, p, h, rate, layout):
    q, k, v = (_heads_view(x, h, layout) for x in _qkv(cuda, b, s, h))
    bias = _train_bias(cuda, b, s, p, h, torch.bfloat16)
    g = torch.Generator().manual_seed(5)
    do = _heads_view(torch.randn((b, s, h * 64), generator=g).to(cuda, torch.bfloat16), h, layout)
    o, lse = flash_attention_fwd_plain(q, k, v, bias, 99, rate)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, bias, 99, o, lse, do, rate)
    assert flash_attention_bwd.launches == before + 2  # dq/dbias, dk/dv
    again = flash_attention_bwd(q, k, v, bias, 99, o, lse, do, rate)
    want = flash_attention_bwd_plain(q, k, v, bias, 99, o, lse, do, rate)
    torch.cuda.synchronize()
    for name, a, w, a2 in zip(("dq", "dk", "dv", "dbias"), got, want, again):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        assert torch.isfinite(a.float()).all(), name
        assert torch.equal(a, a2), name  # deterministic: no atomics
        # the packed training backward's bar: 2% of the largest value
        assert _scaled_err(a, w) <= 2e-2, (name, _scaled_err(a, w))
    for a, x in zip(got[:3], (q, k, v)):
        assert a.stride() == x.stride()
    dbias = got[3].float()
    assert torch.equal(dbias[:, :, s:, :], torch.zeros_like(dbias[:, :, s:, :]))
    assert torch.equal(dbias[:, :, :, s:], torch.zeros_like(dbias[:, :, :, s:]))


@pytest.mark.parametrize("b,s,p,h", [(2, 709, 768, 12), (2, 64, 64, 2), (1, 130, 192, 3),
                                     (1, 200, 320, 2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_headform_kernels_on_packed_views_equal_the_packed_kernels(cuda, b, s, p, h, rate):
    """One body, two layouts: on the packed projections' transposed views
    the head-form kernels give the packed training kernels' bits (phases 5c
    and 5d rely on it at rate 0), also at odd P / 64."""
    q, k, v = _qkv(cuda, b, s, h)
    bias = _train_bias(cuda, b, s, p, h, torch.bfloat16)
    do = torch.randn((b, s, h * 64), generator=torch.Generator().manual_seed(6)).to(
        cuda, torch.bfloat16)
    views = [_heads_view(x, h, "packed") for x in (q, k, v, do)]
    out, lse = flash_attention_packed_train_fwd(q, k, v, bias, 7, h, rate)
    out_h, lse_h = flash_attention_fwd(*views[:3], bias, 7, rate, with_lse=True)
    got = flash_attention_bwd(*views[:3], bias, 7, out_h, lse_h, views[3], rate)
    want = flash_attention_packed_train_bwd(q, k, v, bias, 7, out, lse, do, h, rate)
    torch.cuda.synchronize()
    assert torch.equal(_heads_view(out, h, "packed"), out_h) and torch.equal(lse, lse_h)
    for name, a, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert torch.equal(a, _heads_view(w, h, "packed")), name
    assert torch.equal(got[3], want[3])


# ---------------------------------------------------------------------------
# the bf16 backward's TMA-ring + wgmma pair: deterministic, one body for both
# layouts and both bias dtypes, its dk/dv kernel shared with the tables
# backward, and no other body to fall back to
# ---------------------------------------------------------------------------


def _bwd_case(device, b, s, p, h, bias_dtype=torch.bfloat16, seed=5):
    """q, k, v, a bias with masked keys, do and a gbias, all on ``device``."""
    q, k, v = _qkv(device, b, s, h)
    bias = _train_bias(device, b, s, p, h, bias_dtype)
    g = torch.Generator().manual_seed(seed)
    do = torch.randn((b, s, h * 64), generator=g).to(device, torch.bfloat16)
    gbias = (torch.randn((b, h, p, p), generator=g) * 1e-3).to(device, bias_dtype)
    return q, k, v, bias, do, gbias


@pytest.mark.parametrize("b,s,p,h", [(1, 130, 192, 3), (2, 709, 768, 12)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_backwards_give_the_same_bits_twice(cuda, b, s, p, h, rate):
    """#8 plain and chained and #6 (both layouts): a second run gives the
    same bits (no float atomics, sums in a fixed order)."""
    q, k, v, bias, do, gbias = _bwd_case(cuda, b, s, p, h)
    o, lse = flash_attention_packed_train_fwd(q, k, v, bias, 99, h, rate)
    runs = []
    for extra in (None, gbias):
        args = (q, k, v, bias, 99, o, lse, do, h, rate, extra)
        runs.append((flash_attention_packed_train_bwd(*args),
                     flash_attention_packed_train_bwd(*args)))
    for layout in ("contiguous", "packed"):
        views = [_heads_view(x, h, layout) for x in (q, k, v, do)]
        o_h, lse_h = flash_attention_fwd(*views[:3], bias, 99, rate, with_lse=True)
        args = (*views[:3], bias, 99, o_h, lse_h, views[3], rate)
        runs.append((flash_attention_bwd(*args), flash_attention_bwd(*args)))
    torch.cuda.synchronize()
    for first, again in runs:
        for name, a, w in zip(("dq", "dk", "dv", "dbias"), first, again):
            assert torch.equal(a, w), name


@pytest.mark.parametrize("b,s,p,h", [(2, 20, 128, 4), (1, 130, 192, 3), (2, 709, 768, 12)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("chained", [False, True])
def test_bf16_backward_with_an_f32_bias_matches_plain(cuda, b, s, p, h, rate, chained):
    """bf16 q/k/v with an f32 bias (gbias and dbias f32 too): #8, and #6 on
    the contiguous layout, against their plain versions at the bf16 bar;
    dbias past S exactly 0, or gbias when chained."""
    q, k, v, bias, do, gbias = _bwd_case(cuda, b, s, p, h, torch.float32)
    gbias = gbias if chained else None
    o, lse = flash_attention_packed_train_fwd_plain(q, k, v, bias, 99, h, rate)
    args = (q, k, v, bias, 99, o, lse, do, h, rate, gbias)
    got = flash_attention_packed_train_bwd(*args)
    want = flash_attention_packed_train_bwd_plain(*args)
    views = [_heads_view(x, h, "contiguous") for x in (q, k, v, do, o)]
    hargs = (*views[:3], bias, 99, views[4], lse, views[3], rate)
    got_h = flash_attention_bwd(*hargs)
    want_h = flash_attention_bwd_plain(*hargs)
    torch.cuda.synchronize()
    for name, a, w in [*zip(("dq", "dk", "dv", "dbias"), got, want),
                       *zip(("head dq", "head dk", "head dv", "head dbias"), got_h, want_h)]:
        assert a.shape == w.shape and a.dtype == w.dtype, name
        assert torch.isfinite(a.float()).all(), name
        assert _scaled_err(a, w) <= 2e-2, (name, _scaled_err(a, w))
    assert got[3].dtype == torch.float32
    pad = got[3][:, :, s:, :]
    assert torch.equal(pad, torch.zeros_like(pad) if gbias is None else gbias[:, :, s:, :])
    assert not got_h[3][:, :, s:, :].any() and not got_h[3][:, :, :, s:].any()


@pytest.mark.parametrize("b,s,p,h", [(1, 130, 192, 3), (1, 200, 320, 2), (2, 709, 768, 12)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_tables_backward_runs_the_shared_dkv_kernel(cuda, b, s, p, h, rate):
    """The dk/dv kernel through the tables backward (#9) at odd P / 64 and
    at S = 709 inside 768: dq/dk/dv within the bar of the plain version and
    bit-equal to the chained backward's (phase 5b holds the two paths'
    gradients to 1e-6), the table gradients within 1e-3 of theirs."""
    args = _bias_args(cuda, b, s, h)
    pos, cx, cy = args[:3]
    q, k, v, bias, do, gbias = _bwd_case(cuda, b, s, p, h)
    o, lse = flash_attention_packed_train_fwd_plain(q, k, v, bias, 99, h, rate)
    tables_args = (q, k, v, bias, pos, cx, cy, 99, o, lse, do, h, rate)
    got = flash_attention_packed_train_tables_bwd(*tables_args)
    want = flash_attention_packed_train_tables_bwd_plain(*tables_args)
    chained = flash_attention_packed_train_bwd(q, k, v, bias, 99, o, lse, do, h, rate, gbias)
    torch.cuda.synchronize()
    for name, a, w, c in zip(("dq", "dk", "dv"), got, want, chained):
        assert _scaled_err(a, w) <= 2e-2, (name, _scaled_err(a, w))
        assert torch.equal(a, c), name
    for name, a, w in zip(("dt1", "dtx", "dty"), got[3:], want[3:]):
        assert _scaled_err(a, w) <= 1e-3, (name, _scaled_err(a, w))


def test_bf16_backward_raises_on_a_misaligned_do(cuda):
    """The backward kernels load do by TMA: a do whose data is not 16-byte
    aligned raises, and no kernel is launched (there is no other body)."""
    b, s, p, h = 1, 64, 64, 2
    q, k, v, bias, do, _ = _bwd_case(cuda, b, s, p, h)
    o, lse = flash_attention_packed_train_fwd(q, k, v, bias, 0, h, 0.0)
    flat = torch.empty(do.numel() + 1, dtype=do.dtype, device=cuda)
    shifted = flat[1:].view(do.shape)  # contiguous, 2 bytes past a 16-byte boundary
    shifted.copy_(do)
    counters = (flash_attention_packed_train_bwd, flash_attention_bwd)
    before = [f.launches for f in counters]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_packed_train_bwd(q, k, v, bias, 0, o, lse, shifted, h, 0.0)
    views = [_heads_view(x, h, "packed") for x in (q, k, v, o, shifted)]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_bwd(*views[:3], bias, 0, views[3], lse, views[4], 0.0)
    assert [f.launches for f in counters] == before


def test_packed_attention_autograd_runs_the_headform_kernels(cuda):
    """``flash_attention_packed`` under autograd: its kernel forward, then
    the head-form forward and backward in the backward, with no copy of the
    packed tensors; under no_grad nothing but the forward."""
    b, s, p, h = 2, 100, 128, 2
    q, k, v = (x.requires_grad_() for x in _qkv(cuda, b, s, h))
    bias = _train_bias(cuda, b, s, p, h, torch.bfloat16).requires_grad_()
    counters = (flash_attention_packed, flash_attention_fwd, flash_attention_bwd,
                flash_attention_packed_train_fwd, flash_attention_packed_train_bwd)
    before = [f.launches for f in counters]
    out = flash_attention_packed(q, k, v, bias, h)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(cuda, out.dtype)
    (out.float() * g.float()).sum().backward()
    assert [f.launches - n for f, n in zip(counters, before)] == [1, 1, 2, 0, 0]
    views = [_heads_view(x.detach(), h, "packed") for x in (q, k, v)]
    o, lse = flash_attention_fwd(*views, bias.detach(), 0, 0.0, with_lse=True)
    want = flash_attention_bwd(*views, bias.detach(), 0, o, lse, _heads_view(g, h, "packed"))
    for t, w in zip((q, k, v), want[:3]):
        assert torch.equal(_heads_view(t.grad, h, "packed"), w)
    assert torch.equal(bias.grad, want[3])
    with torch.no_grad():
        before = flash_attention_fwd.launches
        flash_attention_packed(q, k, v, bias, h)
    assert flash_attention_fwd.launches == before


def test_headform_autograd_and_dropout_seed(cuda):
    b, s, p, h = 1, 64, 64, 2
    q, k, v = (_heads_view(x, h, "contiguous").requires_grad_() for x in _qkv(cuda, b, s, h))
    bias = _train_bias(cuda, b, s, p, h, torch.bfloat16).requires_grad_()
    before = flash_attention_fwd.launches, flash_attention_bwd.launches
    out = flash_attention(q, k, v, bias, dropout_rate=0.1, dropout_seed=torch.tensor([3]))
    out.float().square().sum().backward()
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 2)
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v, bias))
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, k, v, bias, dropout_rate=0.1)


def test_headform_wrappers_never_fall_back_on_cuda(cuda):
    q, k, v = (_heads_view(x, 2, "packed") for x in _qkv(cuda, 1, 64, 2))
    bias = torch.zeros((1, 2, 64, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_attention_fwd(q.half(), k.half(), v.half(), bias)
    wide = torch.zeros((1, 1, 64, 192), dtype=torch.bfloat16, device=cuda)
    wide_bias = torch.zeros((1, 1, 64, 64), device=cuda)
    before = flash_attention_fwd.launches  # one head of 192 runs (the wide mode)
    assert torch.isfinite(flash_attention_fwd(wide, wide, wide, wide_bias).float()).all()
    assert flash_attention_fwd.launches == before + 1
    _failing_binding_raises(lambda: flash_attention_fwd(wide, wide, wide, wide_bias),
                            "_headform_fns", flash_attention_fwd)
    unaligned = torch.zeros((1, 2, 64, 72), dtype=torch.bfloat16, device=cuda)[..., 4:68]
    with pytest.raises(ValueError, match="strides"):
        flash_attention_fwd(unaligned, k, v, bias)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q, k, v, bias.transpose(2, 3))
    with pytest.raises(ValueError, match="one device"):
        flash_attention_fwd(q, k, v, bias.cpu())
    lse = torch.zeros((1, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_attention_bwd(q, k, v, bias, 0, q.float(), lse, q, 0.0)


# ---------------------------------------------------------------------------
# f32 operands: every attention kernel's f32 instantiation (six bf16
# products of split operands on the tensor cores) against its plain version in f32,
# within 1e-4 of each output's largest value (plain TF32 would miss this by
# an order of magnitude)
# ---------------------------------------------------------------------------

F32_BAR = 1e-4
# P = S; P rounded up to 64 and 128; P / 128 not whole; S a multiple of
# 128; the paths' ragged shape
F32_SHAPES = [(2, 64, 64, 2), (2, 20, 128, 4), (1, 130, 192, 3), (1, 200, 320, 2),
              (2, 256, 256, 4), (2, 709, 768, 12)]


def _f32(device, b, s, h, seed=0):
    return _qkv(device, b, s, h, seed, torch.float32)


def _assert_f32_close(name, got, want):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    assert torch.isfinite(got).all(), name
    assert _scaled_err(got, want) <= F32_BAR, (name, _scaled_err(got, want))


@pytest.mark.parametrize("b,s,p,h", F32_SHAPES + [(1, 130, 130, 3)])  # P not a multiple of 64
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
def test_f32_packed_kernel_matches_plain(cuda, b, s, p, h, bias_dtype):
    q, k, v = _f32(cuda, b, s, h)
    bias = _train_bias(cuda, b, s, p, h, bias_dtype)
    before = flash_attention_packed.launches
    got = flash_attention_packed(q, k, v, bias, h)
    assert flash_attention_packed.launches == before + 1
    want = flash_attention_packed_plain(q, k, v, bias, h)
    torch.cuda.synchronize()
    _assert_f32_close("out", got, want)


@pytest.mark.parametrize("b,s,p,h", F32_SHAPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_f32_train_forward_kernel_matches_plain(cuda, b, s, p, h, rate):
    q, k, v = _f32(cuda, b, s, h)
    bias = _train_bias(cuda, b, s, p, h, torch.float32)
    out, lse = flash_attention_packed_train_fwd(q, k, v, bias, 1234, h, rate)
    want_out, want_lse = flash_attention_packed_train_fwd_plain(q, k, v, bias, 1234, h, rate)
    torch.cuda.synchronize()
    assert torch.isinf(lse[:, :, s:]).all()
    _assert_f32_close("out", out, want_out)
    _assert_f32_close("lse", lse[:, :, :s], want_lse[:, :, :s])
    if rate == 0.0:  # one kernel: the serving forward's bits
        assert torch.equal(out, flash_attention_packed(q, k, v, bias, h))


@pytest.mark.parametrize("b,s,p,h", F32_SHAPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("chained", [False, True])
def test_f32_train_backward_kernel_matches_plain(cuda, b, s, p, h, rate, chained):
    q, k, v = _f32(cuda, b, s, h)
    bias = _train_bias(cuda, b, s, p, h, torch.float32)
    g = torch.Generator().manual_seed(5)
    do = torch.randn((b, s, h * 64), generator=g).to(cuda)
    gbias = (torch.randn((b, h, p, p), generator=g) * 1e-3).to(cuda) if chained else None
    o, lse = flash_attention_packed_train_fwd_plain(q, k, v, bias, 99, h, rate)
    before = flash_attention_packed_train_bwd.launches
    got = flash_attention_packed_train_bwd(q, k, v, bias, 99, o, lse, do, h, rate, gbias)
    assert flash_attention_packed_train_bwd.launches == before + 2
    want = flash_attention_packed_train_bwd_plain(q, k, v, bias, 99, o, lse, do, h, rate, gbias)
    torch.cuda.synchronize()
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        _assert_f32_close(name, a, w)
    pad = got[3][:, :, s:, :]
    assert torch.equal(pad, torch.zeros_like(pad) if gbias is None else gbias[:, :, s:, :])


@pytest.mark.parametrize("b,s,p,h", F32_SHAPES + [(1, 27, 27, 2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layout", ["contiguous", "packed"])
def test_f32_headform_kernels_match_plain(cuda, b, s, p, h, rate, layout):
    q, k, v = (_heads_view(x, h, layout) for x in _f32(cuda, b, s, h))
    bias = _train_bias(cuda, b, s, p, h, torch.float32)
    out, lse = flash_attention_fwd(q, k, v, bias, 1234, rate, with_lse=True)
    want_out, want_lse = flash_attention_fwd_plain(q, k, v, bias, 1234, rate)
    g = torch.Generator().manual_seed(5)
    do = _heads_view(torch.randn((b, s, h * 64), generator=g).to(cuda), h, layout)
    got = flash_attention_bwd(q, k, v, bias, 1234, want_out, want_lse, do, rate)
    want = flash_attention_bwd_plain(q, k, v, bias, 1234, want_out, want_lse, do, rate)
    torch.cuda.synchronize()
    assert out.stride() == q.stride()
    _assert_f32_close("out", out, want_out)
    _assert_f32_close("lse", lse[:, :, :s], want_lse[:, :, :s])
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        _assert_f32_close(name, a, w)
    assert not got[3][:, :, s:, :].any() and not got[3][:, :, :, s:].any()


@pytest.mark.parametrize("b,s,p,h", TABLE_SHAPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_f32_train_tables_backward_kernel_matches_plain(cuda, b, s, p, h, rate):
    args = _bias_args(cuda, b, s, h)
    pos, cx, cy = args[:3]
    bias = _tables_bias(args, p, torch.float32)
    q, k, v = _f32(cuda, b, s, h)
    do = torch.randn((b, s, h * 64), generator=torch.Generator().manual_seed(5)).to(cuda)
    o, lse = flash_attention_packed_train_fwd_plain(q, k, v, bias, 99, h, rate)
    tables_args = (q, k, v, bias, pos, cx, cy, 99, o, lse, do, h, rate)
    got = flash_attention_packed_train_tables_bwd(*tables_args)
    again = flash_attention_packed_train_tables_bwd(*tables_args)
    want = flash_attention_packed_train_tables_bwd_plain(*tables_args)
    torch.cuda.synchronize()
    for name, a, w, a2 in zip(("dq", "dk", "dv", "dt1", "dtx", "dty"), got, want, again):
        assert torch.equal(a, a2), name
        if name in ("dq", "dk", "dv"):
            _assert_f32_close(name, a, w)
        else:  # the same f32 ds summed in another order, as in bf16
            assert _scaled_err(a, w) <= 1e-3, (name, _scaled_err(a, w))


@pytest.mark.parametrize("b,s,h", FUSED_SHAPES + [(1, 200, 2), (2, 256, 4)])
@pytest.mark.parametrize("layout", ["contiguous", "packed"])
def test_f32_fused_bias_attention_kernel_matches_plain(cuda, b, s, h, layout):
    """The f32 instantiation (split k/v parts, q split in registers, an f32
    bias built on chip): within 1e-4 of the plain version, and bit-equal to
    the f32 pair it replaces, whose arithmetic it shares."""
    args = _bias_args(cuda, b, s, h)
    qkv = _f32(cuda, b, s, h)
    q4, k4, v4 = (_heads_view(x, h, layout) for x in qkv)
    before, split_before = fused_bias_attention.launches, split_bf16x3.launches
    got = fused_bias_attention(q4, k4, v4, *args)
    assert fused_bias_attention.launches == before + 1
    assert split_bf16x3.launches == split_before + 1  # k and v
    want = fused_bias_attention_plain(q4, k4, v4, *args)
    pair = flash_attention_packed(*qkv, materialize_bias(*args, out_dtype=torch.float32), h)
    torch.cuda.synchronize()
    assert got.stride() == q4.stride()
    _assert_f32_close("out", got, want)
    assert torch.equal(got.transpose(1, 2).reshape(b, s, -1), pair)


def test_f32_packed_autograd_runs_the_headform_kernels(cuda):
    b, s, p, h = 2, 100, 128, 2
    q, k, v = (x.requires_grad_() for x in _f32(cuda, b, s, h))
    bias = _train_bias(cuda, b, s, p, h, torch.float32).requires_grad_()
    counters = (flash_attention_packed, flash_attention_fwd, flash_attention_bwd)
    before = [f.launches for f in counters]
    out = flash_attention_packed(q, k, v, bias, h)
    out.square().sum().backward()
    assert [f.launches - n for f, n in zip(counters, before)] == [1, 1, 2]
    assert all(t.grad.dtype == torch.float32 and torch.isfinite(t.grad).all()
               for t in (q, k, v, bias))


# the f32 backwards' split pre-pass and their sm_90a pair: odd P / 64, the
# paths' 709 inside 768, P = 64


F32_BWD_SHAPES = [(1, 130, 192, 3), (2, 709, 768, 12), (2, 64, 64, 2)]


@pytest.mark.parametrize("b,s,h", [(2, 70, 3), (2, 709, 12)])
@pytest.mark.parametrize("layout", ["contiguous", "packed"])
def test_split_pre_pass_is_bit_equal_to_plain(cuda, b, s, h, layout):
    """The split pre-pass of the f32 backwards, one to four tensors in one
    launch, gives the plain split's bits (both round to nearest even), and
    hi + (mid + lo) restores every value of these inputs."""
    xs = [_heads_view(x, h, layout) for x in _f32(cuda, b, s, h)]
    before = split_bf16x3.launches
    one = split_bf16x3(xs[0])
    three = split_bf16x3(*xs)
    assert split_bf16x3.launches == before + 2
    torch.cuda.synchronize()
    assert one.shape == (1, 3, b, h, s, 64) and three.shape == (3, 3, b, h, s, 64)
    for got, x in zip(three, xs):
        assert torch.equal(got, split_bf16x3_plain(x))
        hi, mid, lo = got.float()
        assert torch.equal(hi + (mid + lo), x)
    assert torch.equal(one[0], three[0])


@pytest.mark.parametrize("b,s,p,h", F32_BWD_SHAPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_f32_backwards_give_the_same_bits_twice(cuda, b, s, p, h, rate):
    """#8 plain and chained and #6 (both layouts) in f32: a second run
    gives the same bits (no float atomics, sums in a fixed order), each
    split once per call."""
    q, k, v = _f32(cuda, b, s, h)
    bias = _train_bias(cuda, b, s, p, h, torch.float32)
    g = torch.Generator().manual_seed(5)
    do = torch.randn((b, s, h * 64), generator=g).to(cuda)
    gbias = (torch.randn((b, h, p, p), generator=g) * 1e-3).to(cuda)
    o, lse = flash_attention_packed_train_fwd(q, k, v, bias, 99, h, rate)
    before = split_bf16x3.launches
    runs = []
    for extra in (None, gbias):
        args = (q, k, v, bias, 99, o, lse, do, h, rate, extra)
        runs.append((flash_attention_packed_train_bwd(*args),
                     flash_attention_packed_train_bwd(*args)))
    for layout in ("contiguous", "packed"):
        views = [_heads_view(x, h, layout) for x in (q, k, v, do)]
        o_h, lse_h = flash_attention_fwd(*views[:3], bias, 99, rate, with_lse=True)
        args = (*views[:3], bias, 99, o_h, lse_h, views[3], rate)
        runs.append((flash_attention_bwd(*args), flash_attention_bwd(*args)))
    # one split per backward (8), and one per f32 forward (the 2 head-form ones)
    assert split_bf16x3.launches == before + 10
    torch.cuda.synchronize()
    for first, again in runs:
        for name, a, w in zip(("dq", "dk", "dv", "dbias"), first, again):
            assert torch.isfinite(a).all(), name
            assert torch.equal(a, w), name


@pytest.mark.parametrize("b,s,p,h", F32_BWD_SHAPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_f32_tables_dkv_equals_the_packed_backward(cuda, b, s, p, h, rate):
    """#9 in f32 runs #8's pair in the tables mode on the same split parts:
    (A') is (A)'s body walking the keys < S only, and (B) #8's dk/dv kernel,
    so its dq, dk and dv are all #8 plain's bits."""
    args = _bias_args(cuda, b, s, h)
    pos, cx, cy = args[:3]
    bias = _tables_bias(args, p, torch.float32)
    q, k, v = _f32(cuda, b, s, h)
    do = torch.randn((b, s, h * 64), generator=torch.Generator().manual_seed(5)).to(cuda)
    o, lse = flash_attention_packed_train_fwd(q, k, v, bias, 99, h, rate)
    got = flash_attention_packed_train_tables_bwd(q, k, v, bias, pos, cx, cy, 99, o, lse, do, h,
                                                  rate)
    want = flash_attention_packed_train_bwd(q, k, v, bias, 99, o, lse, do, h, rate)
    torch.cuda.synchronize()
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(a, w), name



@pytest.mark.parametrize("b,s,p,h", [(2, 20, 128, 4), (1, 130, 192, 3), (2, 709, 768, 12)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("chained", [False, True])
def test_f32_backward_with_a_bf16_bias_matches_plain(cuda, b, s, p, h, rate, chained):
    """f32 q/k/v with a bf16 bias (gbias and dbias bf16 too), the backward
    tiling that keeps 64-wide blocks: #8, and #6 on the contiguous layout,
    against their plain versions, dq/dk/dv within the f32 bar and dbias,
    rounded to bf16 by both, within the bf16 one; dbias past S exactly 0, or
    gbias when chained."""
    q, k, v = _f32(cuda, b, s, h)
    bias = _train_bias(cuda, b, s, p, h, torch.bfloat16)
    g = torch.Generator().manual_seed(5)
    do = torch.randn((b, s, h * 64), generator=g).to(cuda)
    gbias = (torch.randn((b, h, p, p), generator=g) * 1e-3).to(cuda, torch.bfloat16)
    gbias = gbias if chained else None
    o, lse = flash_attention_packed_train_fwd_plain(q, k, v, bias, 99, h, rate)
    args = (q, k, v, bias, 99, o, lse, do, h, rate, gbias)
    got = flash_attention_packed_train_bwd(*args)
    want = flash_attention_packed_train_bwd_plain(*args)
    views = [_heads_view(x, h, "contiguous") for x in (q, k, v, do, o)]
    hargs = (*views[:3], bias, 99, views[4], lse, views[3], rate)
    got_h = flash_attention_bwd(*hargs)
    want_h = flash_attention_bwd_plain(*hargs)
    torch.cuda.synchronize()
    for name, a, w in [*zip(("dq", "dk", "dv"), got, want),
                       *zip(("head dq", "head dk", "head dv"), got_h, want_h)]:
        _assert_f32_close(name, a, w)
    for name, a, w in (("dbias", got[3], want[3]), ("head dbias", got_h[3], want_h[3])):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all(), name
        assert _scaled_err(a, w) <= 2e-2, (name, _scaled_err(a, w))
    pad = got[3][:, :, s:, :]
    assert torch.equal(pad, torch.zeros_like(pad) if gbias is None else gbias[:, :, s:, :])
    assert not got_h[3][:, :, s:, :].any() and not got_h[3][:, :, :, s:].any()


# the f32 forwards (#2, #5, #7) on split operands: one split pre-pass per
# call, odd P / 64 (one warpgroup live in the last tile), the paths' 709
# inside 768, P = 64


@pytest.mark.parametrize("b,s,p,h", F32_BWD_SHAPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_f32_forwards_give_the_same_bits_twice(cuda, b, s, p, h, rate):
    """#2, #7 and #5 (both layouts) in f32: a second run gives the same bits,
    and at rate 0 the training forward gives #2's (one template, one split)."""
    q, k, v = _f32(cuda, b, s, h)
    bias = _train_bias(cuda, b, s, p, h, torch.float32)
    runs = [((flash_attention_packed(q, k, v, bias, h),),
             (flash_attention_packed(q, k, v, bias, h),)),
            (flash_attention_packed_train_fwd(q, k, v, bias, 99, h, rate),
             flash_attention_packed_train_fwd(q, k, v, bias, 99, h, rate))]
    for layout in ("contiguous", "packed"):
        views = [_heads_view(x, h, layout) for x in (q, k, v)]
        runs.append((flash_attention_fwd(*views, bias, 99, rate, with_lse=True),
                     flash_attention_fwd(*views, bias, 99, rate, with_lse=True)))
    torch.cuda.synchronize()
    for first, again in runs:
        for a, w in zip(first, again):
            real = a[:, :, :s] if a.shape == (b, h, p) else a  # the lse: +inf past S
            assert torch.isfinite(real).all()
            assert torch.equal(a, w)
    if rate == 0.0:
        assert torch.equal(runs[1][0][0], runs[0][0][0])


@pytest.mark.parametrize("b,s,p,h", [(2, 20, 128, 4), (1, 130, 192, 3), (2, 709, 768, 12)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_f32_forward_with_a_bf16_bias_matches_plain(cuda, b, s, p, h, rate):
    """f32 q/k/v with a bf16 bias (the 177 KB ring): #7, #2 at rate 0, and #5
    at both layouts, against their plain versions within the f32 bar."""
    q, k, v = _f32(cuda, b, s, h)
    bias = _train_bias(cuda, b, s, p, h, torch.bfloat16)
    out, lse = flash_attention_packed_train_fwd(q, k, v, bias, 99, h, rate)
    want_out, want_lse = flash_attention_packed_train_fwd_plain(q, k, v, bias, 99, h, rate)
    got = [("out", out, want_out), ("lse", lse[:, :, :s], want_lse[:, :, :s])]
    if rate == 0.0:
        got.append(("#2 out", flash_attention_packed(q, k, v, bias, h),
                    flash_attention_packed_plain(q, k, v, bias, h)))
    for layout in ("contiguous", "packed"):
        views = [_heads_view(x, h, layout) for x in (q, k, v)]
        o_h, lse_h = flash_attention_fwd(*views, bias, 99, rate, with_lse=True)
        want_o, want_l = flash_attention_fwd_plain(*views, bias, 99, rate)
        got += [(f"{layout} out", o_h, want_o), (f"{layout} lse", lse_h[:, :, :s], want_l[:, :, :s])]
    torch.cuda.synchronize()
    for name, a, w in got:
        _assert_f32_close(name, a, w)


def test_forward_splits_f32_operands_only(cuda):
    """Each f32 forward launches one split pre-pass (of k and v) before its
    kernel; a bf16 forward launches none."""
    b, s, p, h = 1, 130, 192, 3
    for dtype, splits in ((torch.bfloat16, 0), (torch.float32, 1)):
        q, k, v = _qkv(cuda, b, s, h, 0, dtype)
        bias = _train_bias(cuda, b, s, p, h, dtype)
        views = [_heads_view(x, h, "packed") for x in (q, k, v)]
        for name, fn, call in (
                ("flash_attention_packed", flash_attention_packed,
                 lambda: flash_attention_packed(q, k, v, bias, h)),
                ("flash_attention_packed_train_fwd", flash_attention_packed_train_fwd,
                 lambda: flash_attention_packed_train_fwd(q, k, v, bias, 3, h, 0.1)),
                ("flash_attention_fwd", flash_attention_fwd,
                 lambda: flash_attention_fwd(*views, bias, 3, 0.1, with_lse=True))):
            before, split_before = fn.launches, split_bf16x3.launches
            call()
            assert fn.launches == before + 1, name
            assert split_bf16x3.launches == split_before + splits, (name, dtype)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# head dims below 64: every entry point zero-pads q/k/v to the kernels' 64
# (at_kernel_head_dim) and slices the output, autograd the gradients
# ---------------------------------------------------------------------------


def _small_heads(device, b, s, h, d, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, s, h * d), generator=g).to(device, dtype) for _ in range(4)]


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_dims_below_64_run_the_kernels(cuda, d, dtype):
    """The packed, training (chained, with gradients), head-form and fused
    entry points at D = 16 and 32 launch the kernels and agree with the
    plain versions at D: bf16 within the D = 64 tests' bars, f32 within
    ``F32_BAR`` of each output's scale."""
    _entries_at_head_dim(cuda, d, dtype, h=4)


@pytest.mark.parametrize("d", [96, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_dims_96_and_128_run_the_kernels(cuda, d, dtype):
    """The same at D = 96 (padded to the kernels' 128) and 128, two heads."""
    _entries_at_head_dim(cuda, d, dtype, h=2)


def _entries_at_head_dim(cuda, d, dtype, h):
    b, s, p = 2, 70, 128
    q, k, v, do = _small_heads(cuda, b, s, h, d, dtype)
    bias = _train_bias(cuda, b, s, p, h, dtype)
    bar = F32_BAR if dtype == torch.float32 else 2e-2

    def close(name, got, want):
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert torch.isfinite(got.float()).all(), name
        assert _scaled_err(got, want) <= bar, (name, _scaled_err(got, want))

    before = flash_attention_packed.launches
    close("packed", flash_attention_packed(q, k, v, bias, h),
          flash_attention_packed_plain(q, k, v, bias, h))
    assert flash_attention_packed.launches == before + 1
    views = [x.view(b, s, h, d).transpose(1, 2) for x in (q, k, v)]
    before = flash_attention_fwd.launches
    close("head form", flash_attention(*views, bias),
          flash_attention_fwd_plain(*views, bias)[0])
    assert flash_attention_fwd.launches == before + 1

    ts = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    counters = (flash_attention_packed_train_fwd, flash_attention_packed_train_bwd)
    before = [f.launches for f in counters]
    out, _ = flash_attention_packed_train_chained(*ts, bias, 7, h, 0.1)
    out.backward(do)
    assert [f.launches - n for f, n in zip(counters, before)] == [1, 2]
    want_o, lse = flash_attention_packed_train_fwd_plain(q, k, v, bias, 7, h, 0.1)
    wants = flash_attention_packed_train_bwd_plain(q, k, v, bias, 7, want_o, lse, do, h, 0.1)
    close("train out", out.detach(), want_o)
    for name, t, w in zip(("dq", "dk", "dv"), ts, wants):
        close(name, t.grad, w)

    args = _bias_args(cuda, b, s, h)
    before = fused_bias_attention.launches
    got = fused_bias_attention(*views, *args)
    assert fused_bias_attention.launches == before + 1
    close("fused", got, fused_bias_attention_plain(*views, *args))
    # the padded kernels share their arithmetic: bit-equal to the padded pair
    pair = flash_attention_packed(q, k, v, materialize_bias(*args, out_dtype=dtype), h)
    assert torch.equal(got.transpose(1, 2).reshape(b, s, -1), pair)


def test_a_head_dim_above_64_raises(cuda):
    """D = 192 (a kernel width of the wide mode) and 200 (padded to 256),
    above 128, where the entry points raised before the wide mode existed:
    each entry point now runs on the kernels and agrees with the plain
    versions at D, in bf16 and f32, two heads."""
    for d in (192, 200):
        for dtype in (torch.bfloat16, torch.float32):
            _entries_at_head_dim(cuda, d, dtype, h=2)


# ---------------------------------------------------------------------------
# head dim 128: every attention kernel's 128-wide instantiation against its
# plain version, at the bars of the 64-wide tests, and the same bits twice
# ---------------------------------------------------------------------------

# P = S rounded up to 128; P / 128 not whole; the paths' ragged shape in
# heads of 128 (hidden 768)
D128_SHAPES = [(2, 20, 128, 2), (1, 130, 192, 3), (2, 709, 768, 6)]


def _qkv128(device, b, s, h, dtype, seed=0, d=128):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, s, h * d), generator=g).to(device, dtype) for _ in range(4)]


# the wide mode: head dims above 128 in 64-column groups, at P = S rounded
# up to 128, P / 128 not whole, and the paths' ragged shape
WIDE_DIMS = [192, 256, 320]
WIDE_SHAPES = [(2, 20, 128, 2), (1, 130, 192, 2), (1, 709, 768, 2)]


@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("b,s,p,h", WIDE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
def test_wide_forwards_match_plain(cuda, d, b, s, p, h, dtype, bias_dtype):
    """#2, #5 and #7 (rates 0 and 0.1) in the wide mode."""
    _forwards_match_plain(cuda, b, s, p, h, dtype, bias_dtype, d)


@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("b,s,p,h", WIDE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("chained", [False, True])
def test_wide_backwards_match_plain(cuda, d, b, s, p, h, dtype, rate, chained):
    """#8 (plain and chained) and #6 in the wide mode, the same bits twice."""
    _backwards_match_plain(cuda, b, s, p, h, dtype, rate, chained, d)


@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("b,s,p,h", WIDE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_tables_fused_and_split_match_plain(cuda, d, b, s, p, h, dtype):
    """#9 (rate 0.1), #3 and the split pre-pass in the wide mode."""
    _tables_fused_and_split_match_plain(cuda, b, s, p, h, dtype, d)


@pytest.mark.parametrize("b,s,p,h", D128_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
def test_d128_forwards_match_plain(cuda, b, s, p, h, dtype, bias_dtype):
    """#2, #5 and #7 (rates 0 and 0.1) at D = 128."""
    _forwards_match_plain(cuda, b, s, p, h, dtype, bias_dtype)


def _forwards_match_plain(cuda, b, s, p, h, dtype, bias_dtype, d=128):
    q, k, v, _ = _qkv128(cuda, b, s, h, dtype, d=d)
    bias = _train_bias(cuda, b, s, p, h, bias_dtype)
    f32 = dtype == torch.float32
    bar = F32_BAR if f32 else 2e-2
    before = flash_attention_packed.launches
    got = flash_attention_packed(q, k, v, bias, h)
    assert flash_attention_packed.launches == before + 1
    assert torch.equal(flash_attention_packed(q, k, v, bias, h), got)
    want = flash_attention_packed_plain(q, k, v, bias, h)
    assert _scaled_err(got, want) <= bar, _scaled_err(got, want)
    views = [_heads_view(x, h, "packed") for x in (q, k, v)]
    for rate in (0.0, 0.1):
        out, lse = flash_attention_packed_train_fwd(q, k, v, bias, 1234, h, rate)
        w_out, w_lse = flash_attention_packed_train_fwd_plain(q, k, v, bias, 1234, h, rate)
        assert _scaled_err(out, w_out) <= bar, (rate, _scaled_err(out, w_out))
        torch.testing.assert_close(lse[:, :, :s], w_lse[:, :, :s], atol=1e-4, rtol=1e-5)
        if rate == 0.0:  # the training forward at rate 0 is the serving kernel's arithmetic
            assert torch.equal(out, got)
        ho, hl = flash_attention_fwd(*views, bias, 1234, rate, with_lse=True)
        assert torch.equal(ho.transpose(1, 2).reshape(b, s, -1), out)
        assert torch.equal(hl, lse)
    torch.cuda.synchronize()


def _widen(x):
    return x.to(torch.float32) if x is not None and x.dtype == torch.bfloat16 else x


@pytest.mark.parametrize("b,s,p,h", D128_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("chained", [False, True])
def test_d128_backwards_match_plain(cuda, b, s, p, h, dtype, rate, chained):
    """#8 (plain and chained) and #6 at D = 128, the same bits twice; f32
    operands with an f32 and with a bf16 bias (widened by the wrapper)."""
    _backwards_match_plain(cuda, b, s, p, h, dtype, rate, chained)


def _backwards_match_plain(cuda, b, s, p, h, dtype, rate, chained, d=128):
    q, k, v, do = _qkv128(cuda, b, s, h, dtype, seed=3, d=d)
    f32 = dtype == torch.float32
    for bias_dtype in ((torch.float32, torch.bfloat16) if f32 else (torch.bfloat16,)):
        bias = _train_bias(cuda, b, s, p, h, bias_dtype)
        g = torch.Generator().manual_seed(5)
        gbias = ((torch.randn((b, h, p, p), generator=g) * 1e-3).to(cuda, bias_dtype)
                 if chained else None)
        o, lse = flash_attention_packed_train_fwd_plain(q, k, v, bias, 99, h, rate)
        before = flash_attention_packed_train_bwd.launches
        got = flash_attention_packed_train_bwd(q, k, v, bias, 99, o, lse, do, h, rate, gbias)
        assert flash_attention_packed_train_bwd.launches == before + 2
        again = flash_attention_packed_train_bwd(q, k, v, bias, 99, o, lse, do, h, rate, gbias)
        want = flash_attention_packed_train_bwd_plain(q, k, v, _widen(bias) if f32 else bias,
                                                      99, o, lse, do, h, rate,
                                                      _widen(gbias) if f32 else gbias)
        for name, a, w, a2 in zip(("dq", "dk", "dv", "dbias"), got, want, again):
            assert a.shape == w.shape and torch.isfinite(a.float()).all(), name
            assert torch.equal(a, a2), name
            bar = F32_BAR if f32 and name != "dbias" else 2e-2
            assert _scaled_err(a, w) <= bar, (name, bias_dtype, _scaled_err(a, w))
        if not chained:
            views = [_heads_view(x, h, "packed") for x in (q, k, v, o, do)]
            hf = flash_attention_bwd(*views[:3], bias, 99, views[3], lse, views[4], rate)
            for name, a, w in zip(("dq", "dk", "dv", "dbias"), hf, got):
                a = a.transpose(1, 2).reshape(b, s, -1) if name != "dbias" else a
                assert torch.equal(a, w if name != "dbias" else w[:, :, :p, :p]), name
    torch.cuda.synchronize()


@pytest.mark.parametrize("b,s,p,h", D128_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_d128_tables_fused_and_split_match_plain(cuda, b, s, p, h, dtype):
    """#9 (rate 0.1), #3 and the split pre-pass at D = 128."""
    _tables_fused_and_split_match_plain(cuda, b, s, p, h, dtype)


def _tables_fused_and_split_match_plain(cuda, b, s, p, h, dtype, d=128):
    args = _bias_args(cuda, b, s, h)
    pos, cx, cy = args[:3]
    q, k, v, do = _qkv128(cuda, b, s, h, dtype, seed=4, d=d)
    f32 = dtype == torch.float32
    bias = _tables_bias(args, p, dtype)
    o, lse = flash_attention_packed_train_fwd_plain(q, k, v, bias, 99, h, 0.1)
    got = flash_attention_packed_train_tables_bwd(q, k, v, bias, pos, cx, cy, 99, o, lse, do,
                                                  h, 0.1)
    again = flash_attention_packed_train_tables_bwd(q, k, v, bias, pos, cx, cy, 99, o, lse, do,
                                                    h, 0.1)
    want = flash_attention_packed_train_tables_bwd_plain(q, k, v, bias, pos, cx, cy, 99, o,
                                                         lse, do, h, 0.1)
    for name, a, w, a2 in zip(("dq", "dk", "dv", "dt1", "dtx", "dty"), got, want, again):
        assert torch.equal(a, a2), name
        limit = (F32_BAR if f32 else 2e-2) if name in ("dq", "dk", "dv") else 1e-3
        assert _scaled_err(a, w) <= limit, (name, _scaled_err(a, w))
    views = [_heads_view(x, h, "packed") for x in (q, k, v)]
    fused = fused_bias_attention(*views, *args)
    want_f = fused_bias_attention_plain(*views, *args)
    assert _scaled_err(fused, want_f) <= (F32_BAR if f32 else 2e-2)
    pair = flash_attention_packed(q, k, v, materialize_bias(*args, out_dtype=dtype), h)
    assert torch.equal(fused.transpose(1, 2).reshape(b, s, -1), pair)
    if f32:
        x = [_heads_view(a, h, "packed") for a in (q, k, v, do)]
        parts = split_bf16x3(*x)
        assert parts.shape == (4, 3, b, h, s, d)
        for i in range(4):
            assert torch.equal(parts[i], split_bf16x3_plain(x[i]))
    torch.cuda.synchronize()


# the tiny config's widths with wider heads, by head dim: hidden 384 in 4
# heads of 96 (padded to the kernels' 128) and 512 in 4 heads of 128 (the
# layout embeddings' 4 coordinate + 2 shape widths sum to the hidden size)
WIDE_HEADS = {96: dict(hidden_size=384, coordinate_size=64, shape_size=64),
              128: dict(hidden_size=512, coordinate_size=96, shape_size=64)}


def _tiny_setup(head_dim=16):
    """The tiny config as the repo defines it (4 heads of 16), or with the
    wider heads of ``WIDE_HEADS``, random weights, and 20 documents of 32
    tokens on the CPU."""
    from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig
    from multi_modal_early_exit_tpu_torch.models.ee.model import init_ee_params
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import (
        EEModelConfig,
        LayoutLMv3Config,
    )

    backbone = LayoutLMv3Config.tiny(num_labels=4)
    if head_dim != 16:
        widths = WIDE_HEADS[head_dim]
        backbone = backbone.replace(intermediate_size=2 * widths["hidden_size"], **widths)
    cfg = EEModelConfig(backbone=backbone, exit=ExitConfig(exits=("text_avg", 1)))
    assert cfg.backbone.hidden_size // cfg.backbone.num_attention_heads == head_dim
    model = init_ee_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    n, s = 20, 32
    lengths = torch.randint(8, s + 1, (n,), generator=g)
    feats = {
        "input_ids": torch.randint(3, 1000, (n, s), generator=g),
        "bbox": torch.sort(torch.randint(0, 1000, (n, s, 4), generator=g), -1).values,
        "attention_mask": (torch.arange(s)[None] < lengths[:, None]).to(torch.int32),
        "pixel_values": torch.randn((n, 3, 32, 32), generator=g),
    }
    return cfg, model, feats


def test_tiny_config_serves_on_the_card(cuda):
    """The tiny config through ``Pipeline.predict_features`` on the card,
    its attention in the kernels: f32 logits within the north star's f32
    bars (atol 2e-4, rtol 1e-3) of the CPU path's, the same exits and
    labels, and in bf16 well-formed results."""
    _serves_on_the_card(cuda, 16)


@pytest.mark.parametrize("head_dim", sorted(WIDE_HEADS))
def test_wide_head_configs_serve_and_train_on_the_card(cuda, head_dim):
    """The tiny config at head dims 96 and 128 serves and trains on the card
    through the kernels, at the bars of the tiny config's tests."""
    _serves_on_the_card(cuda, head_dim)
    for bf16 in (False, True):
        _trains_on_the_card(cuda, bf16, head_dim)


def _serves_on_the_card(cuda, head_dim):
    import copy

    from multi_modal_early_exit_tpu_torch.data.features import HashWordTokenizer
    from multi_modal_early_exit_tpu_torch.models.ee.model import ee_forward
    from multi_modal_early_exit_tpu_torch.serving import Pipeline

    cfg, model, feats = _tiny_setup(head_dim)
    small = [feats[k][:4] for k in ("input_ids", "bbox", "pixel_values", "attention_mask")]
    with torch.no_grad():
        want = ee_forward(model, cfg, *small).policy_logits()
        before = (materialize_bias.launches, flash_attention_packed.launches)
        got = ee_forward(copy.deepcopy(model).to(cuda), cfg, *[a.to(cuda) for a in small])
        got = got.policy_logits().cpu()
    assert (materialize_bias.launches - before[0], flash_attention_packed.launches - before[1]) \
        == (1, cfg.backbone.num_hidden_layers)
    assert ((got - want).abs() <= 2e-4 + 1e-3 * want.abs()).all(), (got - want).abs().max()
    # full capacities and a threshold no confidence reaches: every document
    # takes the final exit on both devices, whatever the last bits
    kwargs = dict(batch_size=16, seq_len=32, tokenizer=HashWordTokenizer(vocab_size=1024),
                  threshold=2.0)
    cpu = Pipeline(copy.deepcopy(model), cfg, device="cpu", **kwargs).predict_features(feats)
    for dtype in (torch.float32, torch.bfloat16):
        pipe = Pipeline(copy.deepcopy(model).to(dtype=dtype), cfg, device=cuda, **kwargs)
        before = flash_attention_packed.launches
        results = pipe.predict_features(feats)
        assert flash_attention_packed.launches > before
        assert len(results) == len(cpu) == 20
        for r, c in zip(results, cpu):
            assert 0.0 <= r["confidence"] <= 1.0 and r["label_id"] in range(4), r
            assert r["exit"] == c["exit"], (r, c)
            if dtype == torch.float32:
                assert abs(r["confidence"] - c["confidence"]) <= 2e-4 + 1e-3 * c["confidence"]


@pytest.mark.parametrize("bf16", [False, True])
def test_tiny_config_trains_on_the_card(cuda, bf16):
    """One ``EETrainer`` step of the tiny config on the card through the
    training kernels (bf16 and f32), and the f32 loss gradients against the
    CPU path within 1e-4 of each tensor's largest gradient, dropout 0 (the
    key biases' true gradient is 0: rounding noise there, held below 1e-10
    of the largest gradient, as for one head of 64)."""
    _trains_on_the_card(cuda, bf16, 16)


def _trains_on_the_card(cuda, bf16, head_dim):
    import copy

    from multi_modal_early_exit_tpu_torch.training.losses import ee_loss_fn
    from multi_modal_early_exit_tpu_torch.training.trainer import EETrainer, TrainingArguments

    cfg, model, feats = _tiny_setup(head_dim)
    batch = {k: v[None, :4] for k, v in feats.items()}
    batch["labels"] = torch.tensor([[0, 3, 1, 2]])
    trainer = EETrainer(cfg, copy.deepcopy(model), TrainingArguments(bf16=bf16), 1, device=cuda)
    before = flash_attention_packed_train_bwd.launches
    loss, _ = trainer.train_step(batch, torch.Generator().manual_seed(1))
    assert math.isfinite(loss)
    assert flash_attention_packed_train_bwd.launches == before + 2 * cfg.backbone.num_hidden_layers
    assert not torch.equal(trainer.model.backbone.encoder.layers[0].attention.query.weight.cpu(),
                           model.backbone.encoder.layers[0].attention.query.weight)

    rates = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                 classifier_dropout=0.0)
    cfg0 = cfg.replace(backbone=cfg.backbone.replace(**rates))
    small = {k: v[0] for k, v in batch.items()}

    def grads(m, device):
        loss, _ = ee_loss_fn(m, cfg0, small, device=device)
        return loss.item(), torch.autograd.grad(loss, list(m.parameters()), allow_unused=True)

    before = flash_attention_packed.launches
    gpu_loss, gpu = grads(copy.deepcopy(model).to(cuda), cuda)
    assert flash_attention_packed.launches > before
    cpu_loss, cpu = grads(model, "cpu")
    assert abs(gpu_loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    big = max(w.abs().max().item() for w in cpu if w is not None)
    for (name, _), a, w in zip(model.named_parameters(), gpu, cpu):
        if w is None:
            assert a is None or not a.any(), name
            continue
        assert torch.isfinite(a).all(), name
        if name.endswith(".key.bias"):
            assert max(a.abs().max().item(), w.abs().max().item()) <= 1e-10 * big, name
        else:
            assert _scaled_err(a.cpu(), w) <= 1e-4, (name, _scaled_err(a.cpu(), w))


# ---------------------------------------------------------------------------
# LayoutLMv2's shape: 512 text tokens + a 7x7 visual grid, S = 561 inside
# P = 640, unscaled relative-position tables (v2 adds its bias unscaled)
# ---------------------------------------------------------------------------

V2_S, V2_P = 561, 640


def _v2_bias_args(device, b=4, h=12, seed=7):
    """The v2 sequence's bias inputs as ``layoutlmv2.modeling`` builds them:
    text positions then visual ones restarting at 0, word boxes then the
    grid's, ragged text masks; the tables at the raw scale of v2's
    (no 1/sqrt(d) folded in)."""
    from multi_modal_early_exit_tpu_torch.models.layoutlmv2.config import LayoutLMv2Config
    from multi_modal_early_exit_tpu_torch.models.layoutlmv2.modeling import sequence_layout

    cfg = LayoutLMv2Config.base()
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(50, 513, (b,), generator=g)
    mask = (torch.arange(512)[None] < lengths[:, None]).to(torch.int32)
    bbox = torch.sort(torch.randint(0, 1000, (b, 512, 4), generator=g), -1).values
    full_bbox, pos, full_mask = sequence_layout(cfg, bbox, mask, cfg.num_visual_tokens)
    tables = [torch.randn((n, h), generator=g) * 0.02
              for n in (cfg.rel_pos_bins, cfg.rel_2d_pos_bins, cfg.rel_2d_pos_bins)]
    args = [pos, full_bbox[:, :, 0].contiguous(), full_bbox[:, :, 3].contiguous(), full_mask]
    return [x.to(device) for x in args + tables]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_v2_bias_and_serving_attention_match_plain(cuda, dtype):
    """#1 bit-equal to its plain version at S = 561 (P = 640) with the
    unscaled tables, then #2 on that bias within its tolerance (bf16: one
    bf16 step; f32: 1e-4 of the output's scale)."""
    args = _v2_bias_args(cuda)
    bias = materialize_bias(*args, out_dtype=dtype)
    assert bias.shape == (4, 12, V2_P, V2_P)
    assert torch.equal(bias, materialize_bias_plain(*args, out_dtype=dtype))
    q, k, v = _qkv(cuda, 4, V2_S, 12, dtype=dtype)
    before = flash_attention_packed.launches
    got = flash_attention_packed(q, k, v, bias, 12)
    assert flash_attention_packed.launches == before + 1
    want = flash_attention_packed_plain(q, k, v, bias, 12)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)
    else:
        assert _scaled_err(got, want) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_v2_training_kernels_match_plain(cuda, dtype):
    """v2's training step at its shape: #7 at dropout 0.1 (out, lse), #8
    plain (unchained: v2 never chains the bias) and #4 on #8's dbias,
    against their plain versions at the training kernels' tolerances (bf16:
    2e-2 of each output's scale; f32: 1e-4; the tables 1e-4)."""
    args = _v2_bias_args(cuda, seed=8)
    bias = materialize_bias(*args, out_dtype=dtype)
    q, k, v = _qkv(cuda, 4, V2_S, 12, seed=2, dtype=dtype)
    out, lse = flash_attention_packed_train_fwd(q, k, v, bias, 77, 12, 0.1)
    want_out, want_lse = flash_attention_packed_train_fwd_plain(q, k, v, bias, 77, 12, 0.1)
    bar = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert _scaled_err(out, want_out) <= bar
    torch.testing.assert_close(lse[:, :, :V2_S], want_lse[:, :, :V2_S], atol=1e-4, rtol=1e-5)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(9)).to(cuda, dtype)
    before = flash_attention_packed_train_bwd.launches
    got = flash_attention_packed_train_bwd(q, k, v, bias, 77, want_out, want_lse, do, 12, 0.1)
    assert flash_attention_packed_train_bwd.launches == before + 2
    want = flash_attention_packed_train_bwd_plain(q, k, v, bias, 77, want_out, want_lse, do, 12,
                                                  0.1)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert torch.isfinite(a.float()).all(), name
        assert _scaled_err(a, w) <= bar, (name, _scaled_err(a, w))
    assert not got[3][:, :, V2_S:, :].any()  # pad rows get no cotangent
    pos, cx, cy = args[:3]
    grads = table_grads(pos, cx, cy, got[3])
    for a, w in zip(grads, table_grads_plain(pos, cx, cy, got[3])):
        assert _scaled_err(a, w) <= 1e-4


def test_tiny_v2_runs_on_the_card(cuda):
    """The tiny LayoutLMv2 (heads of 16, padded to the kernels' 64) in f32:
    the forward on the card within the f32 bars of the CPU's (atol 2e-4 /
    rtol 1e-3), 1 #1 and one #2 per layer; one bf16 ``EETrainer`` step
    through #1, #7, #8 and #4."""
    import copy

    from multi_modal_early_exit_tpu_torch.models.layoutlmv2 import modeling as v2
    from multi_modal_early_exit_tpu_torch.models.layoutlmv2.config import LayoutLMv2Config
    from multi_modal_early_exit_tpu_torch.training.trainer import EETrainer, TrainingArguments

    cfg = LayoutLMv2Config.tiny()
    model = v2.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    x0 = torch.randint(0, 900, (3, 20), generator=g)
    feats = (torch.randint(3, 900, (3, 20), generator=g),
             torch.stack([x0, x0 // 2, x0 + 50, x0 // 2 + 30], -1),
             torch.randn((3, 3, 32, 32), generator=g), torch.ones((3, 20), dtype=torch.int32))
    with torch.no_grad():
        want = v2.forward_sequence_classification(model, cfg, *feats).logits
        before = (materialize_bias.launches, flash_attention_packed.launches)
        got = v2.forward_sequence_classification(copy.deepcopy(model).to(cuda), cfg,
                                                 *(f.to(cuda) for f in feats)).logits
    assert (materialize_bias.launches - before[0], flash_attention_packed.launches - before[1]) \
        == (1, cfg.num_hidden_layers)
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=1e-3)

    trainer = EETrainer(cfg, copy.deepcopy(model), TrainingArguments(bf16=True), 1, device=cuda)
    batch = {k: v[None] for k, v in zip(("input_ids", "bbox", "pixel_values", "attention_mask"),
                                        feats)}
    batch["labels"] = torch.tensor([[0, 3, 1]])
    counts = (flash_attention_packed_train_fwd.launches, flash_attention_packed_train_bwd.launches,
              table_grads.launches)
    loss, _ = trainer.train_step(batch, torch.Generator().manual_seed(2))
    assert math.isfinite(loss)
    assert (flash_attention_packed_train_fwd.launches - counts[0],
            flash_attention_packed_train_bwd.launches - counts[1],
            table_grads.launches - counts[2]) == (2, 4, 2)
