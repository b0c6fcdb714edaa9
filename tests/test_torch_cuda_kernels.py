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
)
from multi_modal_early_exit_tpu_torch.ops.fused_bias_attention import (
    materialize_bias,
    materialize_bias_plain,
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
