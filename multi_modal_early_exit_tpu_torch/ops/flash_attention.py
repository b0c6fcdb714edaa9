"""Fused attention with an additive bias on the packed layout:
``flash_attention_packed``.

    out = softmax(q k^T * d^-1/2 + bias) v      per (batch, head)

q/k/v and the output are (B, S, H*D) — the projections' own layout, no head
transpose — and the bias is (B, H, P, P) with P >= S (pre-padded by the
bias kernel; keys j >= S do not exist). Deterministic: no dropout.

On a CUDA tensor ``flash_attention_packed`` launches the hand-written kernel
``csrc/flash_attention_packed.cu`` (bf16 q/k/v, head dim 64, bias bf16 or
f32); on a CPU tensor it runs ``flash_attention_packed_plain``: dense f32
scores from the same inputs, softmax, p cast to v's dtype, then p v.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from multi_modal_early_exit_tpu_torch.ops import cuda_build

KERNEL_HEAD_DIM = 64


def flash_attention_packed_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """Plain PyTorch ``flash_attention_packed`` (dense (B, H, S, S) scores)."""
    b, s, hd = q.shape
    d = hd // num_heads

    def heads(x):
        return x.reshape(b, s, num_heads, d).transpose(1, 2).to(torch.float32)

    scores = torch.matmul(heads(q), heads(k).transpose(-1, -2))
    scores = scores * (1.0 / math.sqrt(d)) + bias[:, :, :s, :s].to(torch.float32)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(p.to(torch.float32), heads(v))
    return out.transpose(1, 2).reshape(b, s, hd).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _flash_attention_packed_fn():
    lib = cuda_build.load("flash_attention_packed")
    fn = lib.mmee_flash_attention_packed
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib, fn


def flash_attention_packed(
    q: torch.Tensor,     # (B, S, H*D)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # (B, H, P, P), P >= S, mask included
    num_heads: int,
) -> torch.Tensor:
    """Returns (B, S, H*D) in q's dtype. CPU tensors run the plain version;
    CUDA tensors launch the kernel (counted in
    ``flash_attention_packed.launches``)."""
    b, s, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must share one (B, S, H*D) shape")
    if hd % num_heads:
        raise ValueError(f"width {hd} does not split into {num_heads} heads")
    if (bias.ndim != 4 or bias.shape[:2] != (b, num_heads)
            or bias.shape[2] != bias.shape[3] or bias.shape[3] < s):
        raise ValueError(
            f"bias must be (B, H, P, P) with P >= {s}; got {tuple(bias.shape)}"
        )
    device = q.device
    if device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, bias, num_heads)
    if device.type != "cuda":
        raise ValueError(f"flash_attention_packed runs on cuda or cpu, not {device}")
    for t in (q, k, v, bias):
        if t.device != device or not t.is_contiguous():
            raise ValueError("flash_attention_packed takes contiguous tensors on one device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError("the flash_attention_packed kernel takes bfloat16 q, k, v")
    if bias.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"bias must be bfloat16 or float32, not {bias.dtype}")
    d = hd // num_heads
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {KERNEL_HEAD_DIM}, not {d}")
    out = torch.empty_like(q)
    lib, fn = _flash_attention_packed_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            int(bias.dtype == torch.bfloat16), out.data_ptr(),
            b, s, num_heads, bias.shape[-1], 1.0 / math.sqrt(d), stream,
        )
    cuda_build.check(lib, code, "flash_attention_packed")
    flash_attention_packed.launches += 1
    return out


flash_attention_packed.launches = 0
