"""Bidirectional attention within each page of a packed batch, never across
pages: MoonViT's, where a batch's pages have their own patch counts.

q, k and v hold every page's real patches back to back, (T, heads, D);
page i owns rows ``starts[i]:starts[i + 1]``, so no padding is ever a key.
No TPU kernel has this job (the JAX package runs no MoonViT).

On CUDA tensors ``page_attention`` launches the hand-written sm_90a kernel
of ``csrc/page_attention.cu``, which replaced PyTorch's ``varlen_attn``
(FlashAttention 2's varlen forward, head dim 72 in 96-wide tiles). One
launch a layer covers every page and head, counted in
``launches.page_attention``. Its bound at a served 16-page layer, about
35,000 patches in 16 heads of 72: 4 x 72 operations a query-key pair and
head, about 0.43 ms at 989 TFLOP/s, against 0.1 ms of bytes (q, k, v read
and o written once). A pair also costs an exp2, and the card's exp unit
needs about 80 % of the tensor cores' time, so two CTAs of two warpgroups
share an SM and one's softmax runs beside another's products: a CTA per
(128-row query tile of a page, head), the longest pages first, a TMA ring
of 128-key k/v stages, both products on ``wgmma`` with the head dim padded
72 -> 80 on chip only (TMA's zero fill), the softmax in f32 with exp2. On
an H100 (700 W) 16 served pages of 36,812 patches take 1.16 ms, 40 % of
their bound (0.46 ms), where ``varlen_attn`` took 2.12 ms. It takes bf16 q, k and
v of head dim 72 at their strides (the last dim contiguous, 16-byte
aligned rows and heads) and raises on anything else; there is no
fallback.

On CPU tensors ``page_attention`` is ``page_attention_plain``: the product
and softmax, a page at a time, the scores in f32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from multi_modal_early_exit_tpu_torch.ops import cuda_build
from multi_modal_early_exit_tpu_torch.utils.profiling import count

HEAD_DIM = 72  # the kernel's head dim, MoonViT's


def page_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         starts: Sequence[int], scale: float) -> torch.Tensor:
    """softmax(q k^T scale) v within each page, the scores in f32."""
    out = []
    for a, b in zip(starts[:-1], starts[1:]):
        qp, kp, vp = (t[a:b].transpose(0, 1) for t in (q, k, v))
        scores = (qp @ kp.transpose(-1, -2)).float() * scale
        out.append((torch.softmax(scores, dim=-1).to(vp.dtype) @ vp).transpose(0, 1))
    return torch.cat(out)


def _operand_refusal(name: str, t: torch.Tensor, shape) -> Optional[str]:
    """Why the kernel does not take ``t`` as a (T, heads, 72) operand, or
    None if it does."""
    if t.dtype != torch.bfloat16:
        return f"{name} is {t.dtype}; the kernel takes bfloat16"
    if t.dim() != 3 or t.shape[-1] != HEAD_DIM:
        return f"{name} must be (T, heads, {HEAD_DIM}), got {tuple(t.shape)}"
    if tuple(t.shape) != tuple(shape):
        return f"{name} is {tuple(t.shape)}, q is {tuple(shape)}"
    if t.stride(2) != 1 or t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
        return (f"{name} must have a contiguous last dim and 16-byte aligned rows and heads, "
                f"got strides {t.stride()}")
    return None


def _refusal(q, k, v, starts: Sequence[int], cu_seqlens: torch.Tensor) -> Optional[str]:
    """Why the kernel does not take these arguments, or None if it does."""
    why = None
    for name, t in (("q", q), ("k", k), ("v", v)):
        why = why or _operand_refusal(name, t, q.shape)
    if why is None and (len(starts) < 2 or starts[0] != 0 or starts[-1] != q.shape[0]
                        or any(b < a for a, b in zip(starts[:-1], starts[1:]))):
        why = f"starts must rise from 0 to T = {q.shape[0]}, got {list(starts)}"
    if why is None and (cu_seqlens.dtype != torch.int32 or cu_seqlens.numel() != len(starts)
                        or not cu_seqlens.is_contiguous() or cu_seqlens.device != q.device):
        why = (f"cu_seqlens must be {len(starts)} contiguous int32 on q's device, got "
               f"{cu_seqlens.dtype} {tuple(cu_seqlens.shape)} on {cu_seqlens.device}")
    if why is None and q.device.type != "cuda":
        why = f"the kernel runs on cuda, not {q.device}"
    return why


@functools.lru_cache(maxsize=None)
def _page_attention_fn():
    lib = cuda_build.load("page_attention")
    fn = lib.mmee_page_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def page_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, starts: Sequence[int],
                   cu_seqlens: torch.Tensor, scale: float) -> torch.Tensor:
    """(T, heads, D): each page's patches attend that page's alone. ``starts``
    are the pages' first rows and T, on the host, from which the launch's
    grid is counted; ``cu_seqlens`` the same as int32 on q's device, from
    which each CTA finds its page (one that finds none stores nothing)."""
    if not q.is_cuda:
        return page_attention_plain(q, k, v, starts, scale)
    why = _refusal(q, k, v, starts, cu_seqlens)
    if why is not None:
        raise ValueError(f"page_attention: {why}")
    t, heads, _ = q.shape
    out = q.new_empty((t, heads, HEAD_DIM))
    if t == 0:
        return out
    lib, fn = _page_attention_fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    host = (ctypes.c_int * len(starts))(*map(int, starts))
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), cu_seqlens.data_ptr(),
                  host, len(starts) - 1, t, heads, q.stride(0), q.stride(1), k.stride(0),
                  k.stride(1), v.stride(0), v.stride(1), scale, stream)
    cuda_build.check(lib, code, "page_attention")
    count("launches.page_attention")
    return out
