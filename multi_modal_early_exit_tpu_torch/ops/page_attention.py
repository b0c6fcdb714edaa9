"""Bidirectional attention within each page of a packed batch, never across
pages: MoonViT's, where a batch's pages have their own patch counts.

q, k and v hold every page's real patches back to back, (T, heads, D);
page i owns rows ``starts[i]:starts[i + 1]``, so no padding is ever a key.
No TPU kernel has this job (the JAX package's attention is one dense
sequence with a bias). On CUDA tensors it is PyTorch's variable-length
flash attention (``torch.nn.attention.varlen.varlen_attn``, FlashAttention
2's varlen forward: one launch for every page, each query block reading its
own page's keys), which takes MoonViT's head dim of 72 as it is. On an
H100 a 16-page layer (about 35,000 patches) took 1.72-1.73 ms, against
1.54-1.71 ms in 16 per-page cuDNN calls and 2.38 ms in 16 per-page flash
calls: about a fifth of its bound, with one launch a layer. On CPU
tensors it is the plain product and softmax, a page at a time.
"""

from __future__ import annotations

from typing import Sequence

import torch


def page_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         starts: Sequence[int], scale: float) -> torch.Tensor:
    """softmax(q k^T scale) v within each page, the scores in f32."""
    out = []
    for a, b in zip(starts[:-1], starts[1:]):
        qp, kp, vp = (t[a:b].transpose(0, 1) for t in (q, k, v))
        scores = (qp @ kp.transpose(-1, -2)).float() * scale
        out.append((torch.softmax(scores, dim=-1).to(vp.dtype) @ vp).transpose(0, 1))
    return torch.cat(out)


def page_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, starts: Sequence[int],
                   cu_seqlens: torch.Tensor, scale: float) -> torch.Tensor:
    """(T, heads, D): each page's patches attend that page's alone. ``starts``
    are the pages' first rows and T, on the host; ``cu_seqlens`` the same
    as int32 on q's device (the kernel's)."""
    if not q.is_cuda:
        return page_attention_plain(q, k, v, starts, scale)
    from torch.nn.attention.varlen import varlen_attn

    longest = max(b - a for a, b in zip(starts[:-1], starts[1:]))
    return varlen_attn(q, k, v, cu_seqlens, cu_seqlens, longest, longest, scale=scale)
