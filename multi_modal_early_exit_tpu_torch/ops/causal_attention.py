"""Causal attention whose queries and keys are wider than its values, as
multi-head latent attention has them (192 against 128 in Moonlight).

No TPU kernel has this job: the JAX package's attention is bidirectional
with a relative-position bias, which the port's ``fwd_kernel`` (#2) builds
from equal head dims and a dense bias. On CUDA tensors this is PyTorch's
fused attention with ``is_causal`` on its cuDNN backend (cuDNN's sm_90
flash forward on wgmma; at (32, 16, 2048) bf16, 192/128 wide, 1.25 ms
against the memory-efficient backend's 4.75 and the flash backend's 3.36
with v padded to 192, which it needs: it takes one head dim for q, k and
v), which keeps the (S, S) scores on chip; every other backend, the
materialising math one among them, is switched off, so a shape cuDNN does
not take raises. On CPU tensors it is the plain product, mask and softmax.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """softmax(q k^T scale + causal mask) v over (B, H, S, D) inputs."""
    s = q.shape[-2]
    scores = (q @ k.transpose(-1, -2)).float() * scale
    keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~keep, float("-inf"))
    return (torch.softmax(scores, dim=-1).to(v.dtype) @ v)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """(B, H, S, Dv): query i attends keys 0..i; q, k (B, H, S, Dqk), v
    (B, H, S, Dv)."""
    if not q.is_cuda:
        return causal_attention_plain(q, k, v, scale)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale)
