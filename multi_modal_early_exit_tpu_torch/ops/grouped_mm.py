"""Grouped matrix products: one call multiplies each group of rows by its
own matrix, as a mixture-of-experts layer needs for the tokens routed to
each expert.

``grouped_mm(x, w, offs)``: rows ``offs[e - 1]:offs[e]`` of x (P, K) times
``w[e]`` (N, K) transposed, for every group e at once, into (P, N). No TPU
kernel has this job: the JAX package runs no expert layer. On CUDA tensors it
is PyTorch's grouped product (``torch._grouped_mm``, CUTLASS's grouped GEMM
on sm_90, bf16 operands, f32 sums), one launch for all groups and no host
sync, since the group ends stay on the card; what it does not take raises.
On CPU tensors it is the plain loop over the groups.
"""

from __future__ import annotations

import torch


def grouped_mm_plain(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """The loop over the groups: ``x[a:b] @ w[e].T`` for each group e."""
    ends = offs.tolist()
    starts = [0] + ends[:-1]
    out = x.new_empty((x.shape[0], w.shape[1]))
    for e, (a, b) in enumerate(zip(starts, ends)):
        if b > a:
            out[a:b] = x[a:b] @ w[e].T
    return out


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """(P, N): x (P, K) rows grouped by ``offs`` (E,) int32, the running
    ends of the groups, each group times its ``w[e]`` (N, K) transposed."""
    if not x.is_cuda:
        return grouped_mm_plain(x, w, offs)
    return torch._grouped_mm(x, w.transpose(-2, -1), offs=offs)
