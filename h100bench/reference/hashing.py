"""A frozen copy of the position-hash dropout: a uniform [0, 1) value is the
lowbias32 hash of (seed, plane, row, column), so a mask follows from its
seed and the element's position. The 32-bit arithmetic runs in int64, each
result masked to its low 32 bits."""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def _mul(x: torch.Tensor, k: int) -> torch.Tensor:
    return ((x * (k & 0xFFFF)) + (((x * (k >> 16)) & 0xFFFF) << 16)) & M32


def lowbias32(x: torch.Tensor) -> torch.Tensor:
    x = x & M32
    x = x ^ (x >> 16)
    x = _mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform(seed: int, plane, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """f32 uniforms broadcast over ``plane``, ``rows`` and ``cols`` (int64
    tensors): the hash's top 24 bits times 2^-24."""
    dev = rows.device
    plane = torch.as_tensor(plane, dtype=torch.int64, device=dev) & M32
    state = lowbias32((int(seed) & M32) ^ _mul(plane, 0x9E3779B1))
    bits = lowbias32((state + _mul(rows & M32, 0x85EBCA77) + _mul(cols & M32, 0x27D4EB2F)) & M32)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def keep_scale(seed: int, rate: float, plane, rows, cols) -> torch.Tensor:
    """1 / (1 - rate) where the element is kept, else 0."""
    keep = 1.0 - rate
    return torch.where(uniform(seed, plane, rows, cols) < keep, 1.0 / keep, 0.0)
