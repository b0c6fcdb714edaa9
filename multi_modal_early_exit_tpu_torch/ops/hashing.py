"""Counter-based position hashing for dropout masks.

The counterpart of the JAX package's ``ops/hashing.py``. A uniform [0, 1)
value is a pure function of (seed, plane, row, column) through the lowbias32
integer hash, so the mask needs no stored state: the attention kernels
regenerate it in the forward and the backward, and ``hash_dropout`` keeps
only its seed for the backward. The values are the JAX package's bit for bit.

PyTorch has no unsigned 32-bit arithmetic on every device, so the hash runs
in int64 with every result masked to its low 32 bits; a 32 x 32-bit product
is split into two 32 x 16-bit halves so that no intermediate leaves int64.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """(x * k) mod 2**32 for x in [0, 2**32) (int64) and a 32-bit constant."""
    lo = x * (k & 0xFFFF)
    hi = ((x * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def lowbias32(x: torch.Tensor) -> torch.Tensor:
    """Well-mixed 32-bit integer hash (lowbias32, public domain constants);
    takes and returns int64 tensors holding uint32 values."""
    x = x.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def dropout_uniform(seed, bh, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """f32 uniform [0, 1) as a pure function of (seed, plane index bh, i, j),
    broadcast over the shapes of ``bh``, ``rows`` and ``cols``: the top 24
    bits of the hash times 2**-24, exact in f32."""
    device = rows.device
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device) & MASK32
    bh = torch.as_tensor(bh, dtype=torch.int64, device=device) & MASK32
    state = lowbias32(seed ^ _mul32(bh, 0x9E3779B1))
    r = _mul32(rows.to(torch.int64) & MASK32, 0x85EBCA77)
    c = _mul32(cols.to(torch.int64) & MASK32, 0x27D4EB2F)
    bits = lowbias32((state + r + c) & MASK32)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _dropout_u(seed: int, shape, device) -> torch.Tensor:
    """Uniforms of a tensor of ``shape``: leading dims flattened into rows,
    the last dim the columns, plane 0."""
    n = 1
    for s in shape:
        n *= s
    last = shape[-1] if shape else 1
    rows = torch.arange(n // last, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(last, dtype=torch.int64, device=device)[None, :]
    return dropout_uniform(seed, 0, rows, cols).reshape(shape)


def _apply_mask(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    keep = 1.0 - rate
    u = _dropout_u(seed, x.shape, x.device)
    # x / keep in x's dtype, as jnp divides by a weakly typed scalar
    scaled = x / torch.tensor(keep, dtype=x.dtype, device=x.device)
    return torch.where(u < keep, scaled, torch.zeros((), dtype=x.dtype, device=x.device))


class _HashDropout(torch.autograd.Function):
    """Dropout whose backward regenerates the mask from the seed instead of
    storing it."""

    @staticmethod
    def forward(ctx, x, seed: int, rate: float):
        ctx.seed, ctx.rate = seed, rate
        return _apply_mask(x, seed, rate)

    @staticmethod
    def backward(ctx, g):
        return _apply_mask(g, ctx.seed, ctx.rate), None, None


def hash_dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Dropout with the position-hash mask of the int32 ``seed``: keep an
    element iff its uniform is below 1 - rate, and scale it by 1/(1 - rate)."""
    return _HashDropout.apply(x, int(seed), float(rate))
