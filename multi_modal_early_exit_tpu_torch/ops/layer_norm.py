"""The residual add and LayerNorm of the no-grad path: ``add_layer_norm``.

``add_layer_norm(x, weight, bias, eps, residual)`` is LayerNorm(x +
residual) over the last dimension with f32 moments, output in x's dtype.
On CUDA tensors it launches the hand-written kernel
``csrc/add_layer_norm.cu`` (one read of x and the residual, one write);
``add_layer_norm_plain`` is the same function composed of torch ops: the
residual add in x's dtype, then two-pass f32 moments, as the JAX package's
primal computes them. ``models/layoutlmv3/modeling.py::layer_norm`` runs
the kernel on every CUDA tensor outside autograd (``dense`` copies a
strided or misaligned one first, and ``add_layer_norm`` raises on one the
kernel does not build), and the plain version on the CPU and under
autograd.

The kernel takes x, residual, weight and bias all bf16 or all f32; x and
residual contiguous, 16-byte aligned, of a width in ``WIDTHS`` (every
hidden size of the repository's configurations); weight and bias (width,).
Its sums run in another order than PyTorch's reductions, so it matches the
plain version to an ulp of the output type, not bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from multi_modal_early_exit_tpu_torch.ops import cuda_build
from multi_modal_early_exit_tpu_torch.utils.profiling import count

WIDTHS = frozenset((64, 128, 256, 384, 512, 768, 1024))
_TYPES = (torch.bfloat16, torch.float32)


def add_layer_norm_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """LayerNorm(x + residual) composed of torch ops: the add in x's dtype,
    two-pass f32 moments, output in x's dtype."""
    if residual is not None:
        x = x + residual
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def _refusal(x, weight, bias, residual) -> Optional[str]:
    """Why the kernel does not take these inputs, or None if it does."""
    if x.dtype not in _TYPES:
        return f"x is {x.dtype}; the kernel takes bfloat16 or float32"
    width = x.shape[-1]
    if width not in WIDTHS:
        return f"width {width} is none of {sorted(WIDTHS)}"
    if not x.is_contiguous() or x.data_ptr() % 16:
        return "x must be contiguous and 16-byte aligned"
    if residual is not None:
        if residual.shape != x.shape or residual.dtype != x.dtype:
            return "the residual must have x's shape and dtype"
        if not residual.is_contiguous() or residual.data_ptr() % 16:
            return "the residual must be contiguous and 16-byte aligned"
        if residual.device != x.device:
            return "the residual must be on x's device"
    for name, p in (("weight", weight), ("bias", bias)):
        if p.shape != (width,) or p.dtype != x.dtype:
            return f"{name} must be ({width},) and of x's dtype, {x.dtype}"
        if not p.is_contiguous() or p.device != x.device:
            return f"{name} must be contiguous and on x's device"
    if x.device.type != "cuda":
        return f"the kernel runs on cuda, not {x.device}"
    return None


def on_card(x: torch.Tensor) -> bool:
    """Whether the no-grad path runs the kernel on x: on every CUDA tensor."""
    return x.is_cuda


def dense(t: torch.Tensor) -> torch.Tensor:
    """t, or a contiguous copy in a fresh allocation where t is strided or
    not 16-byte aligned (the kernel reads rows as 16-byte vectors)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


@functools.lru_cache(maxsize=None)
def _add_layer_norm_fn():
    lib = cuda_build.load("add_layer_norm")
    fn = lib.mmee_add_layer_norm
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def add_layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """LayerNorm(x + residual) by the kernel (counted in
    ``launches.add_layer_norm``); raises on inputs it does not take."""
    why = _refusal(x, weight, bias, residual)
    if why is not None:
        raise ValueError(f"add_layer_norm: {why}")
    out = torch.empty_like(x)
    lib, fn = _add_layer_norm_fn()
    width = x.shape[-1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), None if residual is None else residual.data_ptr(),
                  weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                  int(x.dtype == torch.bfloat16), x.numel() // width, width, eps, stream)
    cuda_build.check(lib, code, "add_layer_norm")
    count("launches.add_layer_norm")
    return out

