"""The expert layer's work on either side of its down product:
``swiglu_weigh`` and ``combine_pairs``.

``swiglu_weigh(gate_up, weights, order)`` is SwiGLU's activation of a gate-up
product (P, 2 F), gate columns first: silu(gate) * up, times each row's
routing weight ``weights.reshape(-1)[order[i]]`` when weights are given (the
routed experts, their pairs sorted by expert), in f32, rounded once to
gate_up's dtype. Given ``order`` it also returns the inverse permutation
``inv`` (int32, ``inv[order[i]] = i``). ``combine_pairs(pairs, inv, k)``
puts the down product's rows (P, H) back in pair order and sums each
token's k rows in f32, in order, into (P / k, H) of the pairs' dtype.
An expert layer that holds a share of the experts sorts its own experts'
pairs first and passes ``held``, their count as one int32 on the rows'
device: ``swiglu_weigh`` leaves the act rows from ``held`` on unwritten
(zeros in the plain version) and ``combine_pairs`` counts a pair whose
sorted row is ``held`` or later as zero. Without ``held`` every row counts.

On CUDA tensors both launch the hand-written kernels of
``csrc/moe_pairs.cu`` (one read and one write of each row), each counted in
``launches.<kernel>``; what they do not take raises. ``swiglu_weigh_plain``
and ``combine_pairs_plain`` are the same functions composed of torch ops as
the expert layer composed them before the kernels: SiLU, then the products,
each rounded to the operands' type, the weight cast to that type first; an
``index_copy_`` by ``order``, the f32 sum and a cast.
``models/moonlight/modeling.py`` runs the kernels on every CUDA tensor
outside autograd, and the plain versions on the CPU and under autograd.

The kernels take bf16 rows (the configuration's serving type; the grouped
products take bf16 alone), contiguous and 16-byte aligned, of a width that
is a multiple of 8; weights f32 and order int64, (P,) each, and at most
``MAX_K`` pairs a token.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from multi_modal_early_exit_tpu_torch.ops import cuda_build
from multi_modal_early_exit_tpu_torch.utils.profiling import count

MAX_K = 8
_INDEX_LIMIT = 2 ** 31  # the kernels' 32-bit index of 16-byte vectors (8 elements)


def _from_held(rows: int, held: torch.Tensor) -> torch.Tensor:
    """(rows, 1) bool: the sorted rows at or past ``held``."""
    return (torch.arange(rows, device=held.device) >= held)[:, None]


def swiglu_weigh_plain(gate_up: torch.Tensor, weights: Optional[torch.Tensor] = None,
                       order: Optional[torch.Tensor] = None,
                       held: Optional[torch.Tensor] = None) -> torch.Tensor:
    """silu(gate) * up (* the weights of the pairs ``order`` names, cast to
    gate_up's dtype), composed of torch ops; rows from ``held`` on zero."""
    gate, up = gate_up.chunk(2, dim=-1)
    if weights is None:
        return F.silu(gate) * up
    act = F.silu(gate).mul_(up).mul_(weights.reshape(-1)[order, None].to(gate_up.dtype))
    return act if held is None else act.masked_fill_(_from_held(act.shape[0], held), 0)


def combine_pairs_plain(pairs: torch.Tensor, order: torch.Tensor, k: int,
                        held: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rows ``pairs`` (P, H) back in pair order (row i is pair
    ``order[i]``), each token's k summed in f32, cast to their dtype; rows
    from ``held`` on count as zero."""
    if held is not None:
        pairs = pairs.masked_fill(_from_held(pairs.shape[0], held), 0)
    out = torch.empty_like(pairs).index_copy_(0, order, pairs)
    return out.view(-1, k, pairs.shape[-1]).sum(dim=1, dtype=torch.float32).to(pairs.dtype)


def on_card(x: torch.Tensor) -> bool:
    """Whether the no-grad path runs the kernels on x: on every CUDA tensor."""
    return x.is_cuda


def _rows_refusal(name: str, t: torch.Tensor, multiple: int) -> Optional[str]:
    """Why the kernels do not take ``t`` as rows of a width that is a
    multiple of ``multiple``, or None if they do."""
    if t.dtype != torch.bfloat16:
        return f"{name} is {t.dtype}; the kernels take bfloat16"
    if t.dim() != 2 or t.shape[1] % multiple:
        return (f"{name} must be 2-D of a width that is a multiple of {multiple}, "
                f"got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        return f"{name} must be contiguous and 16-byte aligned"
    if t.numel() // 8 >= _INDEX_LIMIT:
        return f"{name} has {t.numel()} elements, too many for the kernels' 32-bit index"
    return None


def _vector_refusal(name: str, t: torch.Tensor, dtype, n: int, device) -> Optional[str]:
    if t.dtype != dtype or t.numel() != n:
        return f"{name} must be {dtype} with {n} elements, got {t.dtype} {tuple(t.shape)}"
    if not t.is_contiguous() or t.device != device:
        return f"{name} must be contiguous and on the rows' device"
    return None


def _on_cuda_refusal(t: torch.Tensor) -> Optional[str]:
    return None if t.device.type == "cuda" else f"the kernels run on cuda, not {t.device}"


def _held_refusal(held, device) -> Optional[str]:
    return None if held is None else _vector_refusal("held", held, torch.int32, 1, device)


def _swiglu_refusal(gate_up, weights, order, held) -> Optional[str]:
    why = _rows_refusal("gate_up", gate_up, 16)  # gate and up, each a multiple of 8
    if why is None and (weights is None) != (order is None):
        why = "weights and order are given together or not at all"
    if why is None and held is not None and weights is None:
        why = "held is given with the routed pairs' weights and order"
    if why is None and weights is not None:
        n = gate_up.shape[0]
        why = (_vector_refusal("weights", weights, torch.float32, n, gate_up.device)
               or _vector_refusal("order", order, torch.int64, n, gate_up.device))
    return why or _held_refusal(held, gate_up.device) or _on_cuda_refusal(gate_up)


def _combine_refusal(pairs, inv, k, held) -> Optional[str]:
    why = _rows_refusal("pairs", pairs, 8)
    if why is None and not 1 <= k <= MAX_K:
        why = f"k is {k}; the kernel sums 1 to {MAX_K} pairs a token"
    if why is None and pairs.shape[0] % k:
        why = f"{pairs.shape[0]} pairs are not whole tokens of {k}"
    why = why or _vector_refusal("inv", inv, torch.int32, pairs.shape[0], pairs.device)
    return why or _held_refusal(held, pairs.device) or _on_cuda_refusal(pairs)


@functools.lru_cache(maxsize=None)
def _swiglu_weigh_fn():
    lib = cuda_build.load("moe_pairs")
    fn = lib.mmee_swiglu_weigh
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _combine_pairs_fn():
    lib = cuda_build.load("moe_pairs")
    fn = lib.mmee_combine_pairs
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def swiglu_weigh(gate_up: torch.Tensor, weights: Optional[torch.Tensor] = None,
                 order: Optional[torch.Tensor] = None, held: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(act (P, F), inv (P,) int32 or None without ``order``) by the kernel
    (counted in ``launches.swiglu_weigh``); raises on inputs it does not
    take."""
    why = _swiglu_refusal(gate_up, weights, order, held)
    if why is not None:
        raise ValueError(f"swiglu_weigh: {why}")
    rows, width = gate_up.shape[0], gate_up.shape[1] // 2
    act = gate_up.new_empty((rows, width))
    inv = None if order is None else torch.empty(rows, dtype=torch.int32, device=gate_up.device)
    lib, fn = _swiglu_weigh_fn()
    with torch.cuda.device(gate_up.device):
        code = fn(gate_up.data_ptr(), None if weights is None else weights.data_ptr(),
                  None if order is None else order.data_ptr(), act.data_ptr(),
                  None if inv is None else inv.data_ptr(),
                  None if held is None else held.data_ptr(), rows, width, _stream(gate_up))
    cuda_build.check(lib, code, "swiglu_weigh")
    count("launches.swiglu_weigh")
    return act, inv


def combine_pairs(pairs: torch.Tensor, inv: torch.Tensor, k: int,
                  held: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(P / k, H): each token's k rows of ``pairs`` (P, H), found by ``inv``,
    summed in f32 by the kernel (counted in ``launches.combine_pairs``);
    raises on inputs it does not take."""
    why = _combine_refusal(pairs, inv, k, held)
    if why is not None:
        raise ValueError(f"combine_pairs: {why}")
    tokens, width = pairs.shape[0] // k, pairs.shape[1]
    out = pairs.new_empty((tokens, width))
    lib, fn = _combine_pairs_fn()
    with torch.cuda.device(pairs.device):
        code = fn(pairs.data_ptr(), inv.data_ptr(), None if held is None else held.data_ptr(),
                  out.data_ptr(), tokens, k, width, _stream(pairs))
    cuda_build.check(lib, code, "combine_pairs")
    count("launches.combine_pairs")
    return out
