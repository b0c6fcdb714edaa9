"""The relative-position attention bias: ``materialize_bias``.

Builds the (B, H, P, P) additive bias of LayoutLMv3 attention, P >= S:

    bias[b, h, i, j] = (T1[bkt(pos_j - pos_i), h] + Tx[bkt2d(x0_j - x0_i), h])
                       + Ty[bkt2d(y1_j - y1_i), h]
                       + (-1e30 where key j is masked or j >= S)

with T5 bidirectional log buckets and tables pre-scaled by the caller. On a
CUDA tensor ``materialize_bias`` launches the hand-written kernel
``csrc/materialize_bias.cu``; on a CPU tensor it runs
``materialize_bias_plain``, the same gathers and f32 sums in the same order
in plain PyTorch. The two are bit-equal on the card.

The bucket of a relative distance depends only on its sign and on
min(|rel|, max_distance), so ``bucket_lut`` evaluates the f32 log formula
once per (num_buckets, max_distance) for n = 0..max_distance and both
versions index that table: no ``log`` is evaluated per element, and the
kernel and the plain version cannot disagree at the power-of-two distances
where the formula lands exactly on an integer.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from multi_modal_early_exit_tpu_torch.ops import cuda_build

NEG_INF = -1e30
LANE = 128  # the bias width P is S rounded up to a multiple of LANE


@functools.lru_cache(maxsize=None)
def _bucket_lut_cpu(num_buckets: int, max_distance: int) -> torch.Tensor:
    half = num_buckets // 2
    max_exact = half // 2
    n = torch.arange(max_distance + 1, dtype=torch.int32)
    n_safe = torch.clamp(n, min=1).to(torch.float32)  # log(0) is masked below
    val_if_large = max_exact + (
        torch.log(n_safe / max_exact)
        / math.log(max_distance / max_exact)
        * (half - max_exact)
    ).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=half - 1)
    return torch.where(n < max_exact, n, val_if_large).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _bucket_lut_on(num_buckets: int, max_distance: int, device: str) -> torch.Tensor:
    return _bucket_lut_cpu(num_buckets, max_distance).to(device)


def bucket_lut(num_buckets: int, max_distance: int, device) -> torch.Tensor:
    """int32 (max_distance + 1,): the one-sided bucket of |rel| = n."""
    return _bucket_lut_on(num_buckets, max_distance, str(torch.device(device)))


def relative_position_bucket(
    relative_position: torch.Tensor, num_buckets: int, max_distance: int
) -> torch.Tensor:
    """Bidirectional T5-style log bucketing by table lookup (int64)."""
    lut = bucket_lut(num_buckets, max_distance, relative_position.device)
    half = num_buckets // 2
    n = relative_position.abs().clamp(max=max_distance).long()
    return (relative_position > 0).long() * half + lut[n].long()


def padded_width(s: int) -> int:
    return -(-s // LANE) * LANE


def materialize_bias_plain(
    position_ids: torch.Tensor,  # (B, S) int
    cx: torch.Tensor,
    cy: torch.Tensor,
    attention_mask: torch.Tensor,
    t1: torch.Tensor,  # (rel_bins, H) f32, scale pre-folded
    tx: torch.Tensor,  # (rel2d_bins, H)
    ty: torch.Tensor,
    rel_bins: int = 32,
    max_rel: int = 128,
    rel2d_bins: int = 64,
    max_rel2d: int = 256,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch ``materialize_bias``: the kernel's arithmetic, dense."""
    s = position_ids.shape[1]
    p = padded_width(s)
    # pad positions read as 0 (finite pad rows); pad keys carry mask 0
    pos, x0, y1, mask = (
        F.pad(v.to(torch.int32), (0, p - s))
        for v in (position_ids, cx, cy, attention_mask)
    )

    def buckets(v, num_buckets, max_distance):
        return relative_position_bucket(
            v[:, None, :] - v[:, :, None], num_buckets, max_distance
        )

    b1 = buckets(pos, rel_bins, max_rel)       # (B, P, P), [b, i, j]
    bx = buckets(x0, rel2d_bins, max_rel2d)
    by = buckets(y1, rel2d_bins, max_rel2d)
    v = (t1.float()[b1] + tx.float()[bx]) + ty.float()[by]  # (B, P, P, H)
    neg = torch.where(mask != 0, 0.0, NEG_INF).to(torch.float32)
    v = v + neg[:, None, :, None]
    return v.permute(0, 3, 1, 2).to(out_dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _materialize_bias_fn():
    lib = cuda_build.load("materialize_bias")
    fn = lib.mmee_materialize_bias
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def materialize_bias(
    position_ids: torch.Tensor,
    cx: torch.Tensor,
    cy: torch.Tensor,
    attention_mask: torch.Tensor,
    t1: torch.Tensor,
    tx: torch.Tensor,
    ty: torch.Tensor,
    rel_bins: int = 32,
    max_rel: int = 128,
    rel2d_bins: int = 64,
    max_rel2d: int = 256,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(B, H, P, P) bias, P = ceil(S / 128) * 128.

    The vectors are (B, S) int32, the tables f32 with the attention scale
    folded in. CPU tensors run ``materialize_bias_plain``; CUDA tensors
    launch the kernel (counted in ``materialize_bias.launches``).
    """
    args = (position_ids, cx, cy, attention_mask, t1, tx, ty)
    b, s = position_ids.shape
    h = t1.shape[1]
    if any(a.shape != (b, s) for a in args[:4]):
        raise ValueError("position_ids, cx, cy and attention_mask must share (B, S)")
    if t1.shape != (rel_bins, h) or tx.shape != (rel2d_bins, h) or ty.shape != (rel2d_bins, h):
        raise ValueError(
            f"tables must be ({rel_bins}, H) and ({rel2d_bins}, H); got "
            f"{tuple(t1.shape)}, {tuple(tx.shape)}, {tuple(ty.shape)}"
        )
    device = position_ids.device
    if device.type == "cpu":
        return materialize_bias_plain(
            *args, rel_bins=rel_bins, max_rel=max_rel, rel2d_bins=rel2d_bins,
            max_rel2d=max_rel2d, out_dtype=out_dtype,
        )
    if device.type != "cuda":
        raise ValueError(f"materialize_bias runs on cuda or cpu, not {device}")
    for a in args:
        if a.device != device or not a.is_contiguous():
            raise ValueError("materialize_bias takes contiguous tensors on one device")
    if any(a.dtype != torch.int32 for a in args[:4]):
        raise TypeError("position_ids, cx, cy and attention_mask must be int32")
    if any(a.dtype != torch.float32 for a in args[4:]):
        raise TypeError("the bias tables must be float32")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"materialize_bias writes bfloat16 or float32, not {out_dtype}")
    p = padded_width(s)
    lut1 = bucket_lut(rel_bins, max_rel, device)
    lut2 = bucket_lut(rel2d_bins, max_rel2d, device)
    out = torch.empty((b, h, p, p), dtype=out_dtype, device=device)
    lib, fn = _materialize_bias_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(
            *(a.data_ptr() for a in args), lut1.data_ptr(), lut2.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.bfloat16), b, s, p, h,
            rel_bins, rel2d_bins, max_rel, max_rel2d, stream,
        )
    cuda_build.check(lib, code, "materialize_bias")
    materialize_bias.launches += 1
    return out


materialize_bias.launches = 0
