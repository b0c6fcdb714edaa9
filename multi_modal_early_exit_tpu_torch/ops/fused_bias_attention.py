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

``materialize_bias`` is differentiable in the three tables. Its backward is
``table_grads``: dT[r, h] = the sum of the bias cotangent over the (b, i, j)
of the true S x S block whose bucket is r, for each table. On a CUDA tensor
it launches ``csrc/table_grads.cu`` (one-hot products on the tensor cores,
the TPU kernel's formulation, and a fixed-order sum of the CTAs' partial
sums: the same bits on every run); on a CPU tensor it runs ``table_grads_plain``
(``index_add_`` over the bucket maps, or with ``onehot=True`` the kernel's
arithmetic: one-hot matrix products, f32 g in three bf16 parts). Pad rows and
columns (>= S) carry no gradient: the bias's pad rows are finite, and must
not leak into the tables.

``fused_bias_attention`` is attention with this bias built inside the
kernel, so no (B, H, P, P) tensor exists: on CUDA tensors it launches the
forward kernel of ``csrc/flash_attention_packed_train.cu`` (the one behind
``flash_attention_packed``) with the bias built on chip in place of a bias
tile, at the kernels' head dim (``at_kernel_head_dim``). q/k/v are (B, H, S,
D) tensors of any layout with unit last stride, and the bias of each score
is the value ``materialize_bias`` would have written in the model dtype, so
the output is ``materialize_bias`` + ``flash_attention_packed``'s, bit for
bit on the card. Its plain version is ``materialize_bias_plain`` followed by
``flash_attention_packed_plain``. It has no backward, as in the JAX package.
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


def _check_vectors(what: str, vectors) -> None:
    b, s = vectors[0].shape
    if any(a.shape != (b, s) for a in vectors):
        raise ValueError(f"{what}: the (B, S) vectors must share one shape")


def _check_cuda(what: str, tensors) -> torch.device:
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {device}")
    for a in tensors:
        if a.device != device or not a.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors on one device")
    return device


def _materialize_bias_forward(
    position_ids, cx, cy, attention_mask, t1, tx, ty,
    rel_bins, max_rel, rel2d_bins, max_rel2d, out_dtype,
) -> torch.Tensor:
    """The bias on the device of its inputs: the plain version on the CPU,
    the kernel on CUDA (counted in ``materialize_bias.launches``)."""
    args = (position_ids, cx, cy, attention_mask, t1, tx, ty)
    b, s = position_ids.shape
    h = t1.shape[1]
    if position_ids.device.type == "cpu":
        return materialize_bias_plain(
            *args, rel_bins=rel_bins, max_rel=max_rel, rel2d_bins=rel2d_bins,
            max_rel2d=max_rel2d, out_dtype=out_dtype,
        )
    device = _check_cuda("materialize_bias", args)
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


class _MaterializeBias(torch.autograd.Function):
    """The bias as a differentiable function of the tables; the backward
    keeps only the (B, S) vectors."""

    @staticmethod
    def forward(ctx, position_ids, cx, cy, attention_mask, t1, tx, ty,
                rel_bins, max_rel, rel2d_bins, max_rel2d, out_dtype):
        ctx.save_for_backward(position_ids, cx, cy)
        ctx.buckets = (rel_bins, max_rel, rel2d_bins, max_rel2d)
        return _materialize_bias_forward(
            position_ids, cx, cy, attention_mask, t1, tx, ty,
            rel_bins, max_rel, rel2d_bins, max_rel2d, out_dtype,
        )

    @staticmethod
    def backward(ctx, g):
        position_ids, cx, cy = ctx.saved_tensors
        dt1, dtx, dty = table_grads(position_ids, cx, cy, g.contiguous(), *ctx.buckets)
        return (None,) * 4 + (dt1, dtx, dty) + (None,) * 5


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
    """(B, H, P, P) bias, P = ceil(S / 128) * 128, differentiable in the
    tables (backward: ``table_grads``).

    The vectors are (B, S) int32, the tables f32 with the attention scale
    folded in. CPU tensors run ``materialize_bias_plain``; CUDA tensors
    launch the kernel (counted in ``materialize_bias.launches``).
    """
    h = t1.shape[1]
    _check_vectors("materialize_bias", (position_ids, cx, cy, attention_mask))
    if t1.shape != (rel_bins, h) or tx.shape != (rel2d_bins, h) or ty.shape != (rel2d_bins, h):
        raise ValueError(
            f"tables must be ({rel_bins}, H) and ({rel2d_bins}, H); got "
            f"{tuple(t1.shape)}, {tuple(tx.shape)}, {tuple(ty.shape)}"
        )
    return _MaterializeBias.apply(
        position_ids, cx, cy, attention_mask, t1, tx, ty,
        rel_bins, max_rel, rel2d_bins, max_rel2d, out_dtype,
    )


materialize_bias.launches = 0


def table_grads_plain(
    position_ids: torch.Tensor,  # (B, S) int
    cx: torch.Tensor,
    cy: torch.Tensor,
    g: torch.Tensor,             # (B, H, P, P) bias cotangent, P >= S
    rel_bins: int = 32,
    max_rel: int = 128,
    rel2d_bins: int = 64,
    max_rel2d: int = 256,
    onehot: bool = False,
):
    """Plain PyTorch ``table_grads``: ``index_add_`` of the true S x S block
    of ``g`` over the bucket maps. Returns (dT1, dTx, dTy), f32.

    ``onehot=True`` computes what the kernel computes, as the Pallas kernel
    and the CUDA kernel do: per table the product of the (bins, B*S*S)
    one-hot bucket matrix with g's (B*S*S, H) values, in f32; an f32 g as the
    sum of the products of its three bf16 parts (``split_bf16x3_plain``),
    lo first."""
    # imported here: ops.flash_attention imports this module
    from multi_modal_early_exit_tpu_torch.ops.flash_attention import split_bf16x3_plain

    s = position_ids.shape[1]
    h = g.shape[1]
    gt = g[:, :, :s, :s].to(torch.float32).permute(0, 2, 3, 1).reshape(-1, h)
    parts = (gt,)
    if onehot and g.dtype == torch.float32:
        parts = tuple(split_bf16x3_plain(gt).to(torch.float32).flip(0))  # lo, mid, hi

    def one(vec, num_buckets, max_distance):
        vec = vec.to(torch.int32)
        bkt = relative_position_bucket(
            vec[:, None, :] - vec[:, :, None], num_buckets, max_distance
        ).reshape(-1)  # [b, i, j], as gt's rows
        out = torch.zeros((num_buckets, h), dtype=torch.float32, device=g.device)
        if not onehot:
            return out.index_add_(0, bkt, gt)
        hot = F.one_hot(bkt, num_buckets).to(torch.float32).t()
        for part in parts:
            out = out + hot @ part
        return out

    return (one(position_ids, rel_bins, max_rel), one(cx, rel2d_bins, max_rel2d),
            one(cy, rel2d_bins, max_rel2d))


@functools.lru_cache(maxsize=None)
def _table_grads_fn():
    lib = cuda_build.load("table_grads")
    fn = lib.mmee_table_grads
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib, fn


TABLE_GRADS_MAX_HEADS = 16  # N of the kernel's products: 16 (b, h) planes
TABLE_GRADS_MAX_BINS = 64   # M of the kernel's products
# query rows per CTA of the kernel (csrc/table_grads.cu, TgCfg::kCtaRows): each
# CTA writes its table sums to a partials buffer of its own
TABLE_GRADS_CTA_ROWS = {torch.bfloat16: 32, torch.float32: 16}


def table_grads(
    position_ids: torch.Tensor,
    cx: torch.Tensor,
    cy: torch.Tensor,
    g: torch.Tensor,
    rel_bins: int = 32,
    max_rel: int = 128,
    rel2d_bins: int = 64,
    max_rel2d: int = 256,
):
    """(dT1 (rel_bins, H), dTx, dTy (rel2d_bins, H)) f32 from the bias
    cotangent ``g`` (B, H, P, P), P >= S; rows and columns >= S are left
    out. CPU tensors run ``table_grads_plain``; CUDA tensors launch the
    kernels (``table_grads.launches`` counts both: 2 per call), which take
    g contiguous and 16-byte aligned, H <= 16, P % 16 == 0 and at most 64
    bins a table: per-CTA sums, then their sum in a fixed order, so the
    result is the same bits on every run."""
    vecs = (position_ids, cx, cy)
    _check_vectors("table_grads", vecs)
    b, s = position_ids.shape
    if g.ndim != 4 or g.shape[0] != b or g.shape[2] != g.shape[3] or g.shape[3] < s:
        raise ValueError(f"g must be (B, H, P, P) with P >= {s}; got {tuple(g.shape)}")
    if g.device.type == "cpu":
        return table_grads_plain(*vecs, g, rel_bins, max_rel, rel2d_bins, max_rel2d)
    device = _check_cuda("table_grads", (*vecs, g))
    if any(a.dtype != torch.int32 for a in vecs):
        raise TypeError("position_ids, cx and cy must be int32")
    if g.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"table_grads takes a bfloat16 or float32 g, not {g.dtype}")
    h, p = g.shape[1], g.shape[3]
    if h > TABLE_GRADS_MAX_HEADS:
        raise ValueError(f"the table_grads kernel takes at most {TABLE_GRADS_MAX_HEADS} heads")
    if p % 16:
        raise ValueError(f"the table_grads kernel needs P % 16 == 0, got P = {p}")
    if max(rel_bins, rel2d_bins) > TABLE_GRADS_MAX_BINS:
        raise ValueError(f"the table_grads kernel takes at most {TABLE_GRADS_MAX_BINS} bins")
    if g.data_ptr() % 16:
        raise ValueError("the table_grads kernel reads g by TMA: it must be 16-byte aligned")
    lut1 = bucket_lut(rel_bins, max_rel, device)
    lut2 = bucket_lut(rel2d_bins, max_rel2d, device)
    n_out = (rel_bins + 2 * rel2d_bins) * h
    out = torch.empty(n_out, dtype=torch.float32, device=device)
    partial = torch.empty(-(-s // TABLE_GRADS_CTA_ROWS[g.dtype]) * b * n_out,
                          dtype=torch.float32, device=device)
    lib, fn = _table_grads_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(
            *(a.data_ptr() for a in vecs), lut1.data_ptr(), lut2.data_ptr(),
            g.data_ptr(), int(g.dtype == torch.bfloat16), partial.data_ptr(), partial.numel(),
            out.data_ptr(), b, s, p, h, rel_bins, rel2d_bins, max_rel, max_rel2d, stream,
        )
    cuda_build.check(lib, code, "table_grads")
    table_grads.launches += 2
    n1, n2 = rel_bins * h, rel2d_bins * h
    return (out[:n1].view(rel_bins, h), out[n1:n1 + n2].view(rel2d_bins, h),
            out[n1 + n2:].view(rel2d_bins, h))


table_grads.launches = 0


# ---------------------------------------------------------------------------
# attention with the bias built in the kernel
# ---------------------------------------------------------------------------


def fused_bias_attention_plain(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,
    v: torch.Tensor,
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
    scale=None,
) -> torch.Tensor:
    """Plain PyTorch ``fused_bias_attention``: ``materialize_bias_plain`` in
    q's dtype, then ``flash_attention_packed_plain`` on the packed layout,
    the scores scaled by ``scale`` (1/sqrt(D) when None). Returns (B, H, S,
    D) in q's dtype, a view of a (B, S, H, D) tensor."""
    # imported here: ops.flash_attention imports this module
    from multi_modal_early_exit_tpu_torch.ops.flash_attention import (
        _packed,
        flash_attention_packed_plain,
    )

    b, h, s, d = q.shape
    bias = materialize_bias_plain(
        position_ids, cx, cy, attention_mask, t1, tx, ty, rel_bins=rel_bins,
        max_rel=max_rel, rel2d_bins=rel2d_bins, max_rel2d=max_rel2d,
        out_dtype=q.dtype,
    )
    out = flash_attention_packed_plain(_packed(q), _packed(k), _packed(v), bias, h, scale=scale)
    return out.view(b, s, h, d).transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _fused_bias_attention_fn():
    lib = cuda_build.load("flash_attention_packed_train")
    fn = lib.mmee_fused_bias_attention
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
        + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib, fn


FUSED_MAX_DISTANCE = 1024  # the kernel's expanded tables hold 2 max + 1 distances


def _check_fused_cuda(q, k, v, vectors, tables, max_distances) -> int:
    """What the CUDA kernel takes: q/k/v all bf16 or all f32 at a kernel
    head dim, 64, 128 or a multiple of 64 above, which the kernel's wide
    mode computes in 64-column groups (``at_kernel_head_dim`` pads any
    other D), unit last stride and
    16-byte aligned rows; int32 vectors and f32 tables, contiguous, on q's
    card; bucket distances of 1 to 1024. Returns the operand flag (1 for
    bf16)."""
    what = "fused_bias_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {q.device}")
    if any(t.device != q.device for t in (k, v, *vectors, *tables)):
        raise ValueError(f"{what} takes tensors on one device")
    if not all(a.is_contiguous() for a in (*vectors, *tables)):
        raise ValueError(f"{what} takes contiguous vectors and tables")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the {what} kernel takes q, k, v all bfloat16 or all float32, not "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    # imported here: ops.flash_attention imports this module
    from multi_modal_early_exit_tpu_torch.ops.flash_attention import _check_head_dim

    _check_head_dim(q.shape[-1])
    if not all(1 <= m <= FUSED_MAX_DISTANCE for m in max_distances):
        raise ValueError(f"the {what} kernel takes bucket distances of 1 to "
                         f"{FUSED_MAX_DISTANCE}, not {max_distances}")
    for t in (q, k, v):
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"the {what} kernel takes q/k/v with unit last stride, the other "
                f"strides multiples of 8 and 16-byte aligned; got strides {t.stride()}"
            )
    if any(a.dtype != torch.int32 for a in vectors):
        raise TypeError("position_ids, cx, cy and attention_mask must be int32")
    if any(a.dtype != torch.float32 for a in tables):
        raise TypeError("the bias tables must be float32")
    return int(q.dtype == torch.bfloat16)


def fused_bias_attention(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,
    v: torch.Tensor,
    position_ids: torch.Tensor,  # (B, S) int32
    cx: torch.Tensor,            # (B, S) int32, bbox x0
    cy: torch.Tensor,            # (B, S) int32, bbox y1
    attention_mask: torch.Tensor,  # (B, S), 1 = real, 0 = pad
    t1: torch.Tensor,            # (rel_bins, H) f32, scale pre-folded
    tx: torch.Tensor,            # (rel2d_bins, H)
    ty: torch.Tensor,
    rel_bins: int = 32,
    max_rel: int = 128,
    rel2d_bins: int = 64,
    max_rel2d: int = 256,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + rel_bias + mask) v with the bias built in
    the kernel; (B, H, S, D) in q's dtype, in q's layout (a transposed view
    of the packed projections gives a transposed view back) when D is a
    kernel head dim (64, 128 or a multiple of 64 above).

    The bias of each score is rounded once to q's dtype, as
    ``materialize_bias`` rounds it. CPU tensors run
    ``fused_bias_attention_plain``; CUDA tensors launch the kernel (counted
    in ``fused_bias_attention.launches``) at the kernels' head dim
    (``at_kernel_head_dim``), f32 ones after splitting k and v by
    ``split_bf16x3`` (one launch, counted there). No backward.
    """
    # imported here: ops.flash_attention imports this module
    from multi_modal_early_exit_tpu_torch.ops.flash_attention import (
        _fwd_parts,
        _ptr,
        _strides,
        at_kernel_head_dim,
    )

    b, h, s, _ = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("fused_bias_attention: q, k and v must share one (B, H, S, D) shape")
    vectors = (position_ids, cx, cy, attention_mask)
    _check_vectors("fused_bias_attention", vectors)
    if position_ids.shape != (b, s):
        raise ValueError(f"the vectors must be ({b}, {s}); got {tuple(position_ids.shape)}")
    tables = (t1, tx, ty)
    if t1.shape != (rel_bins, h) or tx.shape != (rel2d_bins, h) or ty.shape != (rel2d_bins, h):
        raise ValueError(
            f"tables must be ({rel_bins}, {h}) and ({rel2d_bins}, {h}); got "
            f"{tuple(t1.shape)}, {tuple(tx.shape)}, {tuple(ty.shape)}"
        )
    bins = (rel_bins, max_rel, rel2d_bins, max_rel2d)

    def run(q, k, v, scale):
        if q.device.type == "cpu":
            return fused_bias_attention_plain(q, k, v, *vectors, *tables, *bins, scale=scale)
        is_bf16 = _check_fused_cuda(q, k, v, vectors, tables, (max_rel, max_rel2d))
        device = q.device
        out = torch.empty_like(q)  # keeps q's layout when q is dense
        parts = _fwd_parts(q, k, v)
        lut1 = bucket_lut(rel_bins, max_rel, device)
        lut2 = bucket_lut(rel2d_bins, max_rel2d, device)
        lib, fn = _fused_bias_attention_fn()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            code = fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), is_bf16, _ptr(parts), out.data_ptr(),
                _strides(q, k, v, out), *(a.data_ptr() for a in (*vectors, *tables)),
                lut1.data_ptr(), lut2.data_ptr(), b, s, h, q.shape[-1], rel_bins, rel2d_bins,
                max_rel, max_rel2d, scale, stream,
            )
        cuda_build.check(lib, code, "fused_bias_attention")
        fused_bias_attention.launches += 1
        return out

    return at_kernel_head_dim("fused_bias_attention", run, q, k, v)


fused_bias_attention.launches = 0
