"""Fused attention with an additive bias on the packed layout:
``flash_attention_packed``.

    out = softmax(q k^T * d^-1/2 + bias) v      per (batch, head)

q/k/v and the output are (B, S, H*D) — the projections' own layout, no head
transpose — and the bias is (B, H, P, P) with P >= S (pre-padded by the
bias kernel; keys j >= S do not exist). Deterministic: no dropout.

On a CUDA tensor ``flash_attention_packed`` launches the forward kernel of
``csrc/flash_attention_packed_train.cu`` without lse or dropout (q/k/v all
bf16 or all f32, head dim 64, bias bf16 or f32); on a CPU tensor it runs
``flash_attention_packed_plain``: dense f32 scores from the same inputs,
softmax, p cast to v's dtype, then p v.

Every CUDA kernel here takes its operands (q, k, v, o, do) all in bf16 or
all in f32, and multiplies in that type with f32 accumulation, as the TPU
kernels do: bf16 on the bf16 tensor cores, f32 by 3xTF32, good to about
f32's precision. Other dtypes, or mixed ones, raise ``TypeError``. Under
autograd it is an ``autograd.Function`` whose backward is the JAX package's
``_packed_bwd``: the head-form forward (``flash_attention_fwd``) recomputes
the lse, then the head-form backward (``flash_attention_bwd``) gives dq, dk,
dv and dbias; the packed tensors go to both as (B, H, S, D) views, no copy.

Head form: ``flash_attention`` takes (B, H, S, D) q/k/v of any strides with
a unit last one, and has dropout on the probabilities. Its forward
(``flash_attention_fwd``: out and the (B, H, P) f32 lse) and backward
(``flash_attention_bwd``: dq, dk, dv and dbias = ds at the bias's shape,
zero past S) run the training kernels' bodies of ``csrc/
flash_attention_packed_train.cu`` with explicit strides on CUDA tensors, and
their plain versions on CPU tensors.

Training: ``flash_attention_packed_train`` and its chained twin
``flash_attention_packed_train_chained`` are ``autograd.Function``s with
position-hash dropout on the probabilities (keep (i, j) of plane b*H + h iff
``dropout_uniform(seed, b*H + h, i, j) < 1 - rate``, scale by 1/(1 - rate)).
Their forward (``flash_attention_packed_train_fwd``: out and the (B, H, P)
f32 lse) and backward (``flash_attention_packed_train_bwd``: dq, dk, dv and
dbias = ds, or gbias + ds when chained) launch ``csrc/
flash_attention_packed_train.cu`` on CUDA tensors and run their plain
versions on CPU tensors. The chained op returns ``(out, bias)`` with the bias
passed through, so an encoder that hands each layer the previous layer's
bias output receives the running bias cotangent in every layer's backward
and adds its own ds to it there, in the kernel.

``flash_attention_packed_train_tables`` has the same forward, a detached
bias, and a backward (``flash_attention_packed_train_tables_bwd``) that
reduces ds straight into the gradients of the three relative-position
tables the bias was built from, so no (B, H, P, P) cotangent exists; on CUDA
tensors it launches the third backward of the same source, on CPU tensors
it runs ``table_grads_plain`` over the plain backward's f32 ds.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from multi_modal_early_exit_tpu_torch.ops import cuda_build
from multi_modal_early_exit_tpu_torch.ops.fused_bias_attention import (
    bucket_lut,
    table_grads_plain,
)
from multi_modal_early_exit_tpu_torch.ops.hashing import dropout_uniform

KERNEL_HEAD_DIM = 64
KERNEL_TILE = 64  # the training kernels tile the bias width P by 64


def _split(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, H*D) -> a (B, H, S, D) view, no copy."""
    b, s, hd = x.shape
    return x.reshape(b, s, num_heads, hd // num_heads).transpose(1, 2)


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, H*D) -> (B, H, S, D) f32."""
    return _split(x, num_heads).to(torch.float32)


def _packed(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, H*D)."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _check_packed(what: str, q, k, v, bias, num_heads: int) -> None:
    b, s, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q, k and v must share one (B, S, H*D) shape")
    if hd % num_heads:
        raise ValueError(f"{what}: width {hd} does not split into {num_heads} heads")
    if (bias.ndim != 4 or bias.shape[:2] != (b, num_heads)
            or bias.shape[2] != bias.shape[3] or bias.shape[3] < s):
        raise ValueError(
            f"{what}: bias must be (B, H, P, P) with P >= {s}; got {tuple(bias.shape)}"
        )


def _check_operand_dtype(what: str, tensors) -> int:
    """q/k/v (and o, do) all bf16 or all f32; returns the kernels' flag,
    1 for bf16."""
    dtype = tensors[0].dtype
    if dtype not in (torch.bfloat16, torch.float32) or any(t.dtype != dtype for t in tensors):
        raise TypeError(
            f"the {what} kernel takes q, k, v all bfloat16 or all float32, not "
            f"{sorted({str(t.dtype) for t in tensors})}"
        )
    return int(dtype == torch.bfloat16)


def _check_cuda_kernel_args(what: str, tensors, bias, num_heads: int) -> int:
    """What the CUDA attention kernels take: contiguous tensors on one card,
    16-byte aligned (the kernels load them by TMA; a misaligned one raises,
    there is no other body to fall back to), q/k/v (and o, do) all
    bf16 or all f32, a bf16 or f32 bias, head dim 64. Returns the operand
    flag (1 for bf16)."""
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {device}")
    for t in (*tensors, bias):
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors on one device")
        if t.data_ptr() % 16:
            raise ValueError(f"{what} takes tensors whose data is 16-byte aligned")
    is_bf16 = _check_operand_dtype(what, tensors)
    if bias.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"bias must be bfloat16 or float32, not {bias.dtype}")
    d = tensors[0].shape[-1] // num_heads
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {KERNEL_HEAD_DIM}, not {d}")
    return is_bf16


def flash_attention_packed_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """Plain PyTorch ``flash_attention_packed`` (dense (B, H, S, S) scores)."""
    s, d = q.shape[1], q.shape[2] // num_heads
    scores = torch.matmul(_heads(q, num_heads), _heads(k, num_heads).transpose(-1, -2))
    scores = scores * (1.0 / math.sqrt(d)) + bias[:, :, :s, :s].to(torch.float32)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(p.to(torch.float32), _heads(v, num_heads))
    return _packed(out).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _flash_attention_packed_fn():
    lib = cuda_build.load("flash_attention_packed_train")
    fn = lib.mmee_flash_attention_packed
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib, fn


def _flash_attention_packed_fwd(q, k, v, bias, num_heads: int) -> torch.Tensor:
    """The forward: the plain version on CPU tensors, the kernel on CUDA
    tensors."""
    b, s, hd = q.shape
    device = q.device
    if device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, bias, num_heads)
    is_bf16 = _check_cuda_kernel_args("flash_attention_packed", (q, k, v), bias, num_heads)
    kbias = _kernel_width(bias)
    out = torch.empty_like(q)
    lib, fn = _flash_attention_packed_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kbias.data_ptr(),
            int(kbias.dtype == torch.bfloat16), is_bf16, out.data_ptr(),
            b, s, num_heads, kbias.shape[-1], 1.0 / math.sqrt(hd // num_heads), stream,
        )
    cuda_build.check(lib, code, "flash_attention_packed")
    flash_attention_packed.launches += 1
    return out


class _PackedAttention(torch.autograd.Function):
    """``flash_attention_packed`` with the JAX package's ``_packed_bwd``:
    the head-form forward recomputes the lse, the head-form backward gives
    the gradients, both on (B, H, S, D) views of the packed tensors."""

    @staticmethod
    def forward(ctx, q, k, v, bias, num_heads):
        ctx.save_for_backward(q, k, v, bias)
        ctx.num_heads = num_heads
        return _flash_attention_packed_fwd(q, k, v, bias, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        h = ctx.num_heads
        qh, kh, vh = (_split(x, h) for x in (q, k, v))
        gh = _split(g.to(q.dtype).contiguous(), h)
        o, lse = flash_attention_fwd(qh, kh, vh, bias, 0, 0.0, with_lse=True)
        dq, dk, dv, dbias = flash_attention_bwd(qh, kh, vh, bias, 0, o, lse, gh, 0.0)
        return _packed(dq), _packed(dk), _packed(dv), dbias, None


def flash_attention_packed(
    q: torch.Tensor,     # (B, S, H*D)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # (B, H, P, P), P >= S, mask included
    num_heads: int,
) -> torch.Tensor:
    """Returns (B, S, H*D) in q's dtype. CPU tensors run the plain version;
    CUDA tensors launch the kernel (counted in
    ``flash_attention_packed.launches``). Differentiable in q, k, v and the
    bias (``_PackedAttention``); without autograd nothing is saved."""
    _check_packed("flash_attention_packed", q, k, v, bias, num_heads)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        return _PackedAttention.apply(q, k, v, bias, num_heads)
    return _flash_attention_packed_fwd(q, k, v, bias, num_heads)


flash_attention_packed.launches = 0


# ---------------------------------------------------------------------------
# training: forward with dropout + lse, backward, autograd
# ---------------------------------------------------------------------------


def attention_dropout_scale(
    seed: int, b: int, num_heads: int, s: int, rate: float, device
) -> torch.Tensor:
    """(B, H, S, S) f32 dropout factors of the attention probabilities:
    1/(1 - rate) where (seed, b*H + h, i, j) is kept, else 0."""
    bh = (torch.arange(b, device=device)[:, None] * num_heads
          + torch.arange(num_heads, device=device)[None, :])[:, :, None, None]
    idx = torch.arange(s, device=device)
    u = dropout_uniform(seed, bh, idx[None, None, :, None], idx[None, None, None, :])
    keep = 1.0 - rate
    return torch.where(u < keep, 1.0 / keep, 0.0).to(torch.float32)


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    seed: int = 0, rate: float = 0.0,
):
    """Plain PyTorch head-form forward on (B, H, S, D) q/k/v: (out (B, H,
    S, D) in q's dtype, lse (B, H, P) f32, +inf past S). Dense f32 scores,
    keys j >= S left out; dropout scales the normalised p, which is rounded
    to v's dtype before p v. The training forward's plain version on the
    heads of the packed projections."""
    b, h, s, d = q.shape
    scores = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    scores = scores * (1.0 / math.sqrt(d)) + bias[:, :, :s, :s].to(torch.float32)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    denom = e.sum(dim=-1, keepdim=True)
    p = e / denom
    if rate > 0.0:
        p = p * attention_dropout_scale(seed, b, h, s, rate, q.device)
    out = torch.matmul(p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    lse = torch.full((b, h, bias.shape[-1]), math.inf, dtype=torch.float32, device=q.device)
    lse[:, :, :s] = (m + torch.log(denom))[..., 0]
    return out.to(q.dtype), lse


def flash_attention_packed_train_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    seed: int, num_heads: int, rate: float = 0.0,
):
    """Plain PyTorch training forward: (out (B, S, H*D) in q's dtype,
    lse (B, H, P) f32, +inf past S). Dropout scales the normalised p."""
    out, lse = flash_attention_fwd_plain(
        *(_split(x, num_heads) for x in (q, k, v)), bias, seed, rate)
    return _packed(out), lse


def _attention_bwd_plain_ds(q, k, v, bias, seed, o, lse, do, rate):
    """The explicit backward formulas on (B, H, S, D) tensors: p from the
    lse, delta = rowsum(do o), ds = p (dp c - delta), dv from p c; ds is
    rounded to q's dtype before the dq/dk products, p c to do's before dv.
    Returns (dq, dk, dv in the inputs' dtypes, ds (B, H, S, S) f32)."""
    b, h, s, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh, oh, doh = (x.to(torch.float32) for x in (q, k, v, o, do))
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    scores = scores + bias[:, :, :s, :s].to(torch.float32)
    p = torch.exp(scores - lse[:, :, :s, None])
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    pd = p
    if rate > 0.0:
        c = attention_dropout_scale(seed, b, h, s, rate, q.device)
        pd, dp = p * c, dp * c
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    ds_c = ds.to(q.dtype).to(torch.float32)
    dq = torch.matmul(ds_c, kh) * scale
    dk = torch.matmul(ds_c.transpose(-1, -2), qh) * scale
    dv = torch.matmul(pd.to(do.dtype).to(torch.float32).transpose(-1, -2), doh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds


def _train_bwd_plain_ds(q, k, v, bias, seed, o, lse, do, num_heads, rate):
    """``_attention_bwd_plain_ds`` on the packed layout: (dq, dk, dv packed
    in the inputs' dtypes, ds (B, H, S, S) f32)."""
    dq, dk, dv, ds = _attention_bwd_plain_ds(
        *(_split(x, num_heads) for x in (q, k, v)), bias, seed,
        _split(o, num_heads), lse, _split(do, num_heads), rate)
    return _packed(dq), _packed(dk), _packed(dv), ds


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    seed: int, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    rate: float = 0.0,
):
    """Plain PyTorch head-form backward by the explicit formulas of
    ``_attention_bwd_plain_ds``: (dq, dk, dv (B, H, S, D) in the inputs'
    dtypes, dbias = ds at the bias's shape and dtype, zero past S)."""
    dq, dk, dv, ds = _attention_bwd_plain_ds(q, k, v, bias, seed, o, lse, do, rate)
    s = q.shape[2]
    dbias = torch.zeros(bias.shape, dtype=torch.float32, device=q.device)
    dbias[:, :, :s, :s] = ds
    return dq, dk, dv, dbias.to(bias.dtype)


def flash_attention_packed_train_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    seed: int, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    num_heads: int, rate: float = 0.0, gbias=None,
):
    """Plain PyTorch training backward by the explicit formulas: p from the
    lse, delta = rowsum(do o), ds = p (dp c - delta), dv from p c. Returns
    (dq, dk, dv, dbias); dbias is (B, H, P, P) in the bias dtype, gbias + ds
    when ``gbias`` is given, with ds zero past S."""
    dq, dk, dv, ds = _train_bwd_plain_ds(q, k, v, bias, seed, o, lse, do, num_heads, rate)
    s = q.shape[1]
    dbias = torch.zeros(bias.shape, dtype=torch.float32, device=q.device)
    dbias[:, :, :s, :s] = ds
    if gbias is not None:
        dbias = dbias + gbias.to(torch.float32)
    return dq, dk, dv, dbias.to(bias.dtype)


@functools.lru_cache(maxsize=None)
def _train_fns():
    lib = cuda_build.load("flash_attention_packed_train")
    fwd = lib.mmee_flash_attention_packed_train_fwd
    fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fwd.restype = ctypes.c_int
    bwd = lib.mmee_flash_attention_packed_train_bwd
    bwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    bwd.restype = ctypes.c_int
    return lib, fwd, bwd


def _dropout_args(seed: int, rate: float):
    """(int32 seed, keep, 1/keep, on) as the kernels take them."""
    seed32 = (int(seed) + 2 ** 31) % 2 ** 32 - 2 ** 31
    keep = 1.0 - rate
    return seed32, keep, 1.0 / keep, int(rate > 0.0)


def _check_lse(what: str, lse: torch.Tensor, shape) -> None:
    """The backward kernels copy 64-row runs of the lse in bulk: a
    contiguous, 16-byte aligned f32 tensor of ``shape``."""
    if (lse.shape != shape or lse.dtype != torch.float32 or not lse.is_contiguous()
            or lse.data_ptr() % 16):
        raise ValueError(f"{what}: lse must be a contiguous, 16-byte aligned f32 (B, H, P) tensor")


def _check_train_width(what: str, bias: torch.Tensor) -> None:
    if bias.shape[-1] % KERNEL_TILE:
        raise ValueError(
            f"the {what} kernel needs a bias width P that is a multiple of "
            f"{KERNEL_TILE}, got {bias.shape[-1]}"
        )


def flash_attention_packed_train_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    seed: int, num_heads: int, rate: float = 0.0,
):
    """Training forward: (out (B, S, H*D) in q's dtype, lse (B, H, P) f32,
    +inf past S). CPU tensors run the plain version; CUDA tensors launch the
    kernel (counted in ``flash_attention_packed_train_fwd.launches``)."""
    _check_packed("flash_attention_packed_train", q, k, v, bias, num_heads)
    if q.device.type == "cpu":
        return flash_attention_packed_train_fwd_plain(q, k, v, bias, seed, num_heads, rate)
    is_bf16 = _check_cuda_kernel_args("flash_attention_packed_train", (q, k, v), bias, num_heads)
    _check_train_width("flash_attention_packed_train", bias)
    b, s, hd = q.shape
    p = bias.shape[-1]
    out = torch.empty_like(q)
    lse = torch.empty((b, num_heads, p), dtype=torch.float32, device=q.device)
    lib, fwd, _ = _train_fns()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            int(bias.dtype == torch.bfloat16), is_bf16, out.data_ptr(), lse.data_ptr(),
            b, s, num_heads, p, 1.0 / math.sqrt(hd // num_heads),
            *_dropout_args(seed, rate), stream,
        )
    cuda_build.check(lib, code, "flash_attention_packed_train")
    flash_attention_packed_train_fwd.launches += 1
    return out, lse


flash_attention_packed_train_fwd.launches = 0


def flash_attention_packed_train_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    seed: int, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    num_heads: int, rate: float = 0.0, gbias=None,
):
    """Training backward: (dq, dk, dv in q's dtype, dbias (B, H, P, P) in the
    bias dtype, gbias + ds when ``gbias`` is given). CPU tensors run the
    plain version; CUDA tensors launch the kernel pair, one kernel for dq and
    dbias and one for dk and dv (``flash_attention_packed_train_bwd.launches``
    counts both: 2 per call)."""
    _check_packed("flash_attention_packed_train_bwd", q, k, v, bias, num_heads)
    if gbias is not None and gbias.shape != bias.shape:
        raise ValueError(f"gbias must have the bias shape {tuple(bias.shape)}")
    if q.device.type == "cpu":
        return flash_attention_packed_train_bwd_plain(
            q, k, v, bias, seed, o, lse, do, num_heads, rate, gbias
        )
    what = "flash_attention_packed_train_bwd"
    is_bf16 = _check_cuda_kernel_args(what, (q, k, v, o, do), bias, num_heads)
    _check_train_width(what, bias)
    b, s, hd = q.shape
    p = bias.shape[-1]
    _check_lse(what, lse, (b, num_heads, p))
    if gbias is not None and (gbias.dtype != bias.dtype or not gbias.is_contiguous()
                              or gbias.device != q.device or gbias.data_ptr() % 16):
        raise ValueError(f"{what}: gbias must be contiguous, 16-byte aligned, on q's device, "
                         f"in the bias dtype")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.empty_like(bias)
    delta = torch.empty((b, num_heads, p), dtype=torch.float32, device=q.device)
    lib, _, bwd = _train_fns()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            int(bias.dtype == torch.bfloat16), is_bf16, do.data_ptr(), o.data_ptr(),
            lse.data_ptr(), 0 if gbias is None else gbias.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(),
            delta.data_ptr(), b, s, num_heads, p, 1.0 / math.sqrt(hd // num_heads),
            *_dropout_args(seed, rate), stream,
        )
    cuda_build.check(lib, code, what)
    flash_attention_packed_train_bwd.launches += 2
    return dq, dk, dv, dbias


flash_attention_packed_train_bwd.launches = 0


def _grad_like(g, like: torch.Tensor) -> torch.Tensor:
    if g is None:
        return torch.zeros_like(like)
    return g.to(like.dtype).contiguous()


class _PackedTrainChained(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, seed, num_heads, rate):
        ctx.set_materialize_grads(False)
        out, lse = flash_attention_packed_train_fwd(q, k, v, bias, seed, num_heads, rate)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.args = (seed, num_heads, rate)
        return out, bias.view_as(bias)

    @staticmethod
    def backward(ctx, g_out, g_bias):
        q, k, v, bias, out, lse = ctx.saved_tensors
        seed, num_heads, rate = ctx.args
        gbias = None if g_bias is None else _grad_like(g_bias, bias)
        dq, dk, dv, dbias = flash_attention_packed_train_bwd(
            q, k, v, bias, seed, out, lse, _grad_like(g_out, out), num_heads,
            rate, gbias=gbias,
        )
        return dq, dk, dv, dbias, None, None, None


def flash_attention_packed_train(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    seed: int, num_heads: int, rate: float = 0.0,
) -> torch.Tensor:
    """Differentiable packed attention with position-hash dropout on the
    probabilities; (B, S, H*D) in q's dtype. Its backward gives dq, dk, dv
    and dbias (the chained op with its bias output unused: no incoming bias
    gradient, so dbias = ds)."""
    return flash_attention_packed_train_chained(q, k, v, bias, seed, num_heads, rate)[0]


def flash_attention_packed_train_chained(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    seed: int, num_heads: int, rate: float = 0.0,
):
    """``flash_attention_packed_train`` that also returns the bias, passed
    through: (out, bias). The bias output's incoming gradient (the running
    cotangent of the layers after this one; none at the last layer) is added
    to this layer's ds by the backward kernel."""
    if bias.shape[-2] != bias.shape[-1]:
        raise ValueError(f"the chained op needs a square bias, got {tuple(bias.shape)}")
    return _PackedTrainChained.apply(q, k, v, bias, int(seed), num_heads, float(rate))


# ---------------------------------------------------------------------------
# head form: (B, H, S, D) q/k/v of any strides
# ---------------------------------------------------------------------------


def _check_headform(what: str, q, k, v, bias) -> None:
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q, k and v must share one (B, H, S, D) shape")
    b, h, s, _ = q.shape
    if (bias.ndim != 4 or bias.shape[:2] != (b, h)
            or bias.shape[2] != bias.shape[3] or bias.shape[3] < s):
        raise ValueError(
            f"{what}: bias must be (B, H, P, P) with P >= {s}; got {tuple(bias.shape)}"
        )


def _check_headform_cuda(what: str, tensors, bias) -> int:
    """What the kernels take in the head form: (B, H, rows, 64) tensors
    on one card, all bf16 or all f32, each with a unit last stride, its
    other strides multiples of 8 and 16-byte aligned (the packed
    projections' transposed view is such a tensor; the forward's TMA tensor
    maps need all three), and a contiguous, 16-byte aligned bf16 or f32
    bias. Returns the operand flag (1 for bf16)."""
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {device}")
    if any(t.device != device for t in (*tensors, bias)):
        raise ValueError(f"{what} takes tensors on one device")
    is_bf16 = _check_operand_dtype(what, tensors)
    if tensors[0].shape[-1] != KERNEL_HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {KERNEL_HEAD_DIM}, not {tensors[0].shape[-1]}")
    for t in tensors:
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"the {what} kernel takes tensors with unit last stride, the other "
                f"strides multiples of 8 and 16-byte aligned; got strides {t.stride()}"
            )
    if not bias.is_contiguous() or bias.data_ptr() % 16:
        raise ValueError(f"{what} takes a contiguous, 16-byte aligned bias")
    if bias.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"bias must be bfloat16 or float32, not {bias.dtype}")
    return is_bf16


def _strides(*tensors) -> ctypes.Array:
    """The (batch, head, row) element strides of each tensor, in order, as
    the kernels' int64 array."""
    vals = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _kernel_width(bias: torch.Tensor) -> torch.Tensor:
    """The bias at a width the kernels tile (a multiple of 64): itself, or
    a copy padded with zeros, which no key reads (keys j >= S do not
    exist)."""
    pad = (-bias.shape[-1]) % KERNEL_TILE
    return F.pad(bias, (0, pad, 0, pad)) if pad else bias


@functools.lru_cache(maxsize=None)
def _headform_fns():
    lib = cuda_build.load("flash_attention_packed_train")
    fwd = lib.mmee_flash_attention_fwd
    fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p]
    )
    fwd.restype = ctypes.c_int
    bwd = lib.mmee_flash_attention_bwd
    bwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
        + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p]
    )
    bwd.restype = ctypes.c_int
    return lib, fwd, bwd


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    seed: int = 0, rate: float = 0.0, with_lse: bool = False,
):
    """Head-form forward: out (B, H, S, D) in q's dtype and q's layout, and
    with ``with_lse`` also the lse (B, H, P) f32, +inf past S. CPU tensors
    run the plain version; CUDA tensors launch the kernel (counted in
    ``flash_attention_fwd.launches``)."""
    _check_headform("flash_attention_fwd", q, k, v, bias)
    if q.device.type == "cpu":
        out, lse = flash_attention_fwd_plain(q, k, v, bias, seed, rate)
        return (out, lse) if with_lse else out
    is_bf16 = _check_headform_cuda("flash_attention_fwd", (q, k, v), bias)
    b, h, s, d = q.shape
    p = bias.shape[-1]
    kbias = _kernel_width(bias)
    out = torch.empty_like(q)  # keeps q's layout when q is dense
    lse = torch.empty((b, h, kbias.shape[-1]), dtype=torch.float32, device=q.device)
    lib, fwd, _ = _headform_fns()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kbias.data_ptr(),
            int(kbias.dtype == torch.bfloat16), is_bf16, out.data_ptr(), lse.data_ptr(),
            _strides(q, k, v, out), b, s, h, kbias.shape[-1], 1.0 / math.sqrt(d),
            *_dropout_args(seed, rate), stream,
        )
    cuda_build.check(lib, code, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return (out, lse[:, :, :p]) if with_lse else out


flash_attention_fwd.launches = 0


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    seed: int, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    rate: float = 0.0,
):
    """Head-form backward from the forward's lse: (dq, dk, dv (B, H, S, D)
    in the inputs' dtypes and layouts, dbias = ds at the bias's shape and
    dtype, exactly zero past S). delta = rowsum(do o) is computed in the
    kernel. CPU tensors run the plain version; CUDA tensors launch the
    kernel pair, one kernel for dq and dbias and one for dk and dv
    (``flash_attention_bwd.launches`` counts both: 2 per call); o and do
    must meet q's layout rules too (the bf16 kernels load do by TMA)."""
    what = "flash_attention_bwd"
    _check_headform(what, q, k, v, bias)
    b, h, s, d = q.shape
    p = bias.shape[-1]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, p):
        raise ValueError(f"{what}: o and do must be {tuple(q.shape)}, lse ({b}, {h}, {p})")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, bias, seed, o, lse, do, rate)
    is_bf16 = _check_headform_cuda(what, (q, k, v, o, do), bias)
    if lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"{what}: lse must be f32 on q's device")
    kbias = _kernel_width(bias)
    pk = kbias.shape[-1]
    dense = pk == p and lse.is_contiguous() and lse.data_ptr() % 16 == 0
    klse = lse if dense else F.pad(lse, (0, pk - p)).contiguous()  # a fresh, aligned copy
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty_like(kbias)
    delta = torch.empty((b, h, pk), dtype=torch.float32, device=q.device)
    lib, _, bwd = _headform_fns()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kbias.data_ptr(),
            int(kbias.dtype == torch.bfloat16), is_bf16, do.data_ptr(), o.data_ptr(),
            klse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dbias.data_ptr(), delta.data_ptr(), _strides(q, k, v, o, do, dq, dk, dv),
            b, s, h, pk, 1.0 / math.sqrt(d), *_dropout_args(seed, rate), stream,
        )
    cuda_build.check(lib, code, what)
    flash_attention_bwd.launches += 2
    return dq, dk, dv, dbias[:, :, :p, :p]


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, seed, rate):
        out, lse = flash_attention_fwd(q, k, v, bias, seed, rate, with_lse=True)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.args = (seed, rate)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        seed, rate = ctx.args
        do = g.to(out.dtype)
        if q.device.type == "cuda":  # the kernels take a unit last stride
            do = do.contiguous()
        dq, dk, dv, dbias = flash_attention_bwd(q, k, v, bias, seed, out, lse, do, rate)
        return dq, dk, dv, dbias, None, None


def flash_attention(
    q: torch.Tensor,     # (B, H, S, D)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # (B, H, P, P), P >= S, mask included
    block_q: int = 128,
    dropout_rate: float = 0.0,
    dropout_seed=None,   # an int, or a one-element array or tensor
) -> torch.Tensor:
    """Head-form attention with position-hash dropout on the probabilities:
    (B, H, S, D) in q's dtype. Differentiable in q, k, v and the bias (dbias
    at the bias's shape, zero past S). The bias may be pre-padded wider than
    S; keys j >= S carry no weight. ``block_q`` is taken for the JAX
    signature: the kernels tile by 64."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires a dropout_seed")
    seed = 0 if dropout_seed is None else int(torch.as_tensor(dropout_seed).reshape(-1)[0])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        return _FlashAttention.apply(q, k, v, bias, seed, float(dropout_rate))
    return flash_attention_fwd(q, k, v, bias, seed, float(dropout_rate))


def reference_attention(q, k, v, bias) -> torch.Tensor:
    """Plain (B, H, S, D) attention with a (B, H, S, S) bias: f32 scores,
    softmax, p rounded to v's dtype; the JAX package's oracle."""
    d = q.shape[-1]
    scores = torch.matmul((q / math.sqrt(d)).to(torch.float32),
                          k.to(torch.float32).transpose(-1, -2))
    p = torch.softmax(scores + bias.to(torch.float32), dim=-1).to(v.dtype)
    return torch.matmul(p.to(torch.float32), v.to(torch.float32)).to(q.dtype)


def reference_attention_hash_dropout(q, k, v, bias, seed: int, rate: float) -> torch.Tensor:
    """``reference_attention`` with the position-hash dropout of seed
    ``seed`` on the probabilities; the bias may be wider than S."""
    b, h, s, d = q.shape
    scores = torch.matmul((q / math.sqrt(d)).to(torch.float32),
                          k.to(torch.float32).transpose(-1, -2))
    p = torch.softmax(scores + bias[:, :, :s, :s].to(torch.float32), dim=-1)
    p = p * attention_dropout_scale(int(seed), b, h, s, rate, q.device)
    return torch.matmul(p.to(v.dtype).to(torch.float32), v.to(torch.float32)).to(q.dtype)


# ---------------------------------------------------------------------------
# training with the table gradients in the backward
# ---------------------------------------------------------------------------


def flash_attention_packed_train_tables_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    pos: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor, seed: int,
    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, num_heads: int,
    rate: float = 0.0, rel_bins: int = 32, max_rel: int = 128,
    rel2d_bins: int = 64, max_rel2d: int = 256,
):
    """Plain PyTorch tables backward: ds by the formulas of
    ``flash_attention_packed_train_bwd_plain``, in f32, then
    ``table_grads_plain`` of ds. Returns (dq, dk, dv, dT1, dTx, dTy)."""
    dq, dk, dv, ds = _train_bwd_plain_ds(q, k, v, bias, seed, o, lse, do, num_heads, rate)
    return (dq, dk, dv,
            *table_grads_plain(pos, cx, cy, ds, rel_bins, max_rel, rel2d_bins, max_rel2d))


@functools.lru_cache(maxsize=None)
def _tables_bwd_fn():
    lib = cuda_build.load("flash_attention_packed_train")
    fn = lib.mmee_flash_attention_packed_train_bwd_tables
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 14
        + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                                ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib, fn


def flash_attention_packed_train_tables_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    pos: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor, seed: int,
    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, num_heads: int,
    rate: float = 0.0, rel_bins: int = 32, max_rel: int = 128,
    rel2d_bins: int = 64, max_rel2d: int = 256,
):
    """Training backward with the bias cotangent reduced into the three
    tables: (dq, dk, dv in q's dtype, dT1 (rel_bins, H), dTx, dTy
    (rel2d_bins, H) f32). No dbias exists. CPU tensors run the plain
    version; CUDA tensors launch three kernels: dq and the per-block table
    sums, dk and dv, and the fixed-order sum of the blocks
    (``flash_attention_packed_train_tables_bwd.launches`` counts all three: 3
    per call)."""
    what = "flash_attention_packed_train_tables_bwd"
    _check_packed(what, q, k, v, bias, num_heads)
    b, s, hd = q.shape
    vecs = (pos, cx, cy)
    if any(a.shape != (b, s) for a in vecs):
        raise ValueError(f"{what}: pos, cx and cy must be ({b}, {s})")
    bins = (rel_bins, max_rel, rel2d_bins, max_rel2d)
    if q.device.type == "cpu":
        return flash_attention_packed_train_tables_bwd_plain(
            q, k, v, bias, pos, cx, cy, seed, o, lse, do, num_heads, rate, *bins
        )
    is_bf16 = _check_cuda_kernel_args(what, (q, k, v, o, do), bias, num_heads)
    _check_train_width(what, bias)
    p = bias.shape[-1]
    _check_lse(what, lse, (b, num_heads, p))
    if any(a.dtype != torch.int32 or not a.is_contiguous() or a.device != q.device for a in vecs):
        raise TypeError(f"{what}: pos, cx and cy must be contiguous int32 on q's device")
    n_bins = rel_bins + 2 * rel2d_bins
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((b, num_heads, p), dtype=torch.float32, device=q.device)
    n_qb = -(-s // KERNEL_TILE)
    partial = torch.empty(b * num_heads * n_qb * n_bins, dtype=torch.float32, device=q.device)
    tables = torch.empty((n_bins, num_heads), dtype=torch.float32, device=q.device)
    lut1 = bucket_lut(rel_bins, max_rel, q.device)
    lut2 = bucket_lut(rel2d_bins, max_rel2d, q.device)
    lib, fn = _tables_bwd_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            int(bias.dtype == torch.bfloat16), is_bf16, do.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *(a.data_ptr() for a in vecs), lut1.data_ptr(),
            lut2.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            delta.data_ptr(), partial.data_ptr(), tables.data_ptr(),
            b, s, num_heads, p, 1.0 / math.sqrt(hd // num_heads),
            *_dropout_args(seed, rate), rel_bins, rel2d_bins, max_rel, max_rel2d, stream,
        )
    cuda_build.check(lib, code, what)
    flash_attention_packed_train_tables_bwd.launches += 3
    return (dq, dk, dv, tables[:rel_bins], tables[rel_bins:rel_bins + rel2d_bins],
            tables[rel_bins + rel2d_bins:])


flash_attention_packed_train_tables_bwd.launches = 0


class _PackedTrainTables(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, t1, tx, ty, pos, cx, cy, seed, num_heads, rate, bins):
        out, lse = flash_attention_packed_train_fwd(q, k, v, bias, seed, num_heads, rate)
        ctx.save_for_backward(q, k, v, bias, pos, cx, cy, out, lse)
        ctx.args = (seed, num_heads, rate, bins)
        return out

    @staticmethod
    def backward(ctx, g_out):
        q, k, v, bias, pos, cx, cy, out, lse = ctx.saved_tensors
        seed, num_heads, rate, bins = ctx.args
        dq, dk, dv, dt1, dtx, dty = flash_attention_packed_train_tables_bwd(
            q, k, v, bias, pos, cx, cy, seed, out, lse, _grad_like(g_out, out),
            num_heads, rate, *bins,
        )
        return (dq, dk, dv, None, dt1, dtx, dty) + (None,) * 7


def flash_attention_packed_train_tables(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    t1: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor,
    pos: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor, seed: int,
    num_heads: int, rate: float = 0.0, rel_bins: int = 32, max_rel: int = 128,
    rel2d_bins: int = 64, max_rel2d: int = 256,
) -> torch.Tensor:
    """Training attention whose backward gives the TABLE gradients: (B, S,
    H*D) in q's dtype; gradients flow to q, k, v and the f32 tables t1 (rel_bins,
    H), tx, ty (rel2d_bins, H), never to ``bias``.

    The forward is ``flash_attention_packed_train``'s. Caller contract, as in
    the JAX package: ``bias`` is detached and equals what ``materialize_bias``
    builds from (pos, cx, cy, the mask, t1, tx, ty); the backward
    differentiates through that relation, so no (B, H, P, P) cotangent
    exists.
    """
    if bias.requires_grad:
        raise ValueError("flash_attention_packed_train_tables takes a detached bias: "
                         "the tables receive its gradient")
    h = num_heads
    if t1.shape != (rel_bins, h) or tx.shape != (rel2d_bins, h) or ty.shape != (rel2d_bins, h):
        raise ValueError(
            f"tables must be ({rel_bins}, {h}) and ({rel2d_bins}, {h}); got "
            f"{tuple(t1.shape)}, {tuple(tx.shape)}, {tuple(ty.shape)}"
        )
    return _PackedTrainTables.apply(
        q, k, v, bias, t1, tx, ty, pos, cx, cy, int(seed), num_heads, float(rate),
        (rel_bins, max_rel, rel2d_bins, max_rel2d),
    )
