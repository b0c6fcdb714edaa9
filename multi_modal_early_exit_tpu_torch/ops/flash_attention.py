"""Fused attention with an additive bias on the packed layout:
``flash_attention_packed``.

    out = softmax(q k^T * d^-1/2 + bias) v      per (batch, head)

q/k/v and the output are (B, S, H*D) — the projections' own layout, no head
transpose — and the bias is (B, H, P, P) with P >= S (pre-padded by the
bias kernel; keys j >= S do not exist). Deterministic: no dropout.

On a CUDA tensor ``flash_attention_packed`` launches the forward kernel of
``csrc/flash_attention_packed_train.cu`` without lse or dropout (q/k/v all
bf16 or all f32, bias bf16 or f32); on a CPU tensor it runs
``flash_attention_packed_plain``: dense f32 scores from the same inputs,
softmax, p cast to v's dtype, then p v.

Every CUDA kernel here takes its operands (q, k, v, o, do) all in bf16 or
all in f32, and multiplies in that type with f32 accumulation, as the TPU
kernels do: bf16 on the bf16 tensor cores; f32 good to about f32's
precision, on the same tensor cores by six bf16 products of operands split
into three bf16 parts each: every f32 forward and backward first splits its
operands (``split_bf16x3``, one launch: k and v before a forward, which
splits q itself at head dim 64 and reads its parts too at 128, q, k, v and
do before a backward; its plain version and
``split_matmul_plain``, which the plain versions take as ``matmul``, show the
arithmetic on the CPU). Other dtypes, or mixed ones, raise ``TypeError``. Under
autograd it is an ``autograd.Function`` whose backward is the JAX package's
``_packed_bwd``: the head-form forward (``flash_attention_fwd``) recomputes
the lse, then the head-form backward (``flash_attention_bwd``) gives dq, dk,
dv and dbias; the packed tensors go to both as (B, H, S, D) views, no copy.

The kernels take a head dim of 64 or 128 (``KERNEL_HEAD_DIMS``), or any
multiple of 64 above 128 in their wide mode: the score products stream the
head dim 64 columns at a time through the shared-memory ring, and the
outputs whose width is the head dim (o, dq, dk, dv) are computed in
64-column groups, one CTA per group, each recomputing the scores. The entry
points (``flash_attention_packed``, ``flash_attention_packed_train``, its
chained and tables twins, ``flash_attention`` and ``fused_bias_attention``)
take any head dim D on CUDA tensors through ``at_kernel_head_dim``: q, k and
v zero-padded to the smallest kernel width that holds D (``pad_head_dim``:
16 -> 64, 96 -> 128, 192 -> 192, 200 -> 256), the scale 1/sqrt(D) of the
true D, the output's pad columns sliced off, outside the
``autograd.Function``s so that autograd slices the gradients. Zero columns
add exact zeros to every score and give zero output and gradient columns,
so this is D's attention; the dropout hash does not see D. With f32
operands at 128 and above the kernels take an f32 bias: a bf16 one is
widened first (``_kernel_bias``, exact), and a bf16 dbias rounded from the
kernel's f32 one, the rounding the kernel itself does.

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
from multi_modal_early_exit_tpu_torch.utils.profiling import count

KERNEL_HEAD_DIMS = (64, 128)  # the kernels' widths in the head dim up to 128
KERNEL_TILE = 64  # the training kernels tile the bias width P by 64, and the
                  # wide mode the head dim


def kernel_head_dim(d: int) -> int:
    """The kernels' width for a head dim ``d``: the smallest of
    ``KERNEL_HEAD_DIMS`` that holds it, or above 128 the wide mode's, ``d``
    rounded up to a multiple of 64."""
    for width in KERNEL_HEAD_DIMS:
        if d <= width:
            return width
    return -(-d // KERNEL_TILE) * KERNEL_TILE


def _is_kernel_head_dim(d: int) -> bool:
    """Whether the kernels take a head dim ``d`` as it is."""
    return d in KERNEL_HEAD_DIMS or (d > KERNEL_HEAD_DIMS[-1] and d % KERNEL_TILE == 0)


def pad_head_dim(x: torch.Tensor, num_heads=None) -> torch.Tensor:
    """``x`` with its head dim D zero-padded to ``kernel_head_dim(D)``:
    (B, H, S, D) -> (B, H, S, W) contiguous, or with ``num_heads`` the
    packed (B, S, H*D) -> (B, S, H*W)."""
    if num_heads is None:
        d = x.shape[-1]
        return F.pad(x, (0, kernel_head_dim(d) - d)).contiguous()
    b, s, hd = x.shape
    d = hd // num_heads
    width = kernel_head_dim(d)
    return F.pad(x.reshape(b, s, num_heads, d), (0, width - d)).reshape(b, s, num_heads * width)


def _unpad_head_dim(x: torch.Tensor, d: int, num_heads=None) -> torch.Tensor:
    """The inverse of ``pad_head_dim`` on an output: its first ``d``
    columns of each head."""
    if num_heads is None:
        return x[..., :d]
    b, s, _ = x.shape
    return x.view(b, s, num_heads, -1)[..., :d].reshape(b, s, num_heads * d)


def _kernel_layout(x: torch.Tensor) -> bool:
    """Whether ``x`` goes to the kernels, and so to their head dim."""
    return x.device.type == "cuda"


def at_kernel_head_dim(what: str, fn, q, k, v, num_heads=None):
    """``fn(q, k, v, scale)`` with ``scale`` = 1/sqrt(D) of q's head dim D
    ((B, H, S, D) tensors, or packed (B, S, H*D) ones with ``num_heads``).
    For the CUDA kernels (``_kernel_layout``) a D that is no kernel width is
    zero-padded to the next one (``pad_head_dim``) and fn's output (its first
    output, when it returns a tuple) sliced back to D; autograd slices the
    gradients. Elsewhere fn sees the tensors as they are."""
    d = q.shape[-1] // num_heads if num_heads else q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    if not _kernel_layout(q) or _is_kernel_head_dim(d):
        return fn(q, k, v, scale)
    out = fn(*(pad_head_dim(x, num_heads) for x in (q, k, v)), scale)
    if isinstance(out, tuple):
        return (_unpad_head_dim(out[0], d, num_heads),) + out[1:]
    return _unpad_head_dim(out, d, num_heads)


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


def _check_head_dim(d: int) -> None:
    if not _is_kernel_head_dim(d):  # the entry points pad any other D
        raise ValueError(f"the kernel takes head dims {KERNEL_HEAD_DIMS} or multiples of "
                         f"{KERNEL_TILE} above {KERNEL_HEAD_DIMS[-1]}, not {d}")


def _kernel_bias(bias, is_bf16: int, d: int):
    """The bias as the kernels take it: f32 operands at a head dim of 128
    and above take an f32 bias (their bias tiles are 32 keys wide), so a
    bf16 one is widened, exactly; else the bias itself. None stays None."""
    if bias is None or is_bf16 or d < 128 or bias.dtype != torch.bfloat16:
        return bias
    return bias.to(torch.float32)


def _check_cuda_kernel_args(what: str, tensors, bias, num_heads: int) -> int:
    """What the CUDA attention kernels take: contiguous tensors on one card,
    16-byte aligned (the kernels load them by TMA; a misaligned one raises,
    there is no other body to fall back to), q/k/v (and o, do) all
    bf16 or all f32, a bf16 or f32 bias, head dim 64, 128 or a multiple of
    64 above (the entry points pad any other: ``at_kernel_head_dim``).
    Returns the operand flag
    (1 for bf16)."""
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
    _check_head_dim(tensors[0].shape[-1] // num_heads)
    return is_bf16


def _scale_of(d: int, scale) -> float:
    return 1.0 / math.sqrt(d) if scale is None else scale


def flash_attention_packed_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    num_heads: int, matmul=torch.matmul, scale=None,
) -> torch.Tensor:
    """Plain PyTorch ``flash_attention_packed`` (dense (B, H, S, S) scores,
    scaled by ``scale``, 1/sqrt(D) when None). Its two products go through
    ``matmul`` (``split_matmul_plain``: the f32 kernel's arithmetic)."""
    s, d = q.shape[1], q.shape[2] // num_heads
    scores = matmul(_heads(q, num_heads), _heads(k, num_heads).transpose(-1, -2))
    scores = scores * _scale_of(d, scale) + bias[:, :, :s, :s].to(torch.float32)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = matmul(p.to(torch.float32), _heads(v, num_heads))
    return _packed(out).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _flash_attention_packed_fn():
    lib = cuda_build.load("flash_attention_packed_train")
    fn = lib.mmee_flash_attention_packed
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib, fn


def _flash_attention_packed_fwd(q, k, v, bias, num_heads: int, scale: float) -> torch.Tensor:
    """The forward: the plain version on CPU tensors, the kernel on CUDA
    tensors."""
    b, s, hd = q.shape
    d = hd // num_heads
    device = q.device
    if device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, bias, num_heads, scale=scale)
    is_bf16 = _check_cuda_kernel_args("flash_attention_packed", (q, k, v), bias, num_heads)
    kbias = _kernel_bias(_kernel_width(bias), is_bf16, d)
    out = torch.empty_like(q)
    parts = _fwd_parts(q, k, v, num_heads)
    lib, fn = _flash_attention_packed_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kbias.data_ptr(),
            int(kbias.dtype == torch.bfloat16), is_bf16, _ptr(parts), out.data_ptr(),
            b, s, num_heads, d, kbias.shape[-1], scale, stream,
        )
    cuda_build.check(lib, code, "flash_attention_packed")
    count("launches.flash_attention_packed")
    return out


class _PackedAttention(torch.autograd.Function):
    """``flash_attention_packed`` with the JAX package's ``_packed_bwd``:
    the head-form forward recomputes the lse, the head-form backward gives
    the gradients, both on (B, H, S, D) views of the packed tensors."""

    @staticmethod
    def forward(ctx, q, k, v, bias, num_heads, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.args = (num_heads, scale)
        return _flash_attention_packed_fwd(q, k, v, bias, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        h, scale = ctx.args
        qh, kh, vh = (_split(x, h) for x in (q, k, v))
        gh = _split(g.to(q.dtype).contiguous(), h)
        o, lse = flash_attention_fwd(qh, kh, vh, bias, 0, 0.0, with_lse=True, scale=scale)
        dq, dk, dv, dbias = flash_attention_bwd(qh, kh, vh, bias, 0, o, lse, gh, 0.0,
                                                scale=scale)
        return _packed(dq), _packed(dk), _packed(dv), dbias, None, None


def flash_attention_packed(
    q: torch.Tensor,     # (B, S, H*D)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # (B, H, P, P), P >= S, mask included
    num_heads: int,
) -> torch.Tensor:
    """Returns (B, S, H*D) in q's dtype. CPU tensors run the plain version;
    CUDA tensors launch the kernel (counted in
    ``launches.flash_attention_packed``) at the kernels' head dim
    (``at_kernel_head_dim``), f32 ones after splitting k and v by
    ``split_bf16x3`` (one launch, counted there). Differentiable in q, k,
    v and the bias (``_PackedAttention``); without autograd nothing is
    saved."""
    _check_packed("flash_attention_packed", q, k, v, bias, num_heads)

    def run(q, k, v, scale):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
            return _PackedAttention.apply(q, k, v, bias, num_heads, scale)
        return _flash_attention_packed_fwd(q, k, v, bias, num_heads, scale)

    return at_kernel_head_dim("flash_attention_packed", run, q, k, v, num_heads)


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
    seed: int = 0, rate: float = 0.0, matmul=torch.matmul, scale=None,
):
    """Plain PyTorch head-form forward on (B, H, S, D) q/k/v: (out (B, H,
    S, D) in q's dtype, lse (B, H, P) f32, +inf past S). Dense f32 scores
    (scaled by ``scale``, 1/sqrt(D) when None), keys j >= S left out;
    dropout scales the normalised p, which is rounded to v's dtype before p
    v. Its two products go through ``matmul`` (``split_matmul_plain``: the
    f32 kernel's arithmetic). The training forward's plain version on the
    heads of the packed projections."""
    b, h, s, d = q.shape
    scores = matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    scores = scores * _scale_of(d, scale) + bias[:, :, :s, :s].to(torch.float32)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    denom = e.sum(dim=-1, keepdim=True)
    p = e / denom
    if rate > 0.0:
        p = p * attention_dropout_scale(seed, b, h, s, rate, q.device)
    out = matmul(p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    lse = torch.full((b, h, bias.shape[-1]), math.inf, dtype=torch.float32, device=q.device)
    lse[:, :, :s] = (m + torch.log(denom))[..., 0]
    return out.to(q.dtype), lse


def flash_attention_packed_train_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    seed: int, num_heads: int, rate: float = 0.0, matmul=torch.matmul, scale=None,
):
    """Plain PyTorch training forward: (out (B, S, H*D) in q's dtype,
    lse (B, H, P) f32, +inf past S). Dropout scales the normalised p; the
    products go through ``matmul``."""
    out, lse = flash_attention_fwd_plain(
        *(_split(x, num_heads) for x in (q, k, v)), bias, seed, rate, matmul, scale)
    return _packed(out), lse


# the bf16 products of one product of split operands, smallest first, as
# (part of a, part of b) with 0 hi, 1 mid, 2 lo; the three of order 2^-24
# and below (mid lo, lo mid, lo lo) are left out
SPLIT_TERMS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def split_bf16x3_plain(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` as three bf16 parts, (3, *x.shape): hi = bf16(x), mid =
    bf16(x - hi), lo = bf16(x - hi - mid), each rounded to nearest even.
    Both differences are exact in f32 and bf16 has f32's exponent range,
    so hi + (mid + lo) is x bit for bit wherever lo stays normal (|x| >=
    2^-100 or so)."""
    hi = x.to(torch.bfloat16)
    rest = x - hi.to(torch.float32)
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.to(torch.float32)).to(torch.bfloat16)
    return torch.stack((hi, mid, lo))


def split_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of f32 operands as the f32 backward kernels take it on the bf16
    tensor cores: both split (``split_bf16x3_plain``), the six products of
    ``SPLIT_TERMS`` summed in that order in f32. Each part is cast to f32
    before it is multiplied: a bf16 x bf16 product is exact in f32, as in
    the tensor cores, where a product in bf16 would round it."""
    pa, pb = split_bf16x3_plain(a).to(torch.float32), split_bf16x3_plain(b).to(torch.float32)
    out = None
    for i, j in SPLIT_TERMS:
        term = torch.matmul(pa[i], pb[j])
        out = term if out is None else out + term
    return out


def _attention_bwd_plain_ds(q, k, v, bias, seed, o, lse, do, rate, matmul=torch.matmul,
                            scale=None):
    """The explicit backward formulas on (B, H, S, D) tensors: p from the
    lse, delta = rowsum(do o), ds = p (dp c - delta), dv from p c; ds is
    rounded to q's dtype before the dq/dk products, p c to do's before dv.
    Its five products go through ``matmul`` (``split_matmul_plain``: the
    f32 kernels' arithmetic). Returns (dq, dk, dv in the inputs' dtypes, ds
    (B, H, S, S) f32)."""
    b, h, s, d = q.shape
    scale = _scale_of(d, scale)
    qh, kh, vh, oh, doh = (x.to(torch.float32) for x in (q, k, v, o, do))
    scores = matmul(qh, kh.transpose(-1, -2)) * scale
    scores = scores + bias[:, :, :s, :s].to(torch.float32)
    p = torch.exp(scores - lse[:, :, :s, None])
    dp = matmul(doh, vh.transpose(-1, -2))
    pd = p
    if rate > 0.0:
        c = attention_dropout_scale(seed, b, h, s, rate, q.device)
        pd, dp = p * c, dp * c
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    ds_c = ds.to(q.dtype).to(torch.float32)
    dq = matmul(ds_c, kh) * scale
    dk = matmul(ds_c.transpose(-1, -2), qh) * scale
    dv = matmul(pd.to(do.dtype).to(torch.float32).transpose(-1, -2), doh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds


def _train_bwd_plain_ds(q, k, v, bias, seed, o, lse, do, num_heads, rate, matmul=torch.matmul,
                        scale=None):
    """``_attention_bwd_plain_ds`` on the packed layout: (dq, dk, dv packed
    in the inputs' dtypes, ds (B, H, S, S) f32)."""
    dq, dk, dv, ds = _attention_bwd_plain_ds(
        *(_split(x, num_heads) for x in (q, k, v)), bias, seed,
        _split(o, num_heads), lse, _split(do, num_heads), rate, matmul, scale)
    return _packed(dq), _packed(dk), _packed(dv), ds


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    seed: int, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    rate: float = 0.0, matmul=torch.matmul, scale=None,
):
    """Plain PyTorch head-form backward by the explicit formulas of
    ``_attention_bwd_plain_ds``: (dq, dk, dv (B, H, S, D) in the inputs'
    dtypes, dbias = ds at the bias's shape and dtype, zero past S)."""
    dq, dk, dv, ds = _attention_bwd_plain_ds(q, k, v, bias, seed, o, lse, do, rate, matmul,
                                             scale)
    s = q.shape[2]
    dbias = torch.zeros(bias.shape, dtype=torch.float32, device=q.device)
    dbias[:, :, :s, :s] = ds
    return dq, dk, dv, dbias.to(bias.dtype)


def flash_attention_packed_train_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    seed: int, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    num_heads: int, rate: float = 0.0, gbias=None, matmul=torch.matmul, scale=None,
):
    """Plain PyTorch training backward by the explicit formulas: p from the
    lse, delta = rowsum(do o), ds = p (dp c - delta), dv from p c. Returns
    (dq, dk, dv, dbias); dbias is (B, H, P, P) in the bias dtype, gbias + ds
    when ``gbias`` is given, with ds zero past S."""
    dq, dk, dv, ds = _train_bwd_plain_ds(q, k, v, bias, seed, o, lse, do, num_heads, rate,
                                         matmul, scale)
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
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fwd.restype = ctypes.c_int
    bwd = lib.mmee_flash_attention_packed_train_bwd
    bwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    bwd.restype = ctypes.c_int
    return lib, fwd, bwd


@functools.lru_cache(maxsize=None)
def _split_fn():
    lib = cuda_build.load("flash_attention_packed_train")
    fn = lib.mmee_split_bf16x3
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
                                 ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib, fn


def split_bf16x3(*xs: torch.Tensor, out=None) -> torch.Tensor:
    """One to four f32 (B, H, S, D) tensors of one shape (D a kernel head
    dim: 64, 128 or a multiple of 64 above), each
    split into its three bf16 parts (``split_bf16x3_plain``): (n, 3, B, H, S,
    D) bf16,
    into ``out`` where given. CPU tensors run the plain version; CUDA
    tensors (rows 16-byte aligned: a unit last stride, the other strides
    multiples of 4, the data 16-byte aligned) launch the split pre-pass of
    the f32 backwards, one launch for all (counted in
    ``launches.split_bf16x3``)."""
    x0 = xs[0]
    if not 1 <= len(xs) <= 4 or any(x.shape != x0.shape or x.device != x0.device for x in xs):
        raise ValueError("split_bf16x3 takes one to four tensors of one shape on one device")
    if (x0.ndim != 4 or not _is_kernel_head_dim(x0.shape[-1])
            or any(x.dtype != torch.float32 for x in xs)):
        raise ValueError("split_bf16x3 takes f32 (B, H, S, D) tensors at a kernel head dim")
    b, h, s, d = x0.shape
    if out is None:
        out = torch.empty((len(xs), 3, b, h, s, d), dtype=torch.bfloat16, device=x0.device)
    if x0.device.type == "cpu":
        for i, x in enumerate(xs):
            out[i] = split_bf16x3_plain(x)
        return out
    if any(x.stride(3) != 1 or any(st % 4 for st in x.stride()[:3]) or x.data_ptr() % 16
           for x in xs):
        raise ValueError("split_bf16x3 takes tensors with unit last stride, the other strides "
                         "multiples of 4 and 16-byte aligned data")
    ptrs = [x.data_ptr() for x in xs] + [0] * (4 - len(xs))
    lib, fn = _split_fn()
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        code = fn(*ptrs, len(xs), _strides(*xs), out.data_ptr(), b, h, s, d, stream)
    cuda_build.check(lib, code, "split_bf16x3")
    count("launches.split_bf16x3")
    return out


def _fwd_parts(q, k, v, num_heads=None):
    """The forward kernels' split operands: None for bf16 q/k/v, which the
    kernels load as they are (nothing is allocated or launched); for f32
    ones the three bf16 parts of k and v, (2, 3, B, H, S, D), written here
    by ``split_bf16x3`` (one launch): at head dim 64 the kernels split q
    themselves, at 128 and above q's parts follow, (3, 3, B, H, S, D). q,
    k, v are (B, H, S, D), or packed (B, S, H*D) with ``num_heads``."""
    if k.dtype == torch.bfloat16:
        return None
    d = q.shape[-1] // num_heads if num_heads else q.shape[-1]
    xs = (k, v, q) if d >= 128 else (k, v)
    return split_bf16x3(*(x if num_heads is None else _split(x, num_heads) for x in xs))


def _ptr(x) -> int:
    """A tensor's data pointer for the kernels, 0 for None."""
    return 0 if x is None else x.data_ptr()


def _bwd_scratch(b: int, num_heads: int, p: int, q, k, v, do) -> torch.Tensor:
    """The backward kernels' ``delta`` scratch: B*H*P f32, and with f32
    operands after it the split parts of q, k, v and do, in that order,
    written here by ``split_bf16x3``. q, k, v, do are (B, H, S, D), or
    packed (B, S, H*D) and split into heads here (f32 only: the views cost
    the bf16 backward's host time)."""
    n = b * num_heads * p
    if q.dtype == torch.bfloat16:
        return torch.empty(n, dtype=torch.float32, device=q.device)
    operands = [x if x.ndim == 4 else _split(x, num_heads) for x in (q, k, v, do)]
    s, d = operands[0].shape[2:]
    scratch = torch.empty(n + 6 * b * num_heads * s * d, dtype=torch.float32, device=q.device)
    parts = scratch[n:].view(torch.bfloat16).view(4, 3, b, num_heads, s, d)
    split_bf16x3(*operands, out=parts)
    return scratch


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
    seed: int, num_heads: int, rate: float = 0.0, scale=None,
):
    """Training forward: (out (B, S, H*D) in q's dtype, lse (B, H, P) f32,
    +inf past S), the scores scaled by ``scale`` (1/sqrt(D) when None). CPU
    tensors run the plain version; CUDA tensors launch the kernel (counted in
    ``launches.flash_attention_packed_train``), f32 ones after splitting k
    and v by ``split_bf16x3`` (one launch, counted there)."""
    _check_packed("flash_attention_packed_train", q, k, v, bias, num_heads)
    scale = _scale_of(q.shape[-1] // num_heads, scale)
    if q.device.type == "cpu":
        return flash_attention_packed_train_fwd_plain(q, k, v, bias, seed, num_heads, rate,
                                                      scale=scale)
    is_bf16 = _check_cuda_kernel_args("flash_attention_packed_train", (q, k, v), bias, num_heads)
    _check_train_width("flash_attention_packed_train", bias)
    b, s, hd = q.shape
    d = hd // num_heads
    bias = _kernel_bias(bias, is_bf16, d)
    p = bias.shape[-1]
    out = torch.empty_like(q)
    lse = torch.empty((b, num_heads, p), dtype=torch.float32, device=q.device)
    parts = _fwd_parts(q, k, v, num_heads)
    lib, fwd, _ = _train_fns()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            int(bias.dtype == torch.bfloat16), is_bf16, _ptr(parts), out.data_ptr(),
            lse.data_ptr(), b, s, num_heads, d, p, scale, *_dropout_args(seed, rate), stream,
        )
    cuda_build.check(lib, code, "flash_attention_packed_train")
    count("launches.flash_attention_packed_train")
    return out, lse


def flash_attention_packed_train_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    seed: int, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    num_heads: int, rate: float = 0.0, gbias=None, scale=None,
):
    """Training backward: (dq, dk, dv in q's dtype, dbias (B, H, P, P) in the
    bias dtype, gbias + ds when ``gbias`` is given), for the forward's
    ``scale`` (1/sqrt(D) when None). CPU tensors run the plain version; CUDA
    tensors launch the kernel pair, one kernel for dq and dbias and one for
    dk and dv (``launches.flash_attention_packed_train_bwd`` counts both: 2
    per call), f32 ones after splitting q, k, v and do by ``split_bf16x3``
    (one launch, counted there)."""
    _check_packed("flash_attention_packed_train_bwd", q, k, v, bias, num_heads)
    if gbias is not None and gbias.shape != bias.shape:
        raise ValueError(f"gbias must have the bias shape {tuple(bias.shape)}")
    scale = _scale_of(q.shape[-1] // num_heads, scale)
    if q.device.type == "cpu":
        return flash_attention_packed_train_bwd_plain(
            q, k, v, bias, seed, o, lse, do, num_heads, rate, gbias, scale=scale
        )
    what = "flash_attention_packed_train_bwd"
    is_bf16 = _check_cuda_kernel_args(what, (q, k, v, o, do), bias, num_heads)
    _check_train_width(what, bias)
    b, s, hd = q.shape
    d = hd // num_heads
    p = bias.shape[-1]
    _check_lse(what, lse, (b, num_heads, p))
    if gbias is not None and (gbias.dtype != bias.dtype or not gbias.is_contiguous()
                              or gbias.device != q.device or gbias.data_ptr() % 16):
        raise ValueError(f"{what}: gbias must be contiguous, 16-byte aligned, on q's device, "
                         f"in the bias dtype")
    bias_dtype = bias.dtype
    bias, gbias = _kernel_bias(bias, is_bf16, d), _kernel_bias(gbias, is_bf16, d)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.empty_like(bias)
    delta = _bwd_scratch(b, num_heads, p, q, k, v, do)
    lib, _, bwd = _train_fns()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            int(bias.dtype == torch.bfloat16), is_bf16, do.data_ptr(), o.data_ptr(),
            lse.data_ptr(), 0 if gbias is None else gbias.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(),
            delta.data_ptr(), b, s, num_heads, d, p, scale, *_dropout_args(seed, rate), stream,
        )
    cuda_build.check(lib, code, what)
    count("launches.flash_attention_packed_train_bwd", 2)
    return dq, dk, dv, dbias.to(bias_dtype)


def _grad_like(g, like: torch.Tensor) -> torch.Tensor:
    if g is None:
        return torch.zeros_like(like)
    return g.to(like.dtype).contiguous()


class _PackedTrainChained(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, seed, num_heads, rate, scale):
        ctx.set_materialize_grads(False)
        out, lse = flash_attention_packed_train_fwd(q, k, v, bias, seed, num_heads, rate, scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.args = (seed, num_heads, rate, scale)
        return out, bias.view_as(bias)

    @staticmethod
    def backward(ctx, g_out, g_bias):
        q, k, v, bias, out, lse = ctx.saved_tensors
        seed, num_heads, rate, scale = ctx.args
        gbias = None if g_bias is None else _grad_like(g_bias, bias)
        dq, dk, dv, dbias = flash_attention_packed_train_bwd(
            q, k, v, bias, seed, out, lse, _grad_like(g_out, out), num_heads,
            rate, gbias=gbias, scale=scale,
        )
        return dq, dk, dv, dbias, None, None, None, None


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
    to this layer's ds by the backward kernel. CUDA tensors run at the
    kernels' head dim (``at_kernel_head_dim``)."""
    if bias.shape[-2] != bias.shape[-1]:
        raise ValueError(f"the chained op needs a square bias, got {tuple(bias.shape)}")
    _check_packed("flash_attention_packed_train", q, k, v, bias, num_heads)
    return at_kernel_head_dim(
        "flash_attention_packed_train",
        lambda q, k, v, scale: _PackedTrainChained.apply(
            q, k, v, bias, int(seed), num_heads, float(rate), scale),
        q, k, v, num_heads)


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
    """What the kernels take in the head form: (B, H, rows, D) tensors, D
    a kernel head dim,
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
    _check_head_dim(tensors[0].shape[-1])  # flash_attention pads any other
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
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
        + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p]
    )
    fwd.restype = ctypes.c_int
    bwd = lib.mmee_flash_attention_bwd
    bwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
        + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p]
    )
    bwd.restype = ctypes.c_int
    return lib, fwd, bwd


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    seed: int = 0, rate: float = 0.0, with_lse: bool = False, scale=None,
):
    """Head-form forward: out (B, H, S, D) in q's dtype and q's layout, and
    with ``with_lse`` also the lse (B, H, P) f32, +inf past S; the scores
    scaled by ``scale`` (1/sqrt(D) when None). CPU tensors run the plain
    version; CUDA tensors launch the kernel (counted in
    ``launches.flash_attention_fwd``), f32 ones after splitting k and v by
    ``split_bf16x3`` (one launch, counted there)."""
    _check_headform("flash_attention_fwd", q, k, v, bias)
    scale = _scale_of(q.shape[-1], scale)
    if q.device.type == "cpu":
        out, lse = flash_attention_fwd_plain(q, k, v, bias, seed, rate, scale=scale)
        return (out, lse) if with_lse else out
    is_bf16 = _check_headform_cuda("flash_attention_fwd", (q, k, v), bias)
    b, h, s, d = q.shape
    p = bias.shape[-1]
    kbias = _kernel_bias(_kernel_width(bias), is_bf16, d)
    out = torch.empty_like(q)  # keeps q's layout when q is dense
    lse = torch.empty((b, h, kbias.shape[-1]), dtype=torch.float32, device=q.device)
    parts = _fwd_parts(q, k, v)
    lib, fwd, _ = _headform_fns()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kbias.data_ptr(),
            int(kbias.dtype == torch.bfloat16), is_bf16, _ptr(parts), out.data_ptr(),
            lse.data_ptr(),
            _strides(q, k, v, out), b, s, h, d, kbias.shape[-1], scale,
            *_dropout_args(seed, rate), stream,
        )
    cuda_build.check(lib, code, "flash_attention_fwd")
    count("launches.flash_attention_fwd")
    return (out, lse[:, :, :p]) if with_lse else out


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    seed: int, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    rate: float = 0.0, scale=None,
):
    """Head-form backward from the forward's lse: (dq, dk, dv (B, H, S, D)
    in the inputs' dtypes and layouts, dbias = ds at the bias's shape and
    dtype, exactly zero past S), for the forward's ``scale`` (1/sqrt(D) when
    None). delta = rowsum(do o) is computed in the
    kernel. CPU tensors run the plain version; CUDA tensors launch the
    kernel pair, one kernel for dq and dbias and one for dk and dv
    (``launches.flash_attention_bwd`` counts both: 2 per call), f32 ones
    after ``split_bf16x3`` of q, k, v and do (one launch, counted there); o
    and do must meet q's layout rules too (the kernels load do by TMA)."""
    what = "flash_attention_bwd"
    _check_headform(what, q, k, v, bias)
    b, h, s, d = q.shape
    p = bias.shape[-1]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, p):
        raise ValueError(f"{what}: o and do must be {tuple(q.shape)}, lse ({b}, {h}, {p})")
    scale = _scale_of(d, scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, bias, seed, o, lse, do, rate, scale=scale)
    is_bf16 = _check_headform_cuda(what, (q, k, v, o, do), bias)
    if lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"{what}: lse must be f32 on q's device")
    kbias = _kernel_bias(_kernel_width(bias), is_bf16, d)
    pk = kbias.shape[-1]
    dense = pk == p and lse.is_contiguous() and lse.data_ptr() % 16 == 0
    klse = lse if dense else F.pad(lse, (0, pk - p)).contiguous()  # a fresh, aligned copy
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty_like(kbias)
    delta = _bwd_scratch(b, h, pk, q, k, v, do)
    lib, _, bwd = _headform_fns()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kbias.data_ptr(),
            int(kbias.dtype == torch.bfloat16), is_bf16, do.data_ptr(), o.data_ptr(),
            klse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dbias.data_ptr(), delta.data_ptr(), _strides(q, k, v, o, do, dq, dk, dv),
            b, s, h, d, pk, scale, *_dropout_args(seed, rate), stream,
        )
    cuda_build.check(lib, code, what)
    count("launches.flash_attention_bwd", 2)
    return dq, dk, dv, dbias[:, :, :p, :p].to(bias.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, seed, rate, scale):
        out, lse = flash_attention_fwd(q, k, v, bias, seed, rate, with_lse=True, scale=scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.args = (seed, rate, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        seed, rate, scale = ctx.args
        do = g.to(out.dtype)
        if q.device.type == "cuda":  # the kernels take a unit last stride
            do = do.contiguous()
        dq, dk, dv, dbias = flash_attention_bwd(q, k, v, bias, seed, out, lse, do, rate,
                                                scale=scale)
        return dq, dk, dv, dbias, None, None, None


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
    signature: the kernels tile by 64. CUDA tensors run at the kernels' head
    dim (``at_kernel_head_dim``)."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires a dropout_seed")
    seed = 0 if dropout_seed is None else int(torch.as_tensor(dropout_seed).reshape(-1)[0])
    _check_headform("flash_attention", q, k, v, bias)

    def run(q, k, v, scale):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
            return _FlashAttention.apply(q, k, v, bias, seed, float(dropout_rate), scale)
        return flash_attention_fwd(q, k, v, bias, seed, float(dropout_rate), scale=scale)

    return at_kernel_head_dim("flash_attention", run, q, k, v)


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
    rel2d_bins: int = 64, max_rel2d: int = 256, scale=None,
):
    """Plain PyTorch tables backward: ds by the formulas of
    ``flash_attention_packed_train_bwd_plain``, in f32, then
    ``table_grads_plain`` of ds. Returns (dq, dk, dv, dT1, dTx, dTy)."""
    dq, dk, dv, ds = _train_bwd_plain_ds(q, k, v, bias, seed, o, lse, do, num_heads, rate,
                                         scale=scale)
    return (dq, dk, dv,
            *table_grads_plain(pos, cx, cy, ds, rel_bins, max_rel, rel2d_bins, max_rel2d))


@functools.lru_cache(maxsize=None)
def _tables_bwd_fn():
    lib = cuda_build.load("flash_attention_packed_train")
    fn = lib.mmee_flash_attention_packed_train_bwd_tables
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 14
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                                ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib, fn


def flash_attention_packed_train_tables_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    pos: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor, seed: int,
    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, num_heads: int,
    rate: float = 0.0, rel_bins: int = 32, max_rel: int = 128,
    rel2d_bins: int = 64, max_rel2d: int = 256, scale=None,
):
    """Training backward with the bias cotangent reduced into the three
    tables: (dq, dk, dv in q's dtype, dT1 (rel_bins, H), dTx, dTy
    (rel2d_bins, H) f32), for the forward's ``scale`` (1/sqrt(D) when
    None). No dbias exists. CPU tensors run the plain
    version; CUDA tensors launch three kernels: dq and the per-block table
    sums, dk and dv, and the fixed-order sum of the blocks
    (``launches.flash_attention_packed_train_tables_bwd`` counts all three: 3
    per call), f32 ones after ``split_bf16x3`` of q, k, v and do for the dk/dv
    kernel (one launch, counted there)."""
    what = "flash_attention_packed_train_tables_bwd"
    _check_packed(what, q, k, v, bias, num_heads)
    b, s, hd = q.shape
    vecs = (pos, cx, cy)
    if any(a.shape != (b, s) for a in vecs):
        raise ValueError(f"{what}: pos, cx and cy must be ({b}, {s})")
    bins = (rel_bins, max_rel, rel2d_bins, max_rel2d)
    scale = _scale_of(hd // num_heads, scale)
    if q.device.type == "cpu":
        return flash_attention_packed_train_tables_bwd_plain(
            q, k, v, bias, pos, cx, cy, seed, o, lse, do, num_heads, rate, *bins, scale=scale
        )
    is_bf16 = _check_cuda_kernel_args(what, (q, k, v, o, do), bias, num_heads)
    _check_train_width(what, bias)
    d = hd // num_heads
    bias = _kernel_bias(bias, is_bf16, d)
    p = bias.shape[-1]
    _check_lse(what, lse, (b, num_heads, p))
    if any(a.dtype != torch.int32 or not a.is_contiguous() or a.device != q.device for a in vecs):
        raise TypeError(f"{what}: pos, cx and cy must be contiguous int32 on q's device")
    n_bins = rel_bins + 2 * rel2d_bins
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = _bwd_scratch(b, num_heads, p, q, k, v, do)
    n_qb = -(-s // KERNEL_TILE)
    # per-CTA partials; f32 operands at 128 and above also each CTA's (bins,
    # 64 rows) histogram after them, which their shared memory cannot hold
    per_cta = n_bins * (65 if not is_bf16 and d >= 128 else 1)
    partial = torch.empty(b * num_heads * n_qb * per_cta, dtype=torch.float32, device=q.device)
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
            b, s, num_heads, d, p, scale, *_dropout_args(seed, rate), rel_bins, rel2d_bins,
            max_rel, max_rel2d, stream,
        )
    cuda_build.check(lib, code, what)
    count("launches.flash_attention_packed_train_tables_bwd", 3)
    return (dq, dk, dv, tables[:rel_bins], tables[rel_bins:rel_bins + rel2d_bins],
            tables[rel_bins + rel2d_bins:])


class _PackedTrainTables(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, t1, tx, ty, pos, cx, cy, seed, num_heads, rate, bins, scale):
        out, lse = flash_attention_packed_train_fwd(q, k, v, bias, seed, num_heads, rate, scale)
        ctx.save_for_backward(q, k, v, bias, pos, cx, cy, out, lse)
        ctx.args = (seed, num_heads, rate, bins, scale)
        return out

    @staticmethod
    def backward(ctx, g_out):
        q, k, v, bias, pos, cx, cy, out, lse = ctx.saved_tensors
        seed, num_heads, rate, bins, scale = ctx.args
        dq, dk, dv, dt1, dtx, dty = flash_attention_packed_train_tables_bwd(
            q, k, v, bias, pos, cx, cy, seed, out, lse, _grad_like(g_out, out),
            num_heads, rate, *bins, scale=scale,
        )
        return (dq, dk, dv, None, dt1, dtx, dty) + (None,) * 8


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

    The forward is ``flash_attention_packed_train``'s; CUDA tensors run at
    the kernels' head dim (``at_kernel_head_dim``). Caller contract, as in
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
    _check_packed("flash_attention_packed_train_tables", q, k, v, bias, num_heads)
    return at_kernel_head_dim(
        "flash_attention_packed_train_tables",
        lambda q, k, v, scale: _PackedTrainTables.apply(
            q, k, v, bias, t1, tx, ty, pos, cx, cy, int(seed), num_heads, float(rate),
            (rel_bins, max_rel, rel2d_bins, max_rel2d), scale),
        q, k, v, num_heads)
