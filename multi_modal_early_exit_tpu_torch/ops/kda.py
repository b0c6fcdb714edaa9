"""The core of Kimi Delta Attention (Kimi-Linear's linear-attention layers):
a gated delta rule with a per-channel forget gate, over right-padded rows.

Per row b and head h, from a zero state at the row's first position (S is
d_k x d_v):

    S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T
    o_t = S_t^T q_t

q, k, v (B, S, H, D), g (B, S, H, D) the log forget gate (<= 0), beta (B,
S, H); ``lengths`` (B,) the rows' real positions. o is zero at and past a
row's length, and a padded position never reaches a real one's result.
No TPU kernel has this job: the JAX package runs no linear attention.

On CUDA tensors ``kda`` launches the hand-written kernels of
``csrc/kda.cu`` (two launches a call, whatever the length, counted in
``launches.kda``): the chunked form at 64 positions a chunk (arranged for
the card as ``csrc/kda.cu``'s note says: sub-chunks of 16, and O through
P = Qt T), bf16 q, k, v and o, f32 g, beta, state and sums (the state's
products on tf32 operands), head dim 128; anything else raises, and there
is no fallback.
On CPU tensors it is ``kda_chunked_plain``: the same
chunked form in torch ops, a loop over the chunks, at any chunk size and
head dim, in f32. Within a chunk, with Gamma the running sum of g:

    A_ri  = sum_c k_rc k_ic e^{Gamma_rc - Gamma_ic}    (i < r)
    Qt_ri = sum_c q_rc k_ic e^{Gamma_rc - Gamma_ic}    (i <= r)
    T     = (I + diag(beta) A)^{-1} diag(beta)
    Delta = T (V - (K e^Gamma) S)
    O     = (Q e^Gamma) S + Qt Delta
    S    <- Diag(e^{Gamma_C}) S + (K e^{Gamma_C - Gamma})^T Delta

every exponent a difference of running sums, never e^{-Gamma} alone.

The sub-layer's elementwise work around the core has one kernel each in
the same library, with the same rule (a kernel on CUDA tensors, else the
plain version): ``short_conv`` (the causal width-4 depthwise convolution
over positions and SiLU, and for q and k each head's L2 norm and scale),
``kda_gate`` (the log forget gate from its low-rank projection) and
``gated_rms_norm`` (the output's per-head RMSNorm times sigmoid of the
output gate).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from multi_modal_early_exit_tpu_torch.ops import cuda_build
from multi_modal_early_exit_tpu_torch.utils.profiling import count

CHUNK = 64      # the kernel's chunk
HEAD_DIM = 128  # the kernel's head dim, Kimi-Linear's
CONV_WIDTH = 4  # the short convolution kernel's width


def _padded_rows(x: torch.Tensor, keep: torch.Tensor, n: int, chunk: int) -> torch.Tensor:
    """x (B, S, H, ...) in f32, zero where ``keep`` (B, S) is False, padded
    with zeros to n chunks and laid out (B, H, n, chunk, ...)."""
    b, s = x.shape[:2]
    x = torch.where(keep.view(b, s, *([1] * (x.dim() - 2))), x.float(), 0.0)
    x = F.pad(x, [0, 0] * (x.dim() - 2) + [0, n * chunk - s])
    x = x.view(b, n, chunk, *x.shape[2:])
    return x.permute(0, 3, 1, 2, *range(4, x.dim()))


def kda_chunked_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                      beta: torch.Tensor, lengths: torch.Tensor,
                      chunk: int = CHUNK) -> torch.Tensor:
    """The chunked form in torch ops, f32, a loop over the chunks: (B, S, H,
    Dv) in v's dtype."""
    b, s, h, dk = k.shape
    dv = v.shape[-1]
    n = -(-s // chunk)
    keep = torch.arange(s, device=k.device)[None, :] < lengths.to(k.device).view(b, 1)
    qc, kc, vc, gc = (_padded_rows(t, keep, n, chunk) for t in (q, k, v, g))
    bc = _padded_rows(beta, keep, n, chunk)  # (B, H, n, chunk)
    incl = torch.ones(chunk, chunk, dtype=torch.bool, device=k.device).tril()
    strict = incl.tril(-1)
    eye = torch.eye(chunk, device=k.device)
    state = k.new_zeros((b, h, dk, dv), dtype=torch.float32)
    out = []
    for c in range(n):
        qi, ki, vi, bi = qc[:, :, c], kc[:, :, c], vc[:, :, c], bc[:, :, c]
        gam = gc[:, :, c].cumsum(dim=-2)  # (B, H, C, Dk)
        diff = gam[:, :, :, None, :] - gam[:, :, None, :, :]  # [r, i, c]
        decay = torch.where(incl[:, :, None], diff, float("-inf")).exp()
        kk = ki[:, :, None, :, :] * decay  # k_i e^{Gamma_r - Gamma_i}
        a = torch.einsum("bhrc,bhric->bhri", ki, kk) * strict
        qt = torch.einsum("bhrc,bhric->bhri", qi, kk)
        lower = eye + bi[..., :, None] * a
        t = torch.linalg.solve_triangular(lower, torch.diag_embed(bi), upper=False,
                                          unitriangular=True)
        delta = t @ (vi - (ki * gam.exp()) @ state)
        out.append((qi * gam.exp()) @ state + qt @ delta)
        last = gam[:, :, -1:, :]
        state = last.exp().transpose(-1, -2) * state \
            + (ki * (last - gam).exp()).transpose(-1, -2) @ delta
    o = torch.stack(out, dim=2).reshape(b, h, n * chunk, dv)[:, :, :s].transpose(1, 2)
    return torch.where(keep[:, :, None, None], o, 0.0).to(v.dtype).contiguous()


# ---------------------------------------------------------------------------
# the sub-layer's elementwise work around the core
# ---------------------------------------------------------------------------

L2_EPS = 1e-6  # q's and k's L2 norm per head


def short_conv_plain(x: torch.Tensor, weight: torch.Tensor, scale: Optional[float] = None,
                     head_dim: int = HEAD_DIM) -> torch.Tensor:
    """SiLU of the causal depthwise convolution over positions of x (B, S,
    C) by weight (C, 1, width), zeros before the row, in f32; with
    ``scale`` each head of ``head_dim`` channels times ``scale`` over its
    L2 norm (x rsqrt(sum x^2 + 1e-6)). In x's dtype."""
    b, s, c = x.shape
    width = weight.shape[-1]
    y = F.conv1d(x.float().transpose(1, 2), weight.float(), padding=width - 1, groups=c)
    y = F.silu(y[..., :s]).transpose(1, 2)
    if scale is not None:
        heads = y.reshape(b, s, c // head_dim, head_dim)
        y = heads * torch.rsqrt(heads.pow(2).sum(-1, keepdim=True) + L2_EPS) * scale
    return y.reshape(b, s, c).to(x.dtype).contiguous()


def kda_gate_plain(raw: torch.Tensor, a_log: torch.Tensor, dt_bias: torch.Tensor,
                   head_dim: int) -> torch.Tensor:
    """The log forget gate, (B, S, heads, head_dim) f32: -exp(a_log[head])
    softplus(raw + dt_bias) per channel of raw (B, S, heads head_dim)."""
    b, s, _ = raw.shape
    z = (raw.float() + dt_bias.float()).view(b, s, -1, head_dim)
    return -a_log.float().exp()[:, None] * F.softplus(z)


def gated_rms_norm_plain(o: torch.Tensor, gate: torch.Tensor, weight: torch.Tensor,
                         eps: float) -> torch.Tensor:
    """o (B, S, heads, d) over the RMS of each head's d, times weight (d,)
    and sigmoid(gate) (gate of o's size), in f32; in o's dtype."""
    of = o.float()
    of = of * torch.rsqrt(of.pow(2).mean(-1, keepdim=True) + eps)
    return (of * weight.float() * torch.sigmoid(gate.float().view(o.shape))).to(o.dtype)


def _rows_refusal(name: str, t: torch.Tensor, width: int) -> Optional[str]:
    if t.dtype != torch.bfloat16:
        return f"{name} is {t.dtype}; the kernels take bfloat16"
    if t.shape[-1] % width or not t.is_contiguous() or t.data_ptr() % 16:
        return (f"{name} must be contiguous and 16-byte aligned, its last dim a multiple of "
                f"{width}, got {tuple(t.shape)}")
    if t.device.type != "cuda":
        return f"the kernels run on cuda, not {t.device}"
    return None


@functools.lru_cache(maxsize=None)
def _elementwise_fns():
    lib = cuda_build.load("kda")
    conv, gate, norm = lib.mmee_short_conv, lib.mmee_kda_gate, lib.mmee_gated_rms_norm
    conv.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    gate.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    norm.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
    for fn in (conv, gate, norm):
        fn.restype = ctypes.c_int
    return lib, conv, gate, norm


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def short_conv(x: torch.Tensor, weight: torch.Tensor, scale: Optional[float] = None,
               head_dim: int = HEAD_DIM) -> torch.Tensor:
    """``short_conv_plain`` (B, S, C); on CUDA tensors one launch of the
    kernel (``launches.short_conv``): bf16 x of an even number of heads of
    128 channels, width 4."""
    if not x.is_cuda:
        return short_conv_plain(x, weight, scale, head_dim)
    why = _rows_refusal("x", x, 2 * HEAD_DIM) or (
        None if head_dim == HEAD_DIM and weight.shape == (x.shape[-1], 1, CONV_WIDTH)
        else f"weight must be ({x.shape[-1]}, 1, {CONV_WIDTH}) in heads of {HEAD_DIM}, got "
             f"{tuple(weight.shape)} in heads of {head_dim}")
    if why is not None:
        raise ValueError(f"short_conv: {why}")
    b, s, c = x.shape
    w = weight.reshape(c, -1).float().contiguous()
    out = torch.empty_like(x)
    lib, conv, _, _ = _elementwise_fns()
    with torch.cuda.device(x.device):
        code = conv(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, s, c, w.shape[1],
                    int(scale is not None), float(scale or 0.0), _stream(x))
    cuda_build.check(lib, code, "short_conv")
    count("launches.short_conv")
    return out


def kda_gate(raw: torch.Tensor, a_log: torch.Tensor, dt_bias: torch.Tensor,
             head_dim: int) -> torch.Tensor:
    """``kda_gate_plain``; on CUDA tensors one launch of the kernel
    (``launches.kda_gate``): bf16 raw, its f32 result contiguous."""
    if not raw.is_cuda:
        return kda_gate_plain(raw, a_log, dt_bias, head_dim)
    why = _rows_refusal("raw", raw, 8)
    if why is None and (raw.shape[-1] != a_log.numel() * head_dim
                        or dt_bias.numel() != raw.shape[-1]):
        why = f"raw's {raw.shape[-1]} channels are not {a_log.numel()} heads of {head_dim}"
    if why is None and head_dim % 8:
        why = f"head_dim {head_dim} is no multiple of 8"
    if why is not None:
        raise ValueError(f"kda_gate: {why}")
    b, s, c = raw.shape
    heads = a_log.numel()
    out = torch.empty((b, s, heads, head_dim), dtype=torch.float32, device=raw.device)
    a, dt = a_log.float().contiguous(), dt_bias.float().contiguous()
    lib, _, gate, _ = _elementwise_fns()
    with torch.cuda.device(raw.device):
        code = gate(raw.data_ptr(), a.data_ptr(), dt.data_ptr(), out.data_ptr(), b * s, heads,
                    head_dim, _stream(raw))
    cuda_build.check(lib, code, "kda_gate")
    count("launches.kda_gate")
    return out


def gated_rms_norm(o: torch.Tensor, gate: torch.Tensor, weight: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """``gated_rms_norm_plain``; on CUDA tensors one launch of the kernel
    (``launches.gated_rms_norm``): bf16 o and gate, heads of 128."""
    if not o.is_cuda:
        return gated_rms_norm_plain(o, gate, weight, eps)
    why = _rows_refusal("o", o, HEAD_DIM) or _rows_refusal("gate", gate, 8)
    if why is None and (o.shape[-1] != HEAD_DIM or gate.numel() != o.numel()
                        or weight.numel() != HEAD_DIM):
        why = (f"o must be (..., {HEAD_DIM}) with a gate of its size and a weight of "
               f"{HEAD_DIM}, got {tuple(o.shape)}, {tuple(gate.shape)}, {tuple(weight.shape)}")
    if why is not None:
        raise ValueError(f"gated_rms_norm: {why}")
    out = torch.empty_like(o)
    w = weight.float().contiguous()
    lib, _, _, norm = _elementwise_fns()
    with torch.cuda.device(o.device):
        code = norm(o.data_ptr(), gate.data_ptr(), w.data_ptr(), out.data_ptr(),
                    o.numel() // HEAD_DIM, eps, _stream(o))
    cuda_build.check(lib, code, "gated_rms_norm")
    count("launches.gated_rms_norm")
    return out


# ---------------------------------------------------------------------------
# the core
# ---------------------------------------------------------------------------


def _refusal(q, k, v, g, beta, lengths, lengths_host, chunk) -> Optional[str]:
    """Why the kernel does not take these arguments, or None if it does."""
    if chunk != CHUNK:
        return f"chunk {chunk}; the kernel's is {CHUNK}"
    for name, t, dtype in (("q", q, torch.bfloat16), ("k", k, torch.bfloat16),
                           ("v", v, torch.bfloat16), ("g", g, torch.float32)):
        if t.dtype != dtype:
            return f"{name} is {t.dtype}; the kernel takes {dtype}"
        if t.dim() != 4 or t.shape[-1] != HEAD_DIM or t.shape != q.shape:
            return f"{name} must be (B, S, H, {HEAD_DIM}) like q, got {tuple(t.shape)}"
        if not t.is_contiguous() or t.data_ptr() % 16 or t.device != q.device:
            return f"{name} must be contiguous, 16-byte aligned and on q's device"
    b, s, h, _ = q.shape
    if beta.dtype != torch.float32 or tuple(beta.shape) != (b, s, h) or not beta.is_contiguous():
        return f"beta must be contiguous f32 {(b, s, h)}, got {beta.dtype} {tuple(beta.shape)}"
    if (lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,)
            or not lengths.is_contiguous() or lengths.device != q.device):
        return f"lengths must be ({b},) contiguous int32 on q's device"
    if len(lengths_host) != b or any(not 0 <= n <= s for n in lengths_host):
        return f"lengths_host must be {b} lengths in [0, {s}], got {list(lengths_host)}"
    if b > 65535 or h > 65535:
        return f"at most 65535 rows and heads, got {b} and {h}"
    if q.device.type != "cuda" or beta.device != q.device:
        return f"the kernel runs on cuda, not {q.device}"
    return None


@functools.lru_cache(maxsize=None)
def _kda_fn():
    lib = cuda_build.load("kda")
    fn = lib.mmee_kda
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def kda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, beta: torch.Tensor,
        lengths: torch.Tensor, lengths_host: Sequence[int], chunk: int = CHUNK) -> torch.Tensor:
    """(B, S, H, Dv) in v's dtype. ``lengths`` on the tensors' device, which
    the kernels read; ``lengths_host`` the same on the host, from which the
    launches and the scratch of the rows' real chunks are sized."""
    if not q.is_cuda:
        return kda_chunked_plain(q, k, v, g, beta, lengths, chunk)
    why = _refusal(q, k, v, g, beta, lengths, lengths_host, chunk)
    if why is not None:
        raise ValueError(f"kda: {why}")
    b, s, h, _ = q.shape
    chunks = [-(-int(n) // CHUNK) for n in lengths_host]
    out = torch.empty_like(v)
    scratch = torch.empty((max(sum(chunks), 1), h, 2, CHUNK, CHUNK), dtype=torch.float32,
                          device=q.device)
    lib, fn = _kda_fn()
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), beta.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, s, h, max(chunks),
                  _stream(q))
    cuda_build.check(lib, code, "kda")
    count("launches.kda", 2 if max(chunks) else 1)
    return out
