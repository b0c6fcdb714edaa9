"""PyTorch port, the core of Kimi Delta Attention (``ops/kda.py``): the gated
delta rule with a per-channel forget gate, chunked.

On the CPU ``kda`` is ``kda_chunked_plain``, held here to a token-by-token
recurrence in f64 at forget gates from -1e-4 to -20 a token (decays that
pass f32's range within one chunk), at chunk sizes that do and do not
divide the rows, with padding that never reaches a real position. On CUDA
tensors it launches the kernels of ``csrc/kda.cu`` or raises; its argument
checks (``_refusal``) are plain Python and run here. The tests marked
``cuda`` need an sm_90 card and skip elsewhere: on the card, ``python -m
pytest tests/test_torch_kda.py -q --noconftest``. This file imports no JAX.
"""

import pytest
import torch
import torch.nn.functional as F

from multi_modal_early_exit_tpu_torch.ops import kda as kd
from multi_modal_early_exit_tpu_torch.utils.profiling import launch_counts


def recurrence(q, k, v, g, beta, lengths):
    """S_t = (I - beta k k^T) Diag(e^g) S_{t-1} + beta k v^T, o_t = S_t^T q_t,
    token by token in f64; zeros past each row's length."""
    b, s, h, d = k.shape
    out = torch.zeros(b, s, h, v.shape[-1], dtype=torch.float64)
    for r in range(b):
        for j in range(h):
            state = torch.zeros(d, v.shape[-1], dtype=torch.float64)
            for t in range(int(lengths[r])):
                kt, vt, qt = (x[r, t, j].double() for x in (k, v, q))
                bt = beta[r, t, j].double()
                state = torch.exp(g[r, t, j].double())[:, None] * state
                state = state + bt * torch.outer(kt, vt - state.T @ kt)
                out[r, t, j] = state.T @ qt
    return out


def inputs(b, s, h, d, gate, seed=0, device="cpu", dtype=torch.float32):
    """q and k unit per head (q times d^-1/2, as the layer scales it), v
    normal, g uniform on ``gate`` (a log forget gate a token), beta in (0,
    1)."""
    gen = torch.Generator().manual_seed(seed)
    q = F.normalize(torch.randn(b, s, h, d, generator=gen), dim=-1) * d ** -0.5
    k = F.normalize(torch.randn(b, s, h, d, generator=gen), dim=-1)
    v = torch.randn(b, s, h, d, generator=gen)
    lo, hi = gate
    g = lo + (hi - lo) * torch.rand(b, s, h, d, generator=gen)
    beta = torch.rand(b, s, h, generator=gen)
    cast = [t.to(device, dtype) for t in (q, k, v)]
    return (*cast, g.to(device), beta.to(device))


GATES = {"slow": (-1e-4, -1e-5), "served": (-1.6, -1e-3), "strong": (-20.0, -5.0)}


@pytest.mark.parametrize("gate", list(GATES))
@pytest.mark.parametrize("chunk", [4, 16])
def test_plain_is_the_token_recurrence(gate, chunk):
    """f32 against f64: the chunked form's sums in another order, each
    output within 1e-5 of its scale, whatever the decay."""
    q, k, v, g, beta = inputs(3, 37, 2, 8, GATES[gate], seed=chunk)
    lengths = torch.tensor([37, 20, 5])
    want = recurrence(q, k, v, g, beta, lengths)
    got = kd.kda_chunked_plain(q, k, v, g, beta, lengths, chunk)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got.double() - want).abs().max() <= 1e-5 * want.abs().max()


# ---------------------------------------------------------------------------
# the kernel's algebra, mirrored in f64 (csrc/kda.cu's note)
# ---------------------------------------------------------------------------

SUB = 16  # the intra kernel's sub-chunk


def chunk_pieces(q, k, v, g, beta, length, chunk=64):
    """Row 0, head 0 of the inputs cut into chunks of ``chunk`` as the kernels
    see them: f64, zeros at and past ``length``."""
    out = []
    for t0 in range(0, length, chunk):
        n = min(chunk, length - t0)
        pieces = []
        for x in (q, k, v, g):
            y = torch.zeros(chunk, x.shape[-1], dtype=torch.float64)
            y[:n] = x[0, t0:t0 + n, 0].double()
            pieces.append(y)
        b = torch.zeros(chunk, dtype=torch.float64)
        b[:n] = beta[0, t0:t0 + n, 0].double()
        out.append((*pieces, b))
    return out


def pairwise_form(q, k, g, beta):
    """A, Qt and T of one chunk from differences of running sums, pair by
    pair (as ``kda_chunked_plain`` forms them), T by a triangular solve."""
    c = k.shape[0]
    gam = g.cumsum(0)
    diff = gam[:, None, :] - gam[None, :, :]
    lower = torch.ones(c, c, dtype=torch.bool).tril()
    decay = torch.where(lower[:, :, None], diff, float("-inf")).exp()
    a = torch.einsum("rc,ic,ric->ri", k, k, decay).tril(-1)
    qt = torch.einsum("rc,ic,ric->ri", q, k, decay)
    eye = torch.eye(c, dtype=torch.float64)
    t = torch.linalg.solve_triangular(eye + beta[:, None] * a, torch.diag(beta), upper=False)
    return a, qt, t


def blocked_form(q, k, g, beta, sub=SUB):
    """The intra kernel's form: sub-chunks of ``sub`` rows, the diagonal blocks
    pairwise from differences of running sums, each block below through its
    column block's last row b, (K_I e^{Gamma_I - Gamma_b}) (K_J e^{Gamma_b -
    Gamma_J})^T, T by blocked forward substitution, and P = Qt T. Also every
    exponent it forms."""
    c = k.shape[0]
    gam = g.cumsum(0)
    a = torch.zeros(c, c, dtype=torch.float64)
    qt = torch.zeros(c, c, dtype=torch.float64)
    exps = []
    blocks = c // sub
    for bi in range(blocks):
        rows = slice(bi * sub, (bi + 1) * sub)
        diff = gam[rows, None, :] - gam[None, rows, :]
        lower = torch.ones(sub, sub, dtype=torch.bool).tril()
        exps.append(diff[lower])
        decay = torch.where(lower[:, :, None], diff, float("-inf")).exp()
        a[rows, rows] = torch.einsum("rc,ic,ric->ri", k[rows], k[rows], decay).tril(-1)
        qt[rows, rows] = torch.einsum("rc,ic,ric->ri", q[rows], k[rows], decay)
        for bj in range(bi):
            cols, b = slice(bj * sub, (bj + 1) * sub), (bj + 1) * sub - 1
            e_row, e_col = gam[rows] - gam[b], gam[b] - gam[cols]
            exps += [e_row, e_col]
            kj = k[cols] * e_col.exp()
            a[rows, cols] = (k[rows] * e_row.exp()) @ kj.T
            qt[rows, cols] = (q[rows] * e_row.exp()) @ kj.T
    t = torch.zeros(c, c, dtype=torch.float64)
    for bi in range(blocks):  # the diagonal blocks, row by row
        o = bi * sub
        for r in range(sub):
            e = torch.zeros(sub, dtype=torch.float64)
            e[r] = 1.0
            t[o + r, o:o + sub] = beta[o + r] * (e - a[o + r, o:o + r] @ t[o:o + r, o:o + sub])
    for lv in range(1, blocks):  # one diagonal of blocks at a time
        for bi in range(lv, blocks):
            bj = bi - lv
            rows, cols = slice(bi * sub, (bi + 1) * sub), slice(bj * sub, (bj + 1) * sub)
            x = a[rows, bj * sub:bi * sub] @ t[bj * sub:bi * sub, cols]
            t[rows, cols] = -t[rows, rows] @ x
    return a, qt, t, qt @ t, torch.cat([e.reshape(-1) for e in exps])


@pytest.mark.parametrize("gate", list(GATES))
def test_the_blocked_intra_form_is_the_pairwise_form(gate):
    """The intra kernel's sub-chunk form in f64 against the pairwise form, at
    chunk 64 over a row whose last chunk is short: A, Qt and T within 1e-10
    of their scale, every value finite, no exponent above 0."""
    q, k, v, g, beta = inputs(1, 100, 1, 16, GATES[gate], seed=11)
    for qc, kc, _, gc, bc in chunk_pieces(q, k, v, g, beta, 100):
        want = pairwise_form(qc, kc, gc, bc)
        *got, p, exps = blocked_form(qc, kc, gc, bc)
        assert (exps <= 0).all()
        for x, y in zip(got, want):
            assert torch.isfinite(x).all()
            assert (x - y).abs().max() <= 1e-10 * max(y.abs().max().item(), 1e-300)
        assert torch.equal(p, got[1] @ got[2])


@pytest.mark.parametrize("gate", list(GATES))
def test_the_state_pass_on_p_is_the_token_recurrence(gate):
    """The state kernel's pass in f64 on the intra kernel's T and P = Qt T:
    X = V - (K e^Gamma) S, Delta = T X, O = (Q e^Gamma) S + P X, S <-
    Diag(e^{Gamma_C}) S + (K e^{Gamma_C - Gamma})^T Delta, against the token
    recurrence, each output within 1e-10 of the scale."""
    length = 150
    q, k, v, g, beta = inputs(1, length, 1, 16, GATES[gate], seed=12)
    want = recurrence(q, k, v, g, beta, torch.tensor([length]))[0, :, 0]
    state = torch.zeros(16, 16, dtype=torch.float64)
    out = []
    for qc, kc, vc, gc, bc in chunk_pieces(q, k, v, g, beta, length):
        _, _, t, p, _ = blocked_form(qc, kc, gc, bc)
        gam = gc.cumsum(0)
        x = vc - (kc * gam.exp()) @ state
        out.append((qc * gam.exp()) @ state + p @ x)
        last = gam[-1:]
        state = last.exp().T * state + (kc * (last - gam).exp()).T @ (t @ x)
    got = torch.cat(out)[:length]
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-10 * want.abs().max()


def test_padding_never_reaches_a_real_position():
    q, k, v, g, beta = inputs(2, 23, 2, 8, GATES["served"], seed=3)
    lengths = torch.tensor([23, 9])
    a = kd.kda(q, k, v, g, beta, lengths, [23, 9], chunk=8)
    noise = [t.clone() for t in (q, k, v, g, beta)]
    for t in noise:
        t[1, 9:] = torch.randn(t[1, 9:].shape) * 100
    b = kd.kda(*noise, lengths, [23, 9], chunk=8)
    assert torch.equal(a, b)
    assert not a[1, 9:].any()


def _refusal(case):
    q, k, v, g, beta = inputs(2, 128, 2, 128, GATES["served"], dtype=torch.bfloat16)
    lengths, host = torch.tensor([128, 70], dtype=torch.int32), [128, 70]
    args = {"q": q, "k": k, "v": v, "g": g, "beta": beta, "lengths": lengths,
            "lengths_host": host, "chunk": 64}
    if case == "dtype":
        args["q"] = q.float()
    elif case == "head dim":
        args.update(q=q[..., :64], k=k[..., :64], v=v[..., :64], g=g[..., :64])
    elif case == "strided":
        args["k"] = k.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "gate dtype":
        args["g"] = g.bfloat16()
    elif case == "chunk":
        args["chunk"] = 32
    elif case == "lengths":
        args["lengths_host"] = [129, 70]
    elif case == "cpu":
        pass
    return args


@pytest.mark.parametrize("case, why", [
    ("dtype", "q is torch.float32"), ("head dim", "128"), ("strided", "contiguous"),
    ("gate dtype", "g is torch.bfloat16"), ("chunk", "chunk 32"), ("lengths", "lengths_host"),
    ("cpu", "cuda")])
def test_the_kernel_refuses_what_it_does_not_take(case, why):
    args = _refusal(case)
    found = kd._refusal(*(args[n] for n in ("q", "k", "v", "g", "beta", "lengths",
                                             "lengths_host", "chunk")))
    assert found is not None and why in found


def test_the_elementwise_plain_versions():
    """The convolution against its definition (a loop over the taps), q's
    and k's norm, the forget gate and the gated output norm."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 11, 32, generator=gen)
    w = torch.randn(32, 1, 4, generator=gen)
    want = torch.zeros_like(x)
    for j in range(4):
        back = 3 - j
        want[:, back:] += w[:, 0, j] * x[:, :11 - back]
    want = F.silu(want)
    torch.testing.assert_close(kd.short_conv_plain(x, w, None, 16), want)
    normed = kd.short_conv_plain(x, w, 0.25, 16).view(2, 11, 2, 16)
    torch.testing.assert_close(normed.norm(dim=-1), torch.full((2, 11, 2), 0.25), atol=1e-5,
                               rtol=1e-5)
    raw, a_log, dt = (torch.randn(2, 11, 32, generator=gen), torch.randn(2, generator=gen),
                      torch.randn(32, generator=gen))
    g = kd.kda_gate_plain(raw, a_log, dt, 16)
    torch.testing.assert_close(
        g, -a_log.exp()[:, None] * torch.log1p(torch.exp((raw + dt).view(2, 11, 2, 16))))
    o, gate, wt = (torch.randn(2, 11, 2, 16, generator=gen), torch.randn(2, 11, 32, generator=gen),
                   torch.randn(16, generator=gen))
    rms = o.pow(2).mean(-1, keepdim=True).add(1e-5).sqrt()
    torch.testing.assert_close(kd.gated_rms_norm_plain(o, gate, wt, 1e-5),
                               o / rms * wt * torch.sigmoid(gate.view(2, 11, 2, 16)))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) CUDA device")
    return torch.device("cuda")


# the kernel's bf16 output against the plain version's on the same bf16
# inputs, the largest error over the output's largest value: both round
# once to bf16 (half an ulp, 2^-9 of a value); the kernel's state products
# take tf32 operands (2^-11 of a value each) and its exponentials are
# ex2.approx's. On an H100 the kernel read 3.8e-3 to 5.8e-3 of scale against
# the plain version at the served shape (phase 3 and 4k of chip_smoke.py);
# the reference's float8 control reads 0.10 against the f32 core
CARD_TOL = 1.2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape, lengths", [
    ((1, 64, 1), [64]), ((2, 200, 3), [200, 1]), ((3, 513, 2), [0, 513, 130]),
    ((4, 16384, 32), [16384, 4096, 9000, 6001])])
@pytest.mark.parametrize("gate", list(GATES))
def test_the_kernel_is_the_plain_version_on_the_card(cuda, shape, lengths, gate):
    b, s, h = shape
    q, k, v, g, beta = inputs(b, s, h, 128, GATES[gate], seed=s, device=cuda,
                              dtype=torch.bfloat16)
    dev = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = launch_counts().get("kda", 0)
    got = kd.kda(q, k, v, g, beta, dev, lengths)
    torch.cuda.synchronize()
    assert launch_counts()["kda"] == before + (2 if max(lengths) else 1)
    want = kd.kda_chunked_plain(q, k, v, g, beta, dev, kd.CHUNK)
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item() / max(scale, 1e-30)
    assert err <= CARD_TOL, err
    for r, n in enumerate(lengths):
        assert not got[r, n:].any()
    assert torch.equal(got, kd.kda(q, k, v, g, beta, dev, lengths))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dtype", "head dim", "strided", "chunk"])
def test_the_card_raises_on_what_the_kernel_does_not_take(cuda, case):
    args = _refusal(case)
    args.update({n: t.to(cuda) for n, t in args.items() if torch.is_tensor(t)})
    with pytest.raises(ValueError, match="kda"):
        kd.kda(**args)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [None, 1.0, 128 ** -0.5], ids=["v", "k", "q"])
def test_the_short_conv_kernel_is_its_plain_version(cuda, scale):
    """bf16 in and out, f32 arithmetic in both: within one bf16 rounding
    (2^-8 of each output's scale) of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(3, 777, 4096, generator=gen, device=cuda).bfloat16()
    w = torch.empty(4096, 1, 4, device=cuda).uniform_(-0.5, 0.5, generator=gen).bfloat16()
    before = launch_counts().get("short_conv", 0)
    got = kd.short_conv(x, w, scale)
    torch.cuda.synchronize()
    assert launch_counts()["short_conv"] == before + 1
    want = kd.short_conv_plain(x, w, scale)
    assert got.is_contiguous() and got.dtype == torch.bfloat16
    err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    assert err <= 2 ** -8, err


@pytest.mark.cuda
def test_the_gate_and_norm_kernels_are_their_plain_versions(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    raw = torch.randn(2, 999, 4096, generator=gen, device=cuda).mul_(3).bfloat16()
    a_log = torch.empty(32, device=cuda).uniform_(1, 16, generator=gen).log_().bfloat16()
    dt = torch.randn(4096, generator=gen, device=cuda).mul_(4).bfloat16()
    got = kd.kda_gate(raw, a_log, dt, 128)
    want = kd.kda_gate_plain(raw, a_log, dt, 128)
    assert got.dtype == torch.float32 and got.shape == (2, 999, 32, 128)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    o = torch.randn(2, 999, 32, 128, generator=gen, device=cuda).bfloat16()
    gate = torch.randn(2, 999, 4096, generator=gen, device=cuda).bfloat16()
    w = torch.randn(128, generator=gen, device=cuda).bfloat16()
    got = kd.gated_rms_norm(o, gate, w, 1e-5)
    want = kd.gated_rms_norm_plain(o, gate, w, 1e-5)
    err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    assert err <= 2 ** -8, err
