"""PyTorch port, the residual add and LayerNorm of the no-grad path.

``layer_norm(x, w, b, eps, residual=r)`` is ``layer_norm(x + r, w, b,
eps)``: on the CPU and under autograd composed of torch ops as before (the
two-pass chain, or ``_LayerNormCore``), on every CUDA tensor outside
autograd by the hand-written ``add_layer_norm`` kernel (strided or
misaligned rows copied dense first; what the kernel does not build raises).
Each call's rows count as fused or composed. The tests marked ``cuda`` need an sm_90 card and skip
elsewhere: on the card, ``python -m pytest tests/test_torch_layer_norm.py -q
--noconftest``. This file imports no JAX.
"""

import re

import pytest
import torch

from multi_modal_early_exit_tpu_torch.models.layoutlmv2.config import LayoutLMv2Config
from multi_modal_early_exit_tpu_torch.models.layoutlmv3 import modeling as TM
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import LayoutLMv3Config
from multi_modal_early_exit_tpu_torch.ops import cuda_build
from multi_modal_early_exit_tpu_torch.ops import layer_norm as aln
from multi_modal_early_exit_tpu_torch.utils.profiling import counters, launch_counts

FUSED, COMPOSED = "layer_norm.fused_rows", "layer_norm.composed_rows"


def _inputs(shape, dtype, seed=0, device="cpu", param_dtype=None):
    """x with a nonzero mean, a residual, a weight near 1 and a bias."""
    g = torch.Generator().manual_seed(seed)
    h = shape[-1]
    x = torch.randn(shape, generator=g) * 2.0 + 0.5
    r = torch.randn(shape, generator=g)
    w = 1.0 + 0.1 * torch.randn(h, generator=g)
    b = 0.1 * torch.randn(h, generator=g)
    pd = param_dtype or dtype
    return (x.to(device, dtype), r.to(device, dtype), w.to(device, pd), b.to(device, pd))


def _composed(x, w, b, eps):
    """The no-grad chain as the port composed it before the kernel."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def _delta(before):
    now = counters()
    return {k: now.get(k, 0) - before.get(k, 0) for k in (FUSED, COMPOSED)}


def kernel_launches() -> int:
    """``add_layer_norm``'s launches in this process so far."""
    return launch_counts().get("add_layer_norm", 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_residual_is_added_first_bit_for_bit(dtype):
    x, r, w, b = _inputs((3, 7, 64), dtype)
    got = TM.layer_norm(x, w, b, 1e-5, residual=r)
    assert torch.equal(got, TM.layer_norm(x + r, w, b, 1e-5))
    assert torch.equal(got, _composed(x + r, w, b, 1e-5))
    assert torch.equal(TM.layer_norm(x, w, b, 1e-5), _composed(x, w, b, 1e-5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_takes_the_core_on_the_sum(dtype):
    """Under autograd the sum goes to ``_LayerNormCore``, whose gradients
    are those of the unfused form, bit for bit."""
    x, r, w, b = _inputs((2, 5, 64), dtype)
    w32, b32 = w.float().requires_grad_(), b.float().requires_grad_()
    xs = [x.clone().requires_grad_(), r.clone().requires_grad_()]
    ys = [x.clone().requires_grad_(), r.clone().requires_grad_()]
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    got = TM.layer_norm(xs[0], w32, b32, 1e-6, residual=xs[1])
    want = TM._LayerNormCore.apply(ys[0] + ys[1], w32, b32, 1e-6)
    assert got.grad_fn is not None and torch.equal(got, want)
    got_grads = torch.autograd.grad(got, xs + [w32, b32], g)
    want_grads = torch.autograd.grad(want, ys + [w32, b32], g)
    for a, c in zip(got_grads, want_grads):
        assert torch.equal(a, c)


def test_the_counters_add_each_calls_rows(monkeypatch):
    x, r, w, b = _inputs((3, 5, 64), torch.float32)
    before = counters()
    TM.layer_norm(x, w, b, 1e-5, residual=r)                    # CPU: composed
    TM.layer_norm(x.requires_grad_(), w, b, 1e-5)               # autograd: composed
    assert _delta(before) == {FUSED: 0, COMPOSED: 30}
    # where the kernel runs, the rows count as fused
    monkeypatch.setattr(aln, "on_card", lambda x: True)
    monkeypatch.setattr(aln, "add_layer_norm", aln.add_layer_norm_plain)
    before = counters()
    with torch.no_grad():
        TM.layer_norm(x, w, b, 1e-5, residual=r)
        TM.LayerNorm(64, 1e-5).to(torch.float32).forward(x[:2])
    assert _delta(before) == {FUSED: 25, COMPOSED: 0}


def _bad_inputs(case):
    x, r, w, b = _inputs((2, 4, 768), torch.bfloat16)
    if case == "cpu":
        return (x, w, b, r), "cuda"
    if case == "non-contiguous":
        return (x.transpose(0, 1), w, b, None), "contiguous"
    if case == "fp16":
        return (x.half(), w, b, r.half()), "float16"
    if case == "width":
        x, r, w, b = _inputs((2, 4, 96), torch.bfloat16)
        return (x, w, b, r), "width 96"
    if case == "residual":
        return (x, w, b, r.float()), "residual"
    if case == "parameters":
        x, r, w, b = _inputs((2, 4, 768), torch.bfloat16, param_dtype=torch.float32)
        return (x, w, b, r), "weight"
    raise AssertionError(case)


CASES = ["cpu", "non-contiguous", "fp16", "width", "residual", "parameters"]


@pytest.mark.parametrize("case", CASES)
def test_the_wrapper_raises_on_what_the_kernel_does_not_take(case):
    (x, w, b, r), why = _bad_inputs(case)
    with pytest.raises(ValueError, match=why):
        aln.add_layer_norm(x, w, b, 1e-5, residual=r)


def _strided(case, x, r):
    """x and r with one of them strided or misaligned, the same values."""
    if case == "strided residual":
        return x, r.transpose(0, 1).contiguous().transpose(0, 1)
    if case == "strided x":
        return x.transpose(0, 1).contiguous().transpose(0, 1), r
    if case == "misaligned x":
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        moved = flat[1:].view(x.shape)
        moved.copy_(x)
        return moved, r
    raise AssertionError(case)


STRIDED = ["strided residual", "strided x", "misaligned x"]


@pytest.mark.parametrize("case", STRIDED)
def test_the_no_grad_path_hands_the_kernel_dense_rows(monkeypatch, case):
    """Where the kernel runs, a strided or misaligned x or residual reaches
    it as a contiguous, 16-byte aligned copy of the same values."""
    x, r, w, b = _inputs((4, 6, 64), torch.bfloat16)
    xs, rs = _strided(case, x, r)
    assert not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (xs, rs))
    seen = []

    def kernel(x, w, b, eps, residual=None):
        seen.append((x, residual))
        return aln.add_layer_norm_plain(x, w, b, eps, residual)

    monkeypatch.setattr(aln, "on_card", lambda x: True)
    monkeypatch.setattr(aln, "add_layer_norm", kernel)
    with torch.no_grad():
        got = TM.layer_norm(xs, w, b, 1e-5, residual=rs)
    (kx, kr), = seen
    for t in (kx, kr):
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
    assert torch.equal(kx, x) and torch.equal(kr, r)
    assert torch.equal(got, _composed(x + r, w, b, 1e-5))


def test_the_widths_are_the_configurations_and_the_kernels():
    """Every hidden size of the repository's configurations (tiny, base,
    large, the wide-head test widths 384 and 512) takes the kernel, and
    ``WIDTHS`` are the kernel's cases."""
    used = {LayoutLMv3Config.tiny().hidden_size, LayoutLMv3Config.base().hidden_size,
            LayoutLMv2Config().hidden_size, LayoutLMv2Config.tiny().hidden_size, 384, 512, 1024}
    assert used <= aln.WIDTHS
    text = (cuda_build.CSRC / "add_layer_norm.cu").read_text()
    assert {int(c) for c in re.findall(r"case (\d+): return launch<", text)} == aln.WIDTHS
    assert "add_layer_norm" in cuda_build.SOURCES


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) CUDA device")
    return torch.device("cuda")


def bf16_ulps(got, want):
    """|got - want| in bf16 ulps of want, each element's ulp taken at its
    magnitude but not below 1/256 of the tensor's largest (where the f32
    chain's own rounding, not the output's, sets the error)."""
    w, g = want.float(), got.float()
    mag = torch.clamp(w.abs(), min=w.abs().max().item() / 256)
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


# (B, S, H): served b64 (49,152 rows of 768), b16, the harvest's 561
# tokens, width 1024, and the small widths
SHAPES = [(64, 768, 768), (16, 768, 768), (64, 561, 768), (8, 512, 1024),
          (4, 37, 64), (2, 50, 384), (3, 41, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("eps", [1e-5, 1e-6, 1e-12])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_the_composed_chain(cuda, shape, eps, residual, dtype):
    x, r, w, b = _inputs(shape, dtype, seed=sum(shape), device=cuda)
    r = r if residual else None
    before = kernel_launches()
    got = aln.add_layer_norm(x, w, b, eps, residual=r)
    want = aln.add_layer_norm_plain(x, w, b, eps, residual=r)
    torch.cuda.synchronize()
    assert kernel_launches() == before + 1
    assert got.shape == x.shape and got.dtype == dtype and torch.isfinite(got).all()
    if dtype == torch.bfloat16:
        ulps = bf16_ulps(got, want)
        assert (ulps <= 1).float().mean().item() >= 0.999, (ulps <= 1).float().mean().item()
        assert ulps.max().item() <= 2, ulps.max().item()
    else:
        err = (got - want).abs().max() / want.abs().max()
        assert err.item() <= 1e-5, err.item()


@pytest.mark.cuda
def test_layer_norm_runs_the_kernel_without_autograd(cuda):
    x, r, w, b = _inputs((4, 100, 768), torch.bfloat16, device=cuda)
    before, launches = counters(), kernel_launches()
    with torch.no_grad():
        got = TM.layer_norm(x, w, b, 1e-5, residual=r)
    assert kernel_launches() == launches + 1
    assert _delta(before) == {FUSED: 400, COMPOSED: 0}
    assert bf16_ulps(got, aln.add_layer_norm_plain(x, w, b, 1e-5, r)).max().item() <= 2
    before = counters()
    trained = TM.layer_norm(x, w.clone().requires_grad_(), b, 1e-5, residual=r)
    assert kernel_launches() == launches + 1 and trained.grad_fn is not None
    assert _delta(before) == {FUSED: 0, COMPOSED: 400}


@pytest.mark.cuda
@pytest.mark.parametrize("case", STRIDED)
def test_layer_norm_runs_the_kernel_on_strided_rows(cuda, case):
    """A strided or misaligned x or residual still launches the kernel."""
    x, r, w, b = _inputs((4, 100, 768), torch.bfloat16, device=cuda)
    xs, rs = _strided(case, x, r)
    before, launches = counters(), kernel_launches()
    with torch.no_grad():
        got = TM.layer_norm(xs, w, b, 1e-5, residual=rs)
    assert kernel_launches() == launches + 1
    assert _delta(before) == {FUSED: 400, COMPOSED: 0}
    assert torch.equal(got, aln.add_layer_norm(x, w, b, 1e-5, residual=r))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fp16", "width", "residual", "parameters"])
def test_layer_norm_raises_on_card_inputs_the_kernel_does_not_build(cuda, case):
    """On the card outside autograd there is no composed fallback: what the
    kernel does not build raises."""
    (x, w, b, r), why = _bad_inputs(case)
    x, w, b, r = (t.to(cuda) for t in (x, w, b, r))
    with torch.no_grad(), pytest.raises(ValueError, match=why):
        TM.layer_norm(x, w, b, 1e-5, residual=r)
