"""PyTorch port, the expert layer's work on either side of its down product
(``ops/moe_pairs.py``): ``swiglu_weigh`` (SiLU, the product with up and the
routing weight, one rounding; the inverse permutation of the pairs' sort)
and ``combine_pairs`` (the pairs back in token order, summed in f32).

On the CPU and under autograd ``models/moonlight/modeling.py`` keeps the
composed chains, bit for bit as they were before the kernels
(``swiglu_weigh_plain``, ``combine_pairs_plain``); on every CUDA tensor
outside autograd it runs the kernels, and what they do not take raises.
The tests read which path each call took, and over how many rows, from
the calls the layer makes into ``ops.moe_pairs``. The tests marked
``cuda`` need an sm_90 card and skip elsewhere: on the card, ``python -m
pytest tests/test_torch_moe_pairs.py -q --noconftest``. This file imports
no JAX.
"""

import copy
import re

import pytest
import torch
import torch.nn.functional as F

from multi_modal_early_exit_tpu_torch.models.moonlight import modeling
from multi_modal_early_exit_tpu_torch.models.moonlight.config import MoonlightConfig
from multi_modal_early_exit_tpu_torch.ops import cuda_build
from multi_modal_early_exit_tpu_torch.ops import moe_pairs as mp
from multi_modal_early_exit_tpu_torch.ops.grouped_mm import grouped_mm
from multi_modal_early_exit_tpu_torch.utils.profiling import launch_counts

FUSED, COMPOSED = "swiglu_weigh", "swiglu_weigh_plain"
TYPES = [torch.bfloat16, torch.float32]


def _record(monkeypatch):
    """A list of (function, rows) for every call the expert layer makes
    into ``ops.moe_pairs``, in order: the path each MLP call took (kernels
    or composed chains) and its rows (tokens, or token-expert pairs)."""
    calls = []
    for name in (FUSED, COMPOSED, "combine_pairs", "combine_pairs_plain"):
        def recorded(rows, *args, _name=name, _fn=getattr(mp, name), **kwargs):
            calls.append((_name, rows.shape[0]))
            return _fn(rows, *args, **kwargs)

        monkeypatch.setattr(mp, name, recorded)
    return calls


def _rows(calls):
    """The SwiGLU rows each path ran: {kernel: rows, composed chain: rows}."""
    return {path: sum(n for name, n in calls if name == path) for path in (FUSED, COMPOSED)}


# ---------------------------------------------------------------------------
# the expert layer as it was composed before the kernels
# ---------------------------------------------------------------------------


def parent_mlp_apply(p, x):
    gate, up = p.gate_up_proj(x).chunk(2, dim=-1)
    return p.down_proj(F.silu(gate) * up)


def parent_experts_apply(p, x, chosen, weights):
    t, k = chosen.shape
    flat = chosen.reshape(-1)
    order = torch.argsort(flat, stable=True)
    experts = torch.arange(p.gate_up_proj.shape[0], device=flat.device)
    offs = torch.searchsorted(flat[order], experts, right=True).to(torch.int32)
    gate_up = grouped_mm(x[order // k], p.gate_up_proj, offs)
    gate, up = gate_up.chunk(2, dim=-1)
    act = F.silu(gate).mul_(up).mul_(weights.reshape(-1)[order, None].to(x.dtype))
    out_sorted = grouped_mm(act, p.down_proj, offs)
    out = torch.empty_like(out_sorted).index_copy_(0, order, out_sorted)
    return out.view(t, k, -1).sum(dim=1, dtype=torch.float32)


def parent_moe_apply(p, cfg, x):
    chosen, weights = modeling.route(p.gate, cfg, x)
    y = parent_experts_apply(p.experts, x, chosen, weights).to(x.dtype)
    return y + parent_mlp_apply(p.shared_experts, x)


def moe_layer(dtype, seed=3, cfg=None, device="cpu"):
    """A tiny expert layer with weights of about unit output scale, and 50
    tokens."""
    cfg = cfg or MoonlightConfig.tiny()
    g = torch.Generator().manual_seed(seed)
    moe = modeling.MoE(cfg)
    with torch.no_grad():
        for p in moe.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
        moe.gate.weight.mul_(5.0)
    x = torch.randn(50, cfg.hidden_size, generator=g)
    return cfg, moe.to(device, dtype), x.to(device, dtype)


def _pairs(t, k, h, dtype, seed=0, device="cpu"):
    """(pairs (t k, h), order: a random permutation of the pairs)."""
    g = torch.Generator().manual_seed(seed)
    pairs = torch.randn(t * k, h, generator=g).to(device, dtype)
    return pairs, torch.randperm(t * k, generator=g).to(device)


def inverse(order):
    inv = torch.empty(order.numel(), dtype=torch.int32, device=order.device)
    inv[order] = torch.arange(order.numel(), dtype=torch.int32, device=order.device)
    return inv


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("weighted", [True, False], ids=["routed", "dense"])
def test_plain_versions_are_the_composed_chains(dtype, weighted):
    g = torch.Generator().manual_seed(1)
    gate_up = torch.randn(21, 2 * 24, generator=g).to(dtype)
    gate, up = gate_up.chunk(2, dim=-1)
    if weighted:
        weights = torch.rand(7, 3, generator=g)
        order = torch.randperm(21, generator=g)
        want = F.silu(gate).mul_(up).mul_(weights.reshape(-1)[order, None].to(dtype))
        assert torch.equal(mp.swiglu_weigh_plain(gate_up, weights, order), want)
    else:
        assert torch.equal(mp.swiglu_weigh_plain(gate_up), F.silu(gate) * up)
    pairs, order = _pairs(7, 3, 24, dtype)
    out = torch.empty_like(pairs).index_copy_(0, order, pairs)
    want = out.view(7, 3, -1).sum(dim=1, dtype=torch.float32).to(dtype)
    assert torch.equal(mp.combine_pairs_plain(pairs, order, 3), want)


def test_plain_versions_count_rows_past_held_as_zero():
    """With ``held`` the routed activation's rows from it on are zero
    (whatever the product left there), and the pairs' sum counts them as
    zero."""
    g = torch.Generator().manual_seed(4)
    gate_up = torch.randn(21, 2 * 24, generator=g)
    gate_up[13:] = float("nan")  # rows no product wrote
    weights, order = torch.rand(7, 3, generator=g), torch.randperm(21, generator=g)
    held = torch.tensor([13], dtype=torch.int32)
    act = mp.swiglu_weigh_plain(gate_up, weights, order, held)
    assert torch.equal(act[:13], mp.swiglu_weigh_plain(gate_up[:13], weights, order[:13]))
    assert not act[13:].any()
    pairs, porder = _pairs(7, 3, 24, torch.float32)
    pairs[13:] = float("nan")
    got = mp.combine_pairs_plain(pairs, porder, 3, torch.tensor([13], dtype=torch.int32))
    zeroed = torch.where(torch.arange(21)[:, None] < 13, pairs, 0.0)
    assert torch.equal(got, mp.combine_pairs_plain(zeroed, porder, 3))


@pytest.mark.parametrize("dtype", TYPES)
def test_the_cpu_expert_layer_is_the_parents_bit_for_bit(dtype, monkeypatch):
    cfg, moe, x = moe_layer(dtype)
    calls = _record(monkeypatch)
    with torch.no_grad():
        got = modeling.moe_apply(moe, cfg, x)
        want = parent_moe_apply(moe, cfg, x)
        chosen, weights = modeling.route(moe.gate, cfg, x)
        routed = modeling.experts_apply(moe.experts, x, chosen, weights)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(routed, parent_experts_apply(moe.experts, x, chosen, weights).to(dtype))
    pairs = 2 * 50 * cfg.num_experts_per_tok  # the routed calls'
    assert _rows(calls) == {FUSED: 0, COMPOSED: pairs + 50}


def test_autograd_keeps_the_composed_chain_and_its_gradients(monkeypatch):
    """Under autograd the values and every gradient are the parent's, bit
    for bit, and every row runs the composed chains."""
    cfg, moe, x = moe_layer(torch.float32, seed=5)
    x = x.requires_grad_()
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    calls = _record(monkeypatch)
    got = modeling.moe_apply(moe, cfg, x)
    assert _rows(calls) == {FUSED: 0, COMPOSED: 50 * cfg.num_experts_per_tok + 50}
    want = parent_moe_apply(moe, cfg, x)
    assert torch.equal(got, want)
    params = [x] + list(moe.parameters())
    used = [p for p in params if p is not moe.gate.e_score_correction_bias]
    for a, b in zip(torch.autograd.grad(got, used, g), torch.autograd.grad(want, used, g)):
        assert torch.equal(a, b)


def _fake_kernels(monkeypatch, seen):
    """The kernels' contract on the CPU: swiglu_weigh returns the plain
    activation and the inverse permutation, combine_pairs gathers by it. A
    layer that holds every expert hands them no ``held`` count."""
    plain = mp.swiglu_weigh_plain

    def swiglu_weigh(gate_up, weights=None, order=None, held=None):
        assert held is None
        seen.append(("swiglu_weigh", weights is not None))
        act = plain(gate_up, weights, order)
        return act, None if order is None else inverse(order)

    def combine_pairs(pairs, inv, k, held=None):
        assert held is None
        seen.append(("combine_pairs", k))
        rows = pairs[inv.long()]
        return rows.view(-1, k, pairs.shape[-1]).sum(dim=1, dtype=torch.float32).to(pairs.dtype)

    monkeypatch.setattr(mp, "on_card", lambda x: True)
    monkeypatch.setattr(mp, "swiglu_weigh", swiglu_weigh)
    monkeypatch.setattr(mp, "combine_pairs", combine_pairs)


@pytest.mark.parametrize("dtype", TYPES)
def test_the_kernel_path_hands_the_kernels_the_pairs_and_counts_them(monkeypatch, dtype):
    """Where the kernels run, the expert layer gives swiglu_weigh the f32
    weights and the sort, combine_pairs the inverse permutation, and the
    result is the plain path's; every row runs the kernels."""
    cfg, moe, x = moe_layer(dtype, seed=7)
    with torch.no_grad():
        want = parent_moe_apply(moe, cfg, x)
    seen = []
    _fake_kernels(monkeypatch, seen)
    calls = _record(monkeypatch)
    with torch.no_grad():
        got = modeling.moe_apply(moe, cfg, x)
        dense = modeling.mlp_apply(moe.shared_experts, x[:9])
    assert torch.equal(got, want)
    assert torch.equal(dense, parent_mlp_apply(moe.shared_experts, x[:9]))
    assert seen == [("swiglu_weigh", True), ("combine_pairs", cfg.num_experts_per_tok),
                    ("swiglu_weigh", False), ("swiglu_weigh", False)]
    assert _rows(calls) == {FUSED: 50 * cfg.num_experts_per_tok + 50 + 9, COMPOSED: 0}
    # under autograd the same call stays composed
    calls.clear()
    modeling.mlp_apply(moe.shared_experts, x[:9].clone().requires_grad_())
    assert _rows(calls) == {FUSED: 0, COMPOSED: 9}


def _bad(case):
    """(the call, the words its refusal holds)."""
    g = torch.Generator().manual_seed(0)
    gate_up = torch.randn(12, 32, generator=g).to(torch.bfloat16)
    weights, order = torch.rand(12, generator=g), torch.randperm(12, generator=g)
    pairs, porder = _pairs(4, 3, 16, torch.bfloat16)
    inv = inverse(porder)
    misaligned = torch.empty(gate_up.numel() + 1, dtype=gate_up.dtype)[1:].view(12, 32)
    calls = {
        "cpu": (lambda: mp.swiglu_weigh(gate_up, weights, order), "cuda"),
        "cpu pairs": (lambda: mp.combine_pairs(pairs, inv, 3), "cuda"),
        "strided": (lambda: mp.swiglu_weigh(gate_up.t().contiguous().t()), "contiguous"),
        "strided pairs": (lambda: mp.combine_pairs(pairs[:, ::2], inv, 3), "contiguous"),
        "misaligned": (lambda: mp.swiglu_weigh(misaligned), "aligned"),
        "fp16": (lambda: mp.swiglu_weigh(gate_up.half()), "float16"),
        "f32": (lambda: mp.swiglu_weigh(gate_up.float(), weights, order), "float32"),
        "f32 pairs": (lambda: mp.combine_pairs(pairs.float(), inv, 3), "float32"),
        "width": (lambda: mp.swiglu_weigh(gate_up[:, :24].contiguous()), "multiple of 16"),
        "pair width": (lambda: mp.combine_pairs(pairs[:, :12].contiguous(), inv, 3),
                       "multiple of 8"),
        "weights alone": (lambda: mp.swiglu_weigh(gate_up, weights), "together"),
        "bf16 weights": (lambda: mp.swiglu_weigh(gate_up, weights.bfloat16(), order),
                         "weights must be torch.float32"),
        "int32 order": (lambda: mp.swiglu_weigh(gate_up, weights, order.int()),
                        "order must be torch.int64"),
        "short order": (lambda: mp.swiglu_weigh(gate_up, weights[:6], order[:6]), "12 elements"),
        "int64 inv": (lambda: mp.combine_pairs(pairs, porder, 3), "inv must be torch.int32"),
        "k": (lambda: mp.combine_pairs(pairs, inv, 12), "k is 12"),
        "partial token": (lambda: mp.combine_pairs(pairs, inv, 5), "whole tokens"),
        "held alone": (lambda: mp.swiglu_weigh(gate_up, held=torch.tensor([3], dtype=torch.int32)),
                       "held is given with"),
        "int64 held": (lambda: mp.combine_pairs(pairs, inv, 3, torch.tensor([3])),
                       "held must be torch.int32"),
    }
    return calls[case]


BAD = ["cpu", "cpu pairs", "strided", "strided pairs", "misaligned", "fp16", "f32",
       "f32 pairs", "width", "pair width", "weights alone", "bf16 weights", "int32 order",
       "short order", "int64 inv", "k", "partial token", "held alone", "int64 held"]


@pytest.mark.parametrize("case", BAD)
def test_the_wrappers_raise_on_what_the_kernels_do_not_take(case):
    call, why = _bad(case)
    launched = launch_counts()
    with pytest.raises(ValueError, match=why):
        call()
    assert launch_counts() == launched


def test_moonlights_widths_take_the_kernels():
    """Every row width of the published configuration is a multiple of 8
    (routed 1,408, shared 2,816, layer 0's 11,264, hidden 2,048), its 6
    pairs a token are within the kernel's ``MAX_K``, and the source builds."""
    cfg = MoonlightConfig()
    widths = (cfg.moe_intermediate_size, cfg.moe_intermediate_size * cfg.n_shared_experts,
              cfg.intermediate_size, cfg.hidden_size)
    assert widths == (1408, 2816, 11264, 2048)
    assert all(w % 8 == 0 for w in widths)
    assert cfg.num_experts_per_tok <= mp.MAX_K
    text = (cuda_build.CSRC / "moe_pairs.cu").read_text()
    assert int(re.search(r"constexpr int kMaxK = (\d+);", text).group(1)) == mp.MAX_K
    assert "moe_pairs" in cuda_build.SOURCES


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
    magnitude but not below 1/256 of the tensor's largest."""
    w, g = want.float(), got.float()
    mag = torch.clamp(w.abs(), min=w.abs().max().item() / 256 if w.numel() else 0.0)
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _gate_up(p, f, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    gate_up = torch.randn((p, 2 * f), generator=g, device=device) * 2
    weights = torch.rand((max(p, 1),), generator=g, device=device)[:p] * 0.8
    order = torch.randperm(p, generator=g, device=device)
    return gate_up, weights, order


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [True, False], ids=["routed", "dense"])
@pytest.mark.parametrize("p", [0, 1, 7, 98304])
@pytest.mark.parametrize("f", [1408, 2816, 11264])
def test_swiglu_weigh_is_the_f32_function_rounded_once(cuda, f, p, weighted):
    gate_up, weights, order = _gate_up(p, f, cuda, seed=f + p)
    gate_up = gate_up.bfloat16()
    launched = launch_counts().get("swiglu_weigh", 0)
    if weighted:
        act, inv = mp.swiglu_weigh(gate_up, weights, order)
    else:
        act, inv = mp.swiglu_weigh(gate_up)
    torch.cuda.synchronize()
    assert launch_counts()["swiglu_weigh"] == launched + 1
    assert act.shape == (p, f) and act.dtype == torch.bfloat16
    gate, up = gate_up.float().chunk(2, dim=-1)
    want = F.silu(gate) * up
    if weighted:
        want = want * weights[order, None]
        assert inv.dtype == torch.int32 and inv.shape == (p,)
        assert torch.equal(inv[order], torch.arange(p, dtype=torch.int32, device=cuda))
    else:
        assert inv is None
    if p:
        assert bf16_ulps(act, want).max().item() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 7, 16384])
def test_combine_pairs_is_the_composed_sum(cuda, t):
    k, h = 6, 2048
    pairs, order = _pairs(t, k, h, torch.bfloat16, seed=t, device=cuda)
    launched = launch_counts().get("combine_pairs", 0)
    got = mp.combine_pairs(pairs, inverse(order), k)
    want = mp.combine_pairs_plain(pairs, order, k)
    torch.cuda.synchronize()
    assert launch_counts()["combine_pairs"] == launched + 1
    assert got.shape == (t, h) and got.dtype == torch.bfloat16
    assert bf16_ulps(got, want).max().item() <= 1
    assert torch.equal(got, mp.combine_pairs(pairs, inverse(order), k))  # deterministic


@pytest.mark.cuda
def test_the_inverse_from_swiglu_weigh_feeds_combine_pairs(cuda):
    gate_up, weights, order = _gate_up(600, 1408, cuda, seed=9)
    _, inv = mp.swiglu_weigh(gate_up.bfloat16(), weights, order)
    pairs = torch.randn(600, 2048, device=cuda).bfloat16()
    assert torch.equal(mp.combine_pairs(pairs, inv, 6), mp.combine_pairs(pairs, inverse(order), 6))


@pytest.mark.cuda
def test_the_expert_layer_runs_the_kernels_on_the_card(cuda, monkeypatch):
    """At the tiny configuration in bf16 on the card: outside autograd the
    kernels run (one swiglu_weigh a SwiGLU, one combine_pairs a routed
    call), every row runs the kernels, and the result is within bf16 noise
    of the plain path's and no further than it from the f32 layer (on the
    CPU, from the same bf16 weights)."""
    cfg, moe, x = moe_layer(torch.bfloat16, seed=11, device=cuda)
    launched = launch_counts()
    calls = _record(monkeypatch)
    with torch.no_grad():
        got = modeling.moe_apply(moe, cfg, x)
    counts = launch_counts()
    assert counts["swiglu_weigh"] - launched.get("swiglu_weigh", 0) == 2
    assert counts["combine_pairs"] - launched.get("combine_pairs", 0) == 1
    assert _rows(calls) == {FUSED: 50 * cfg.num_experts_per_tok + 50, COMPOSED: 0}
    with torch.no_grad():
        plain = parent_moe_apply(moe, cfg, x)
        f32 = parent_moe_apply(copy.deepcopy(moe).cpu().float(), cfg, x.cpu().float())
    f32 = f32.to(cuda)
    scale = f32.abs().max().item()
    assert (got.float() - plain.float()).abs().max().item() <= 2e-2 * scale
    err, plain_err = ((t.float() - f32).abs().max().item() for t in (got, plain))
    assert err <= plain_err + 4e-3 * scale, (err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("held", [0, 1, 299, 600])
def test_the_kernels_stop_at_held(cuda, held):
    """``held`` on the card: swiglu_weigh computes the rows before it (the
    rows past it are never read) and still writes the whole inverse;
    combine_pairs counts a pair sorted at or past it as zero, as the plain
    version does."""
    gate_up, weights, order = _gate_up(600, 1024, cuda, seed=held)
    gate_up = gate_up.bfloat16()
    count = torch.tensor([held], dtype=torch.int32, device=cuda)
    act, inv = mp.swiglu_weigh(gate_up, weights, order, count)
    full, full_inv = mp.swiglu_weigh(gate_up, weights, order)
    torch.cuda.synchronize()
    assert torch.equal(inv, full_inv) and torch.equal(act[:held], full[:held])
    pairs = torch.randn(600, 2304, device=cuda).bfloat16()
    got = mp.combine_pairs(pairs, inv, 8, count)
    want = mp.combine_pairs_plain(pairs, order, 8, count)
    if held == 0:
        assert not got.any() and not want.any()
    else:
        assert bf16_ulps(got, want).max().item() <= 1


@pytest.mark.cuda
def test_two_held_shares_sum_to_the_whole_layer_on_the_card(cuda):
    """The tiny layer's 8 experts as two shares of 4 in bf16 on the card:
    each share's routed output by the kernels within bf16 noise of its plain
    version, and the two sum to the whole layer's routed output."""
    cfg, moe, x = moe_layer(torch.bfloat16, seed=13, device=cuda)
    with torch.no_grad():
        chosen, weights = modeling.route(moe.gate, cfg, x)
        whole = modeling.experts_apply(moe.experts, x, chosen, weights).float()
        parts = []
        for off in (0, 4):
            share = modeling.Experts(4, cfg.hidden_size, cfg.moe_intermediate_size).to(cuda)
            share.gate_up_proj.data = moe.experts.gate_up_proj[off:off + 4].clone()
            share.down_proj.data = moe.experts.down_proj[off:off + 4].clone()
            got = modeling.experts_apply(share, x, chosen, weights, off)
            plain = modeling.experts_apply(share.cpu(), x.cpu(), chosen.cpu(), weights.cpu(),
                                           off)
            scale = plain.float().abs().max().item()
            assert (got.float().cpu() - plain.float()).abs().max().item() <= 2e-2 * scale
            parts.append(got.float())
    scale = whole.abs().max().item()
    assert (parts[0] + parts[1] - whole).abs().max().item() <= 2e-2 * scale
