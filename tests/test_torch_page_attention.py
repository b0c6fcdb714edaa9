"""PyTorch port, attention within each page of a packed batch
(``ops/page_attention.py``): MoonViT's, at head dim 72.

On the CPU ``page_attention`` is ``page_attention_plain``, held here to a
dense softmax over every packed row with the other pages' keys masked out.
On CUDA tensors it launches the hand-written kernel of
``csrc/page_attention.cu`` or raises; its argument checks (``_refusal``)
are plain Python and run here. The tests marked ``cuda`` need an sm_90 card
and skip elsewhere: on the card, ``python -m pytest
tests/test_torch_page_attention.py -q --noconftest``. This file imports no
JAX.
"""

import numpy as np
import pytest
import torch

from multi_modal_early_exit_tpu_torch.ops import page_attention as pa
from multi_modal_early_exit_tpu_torch.utils.profiling import launch_counts

H, D = 16, pa.HEAD_DIM
SCALE = D ** -0.5
# pages whose patch counts are no multiple of a 128-row tile or of a
# 64-key block, one shorter than either, one of a single patch
RAGGED = [[37, 129, 200], [1, 64, 65, 127, 128, 130], [300], [5, 3, 250, 17]]


def _packed(lens, dtype, device="cpu", seed=0, heads=H, d=D):
    """q and k as views of one (T, 2, heads, d) tensor and v of a (T, 3,
    heads, d) one, as the tower's rotary embedding and qkv product give
    them; the pages' starts and their int32 copy on the device."""
    g = torch.Generator().manual_seed(seed)
    t = int(sum(lens))
    qk = torch.randn((t, 2, heads, d), generator=g).to(device, dtype)
    qkv = torch.randn((t, 3, heads, d), generator=g).to(device, dtype)
    starts = [0] + np.cumsum(lens).astype(int).tolist()
    cu = torch.tensor(starts, dtype=torch.int32, device=device)
    return qk[:, 0], qk[:, 1], qkv[:, 2], starts, cu


def _dense(q, k, v, starts, scale):
    """softmax over every packed row at once, keys of other pages at -inf,
    in f64."""
    page = torch.repeat_interleave(torch.arange(len(starts) - 1),
                                   torch.tensor(np.diff(starts)))
    qd, kd, vd = (x.double().transpose(0, 1) for x in (q, k, v))
    scores = (qd @ kd.transpose(-1, -2)) * scale
    scores = scores.masked_fill(page[:, None] != page[None, :], float("-inf"))
    return (torch.softmax(scores, dim=-1) @ vd).transpose(0, 1)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lens", RAGGED)
def test_plain_is_a_dense_softmax_with_the_other_pages_masked(lens):
    q, k, v, starts, cu = _packed(lens, torch.float32, seed=len(lens))
    got = pa.page_attention_plain(q, k, v, starts, SCALE)
    assert got.shape == q.shape
    torch.testing.assert_close(got.double(), _dense(q, k, v, starts, SCALE), rtol=1e-5,
                               atol=1e-5)
    # the CPU path of the wrapper is the plain version, and launches nothing
    before = launch_counts()
    assert torch.equal(pa.page_attention(q, k, v, starts, cu, SCALE), got)
    assert launch_counts().get("page_attention", 0) == before.get("page_attention", 0)


def test_plain_keeps_each_page_to_itself():
    """A page's outputs depend on its own rows alone: changing another
    page's k and v leaves them as they were."""
    q, k, v, starts, _ = _packed([40, 90, 7], torch.float32, seed=3)
    a = pa.page_attention_plain(q, k, v, starts, SCALE)
    k2, v2 = k.clone(), v.clone()
    k2[40:130] += 5.0
    v2[40:130] -= 3.0
    b = pa.page_attention_plain(q, k2, v2, starts, SCALE)
    assert torch.equal(a[:40], b[:40]) and torch.equal(a[130:], b[130:])
    assert not torch.equal(a[40:130], b[40:130])


# ---------------------------------------------------------------------------
# what the kernel takes
# ---------------------------------------------------------------------------


def _refusal_case(case, device="cpu"):
    """The arguments of one refused call, built on ``device``."""
    q, k, v, starts, cu = _packed([30, 70], torch.bfloat16, device, seed=1)
    if case == "dtype":
        q = q.float()
    elif case == "head dim":
        q, k, v, starts, cu = _packed([30, 70], torch.bfloat16, device, seed=1, d=64)
    elif case == "last dim stride":
        v = torch.randn((100, H, 2 * D), device=device).bfloat16()[:, :, ::2]
    elif case == "head stride":  # heads 76 apart: 152 bytes, not 16-byte aligned
        k = torch.randn((100, H, D + 4), device=device).bfloat16()[:, :, :D]
    elif case == "shape":
        k = k[:99]
    elif case == "starts":
        starts = [0, 30, 99]
    elif case == "cu_seqlens":
        cu = cu.long()
    return q, k, v, starts, cu


@pytest.mark.parametrize("case, words", [
    ("dtype", "bfloat16"), ("head dim", "(T, heads, 72)"), ("last dim stride", "strides"),
    ("head stride", "strides"), ("shape", "q is"), ("starts", "starts must rise"),
    ("cu_seqlens", "cu_seqlens must be"),
])
def test_the_kernel_refuses_what_it_does_not_take(case, words):
    why = pa._refusal(*_refusal_case(case))
    assert why is not None and words in why, why


def test_the_kernel_takes_the_towers_views_but_only_on_the_card():
    """q and k as views of the rotary embedding's output and v of the qkv
    product pass every check; on the CPU only the device is refused."""
    q, k, v, starts, cu = _packed([30, 70], torch.bfloat16)
    assert q.stride() == (2 * H * D, D, 1) and v.stride() == (3 * H * D, D, 1)
    assert pa._refusal(q, k, v, starts, cu) == "the kernel runs on cuda, not cpu"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) CUDA device")
    return torch.device("cuda")


# bf16 outputs of the kernel against the plain version on the same inputs,
# the largest error over the output's largest value: on an H100 the kernel
# and varlen_attn each read 4.6e-3 to 1.05e-2 against the same plain version
# at unit-normal inputs (the plain version rounds the normalised p to bf16,
# the kernels the unnormalised one)
CARD_TOL = 2e-2


# more pages than a warp has lanes (the kernel ranks them 32 at a time),
# and empty pages, which own no tile
MANY = [int(n) for n in np.random.default_rng(0).integers(1, 300, 37)]
EMPTY = [0, 50, 0, 130, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("lens", RAGGED + [[4096], [1024, 4096, 2000, 1536], MANY, EMPTY])
def test_the_kernel_is_the_plain_version_on_the_card(cuda, lens):
    q, k, v, starts, cu = _packed(lens, torch.bfloat16, cuda, seed=sum(lens))
    before = launch_counts().get("page_attention", 0)
    got = pa.page_attention(q, k, v, starts, cu, SCALE)
    torch.cuda.synchronize()
    assert launch_counts()["page_attention"] == before + 1
    want = pa.page_attention_plain(q, k, v, starts, SCALE)
    err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    assert err <= CARD_TOL, err
    assert torch.equal(got, pa.page_attention(q, k, v, starts, cu, SCALE))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dtype", "head dim", "head stride"])
def test_the_card_raises_on_what_the_kernel_does_not_take(cuda, case):
    q, k, v, starts, cu = _refusal_case(case, cuda)
    with pytest.raises(ValueError, match="page_attention"):
        pa.page_attention(q, k, v, starts, cu, SCALE)
