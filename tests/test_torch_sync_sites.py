"""PyTorch port, the serving path's waits on the card: every call on the
language models' path that makes the host wait for the card sits inside a
span of its own, ``sync.<site>`` (``utils.profiling.sync``).

On the CPU: one request of each family through ``Pipeline.predict_features``
under the profiler gives each site's spans, as many as the request makes,
inside the spans that own them. On the card (marked ``cuda``, skipped
elsewhere): the same requests with PyTorch's sync check raising everywhere
but inside ``sync``, which must also wait at every call, so a wait the spans
do not name fails the test, as a site that waits on nothing does. On the
card: ``python -m pytest tests/test_torch_sync_sites.py -q --noconftest``.
This file imports no JAX.
"""

import collections
import contextlib
import warnings

import numpy as np
import pytest
import torch

from multi_modal_early_exit_tpu_torch.models.ee.model import init_ee_params
from multi_modal_early_exit_tpu_torch.models.kimi_linear.config import KimiLinearConfig
from multi_modal_early_exit_tpu_torch.models.kimi_vl.config import KimiVLConfig, MoonViTConfig
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import EEModelConfig
from multi_modal_early_exit_tpu_torch.models.moonlight.config import (
    MoonlightConfig,
    MoonlightExitConfig,
)
from multi_modal_early_exit_tpu_torch.serving import Pipeline
from multi_modal_early_exit_tpu_torch.utils import profiling

torch.set_num_threads(2)

B, S = 4, 64
STAGES = 3
# pages of grids other than the position table's own (4 x 4), so the
# packing copies its resampling matrices too
GRIDS = [(4, 6), (6, 4), (2, 8), (6, 6)]
PATCHES = 36
FAMILIES = ("moonlight", "kimi_vl", "kimi_linear")
# each site's spans in one request of one chunk through three stages: a
# copy to the card per host array, the chunk's rows, a stage's real tokens
# (and a Kimi-Linear stage's lengths), the page grids and the packing's two
# copies (Kimi-VL), the three result copies
SPANS = {
    "moonlight": {"copy_in": 2, "rows": 1, "real_tokens": STAGES, "answers": 3},
    "kimi_vl": {"copy_in": 3, "rows": 1, "grids": 1, "pages": 2, "real_tokens": STAGES,
                "answers": 3},
    "kimi_linear": {"copy_in": 2, "rows": 1, "real_tokens": STAGES, "row_lengths": STAGES,
                    "answers": 3},
}
# the span each site's spans open inside
OWNER = {"copy_in": "pipeline.copy_in", "rows": "pipeline.copy_in", "grids": "cascade.embed",
         "pages": "vit.pack", "real_tokens": "cascade.stage", "row_lengths": "cascade.stage",
         "answers": "pipeline.answers"}


def backbone(family: str, card: bool):
    """The family's tiny config; on the card at the widths its kernels take
    (MoonViT's heads of 72, KDA's heads of 128 in chunks of 64)."""
    if family == "moonlight":
        return MoonlightConfig.tiny()
    if family == "kimi_vl":
        bb = KimiVLConfig.tiny()
        if card:
            bb = bb.replace(vision=MoonViTConfig(
                patch_size=2, hidden_size=144, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=64, init_pos_emb_height=4, init_pos_emb_width=4))
        return bb
    bb = KimiLinearConfig.tiny()
    return bb.replace(kda_head_dim=128, chunk_size=64) if card else bb


def served(family: str, device: str, dtype=torch.float32):
    """(a pipeline of one chunk at a threshold no document meets, so every
    stage runs, a request: host arrays, and Kimi-VL's patch rows on the
    device in the model's dtype, as the benchmark's pool holds them)."""
    bb = backbone(family, device != "cpu")
    exits = (2, 4) if family == "kimi_linear" else (1, 2)
    cfg = EEModelConfig(backbone=bb, exit=MoonlightExitConfig(exits=exits))
    model = init_ee_params(cfg, torch.Generator().manual_seed(0), device=device, dtype=dtype)
    pipe = Pipeline(model, cfg, threshold=2.0, batch_size=B, tokenizer=object(), device=device)
    rng = np.random.default_rng(1)
    lengths = np.array([S, 41, 17, 30])
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(1, 400, (B, S)).astype(np.int32)
    req = {"attention_mask": mask}
    if family == "kimi_vl":
        # each row's page's placeholder ids first, then its text
        for i, (h, w) in enumerate(GRIDS):
            ids[i, :h * w // bb.vision.merged] = bb.media_placeholder_token_id
        pixels = rng.standard_normal((B, PATCHES, bb.vision.patch_dim)).astype(np.float32)
        req["pixel_values"] = torch.from_numpy(pixels).to(device, dtype)
        req["image_grid_hws"] = np.array(GRIDS, dtype=np.int64)
    req["input_ids"] = ids * mask
    return pipe, req


def user_spans(prof):
    """(name, start, end) of every span the program opened, in start order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and "." in e.name and not e.name.startswith("aten::")),
                  key=lambda s: s[1])


@pytest.mark.parametrize("family", FAMILIES)
def test_each_wait_is_a_span_inside_its_owner(family):
    from torch.profiler import ProfilerActivity, profile

    pipe, req = served(family, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert len(pipe.predict_features(req)) == B
    found = user_spans(prof)
    syncs = [s for s in found if s[0].startswith(profiling.SYNC)]
    sites = collections.Counter(name[len(profiling.SYNC):] for name, _, _ in syncs)
    want = dict(SPANS[family])
    if family == "kimi_vl":
        want["copy_in"] += 1  # on the CPU the patch rows lie in host memory too
    assert dict(sites) == want
    for name, a, b in syncs:
        owner = OWNER[name[len(profiling.SYNC):]]
        assert any(o.startswith(owner) and oa <= a and b <= ob
                   for o, oa, ob in found if o != name), name
    packs = [s for s in found if s[0] == "vit.pack"]
    assert len(packs) == (family == "kimi_vl")
    embeds = [s for s in found if s[0] == "cascade.embed"]
    assert all(any(ea <= a and b <= eb for _, ea, eb in embeds) for _, a, b in packs)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_no_wait_on_the_card_outside_a_sync_span(cuda, family, monkeypatch):
    """One served request with PyTorch's sync check raising outside
    ``sync`` and warning inside it: every call to ``sync`` waits on the card
    at least once, and nothing else waits."""
    pipe, req = served(family, "cuda", torch.bfloat16)
    pipe.predict_features(req)  # builds the kernels and the libraries' handles
    torch.cuda.synchronize()
    calls, waited = collections.Counter(), collections.Counter()

    @contextlib.contextmanager
    def lifted(site):
        calls[site] += 1
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                yield
        finally:
            torch.cuda.set_sync_debug_mode("error")
        waited[site] += any("synchroniz" in str(w.message) for w in caught)

    monkeypatch.setattr(profiling, "sync", lifted)
    torch.cuda.set_sync_debug_mode("error")
    try:
        answers = pipe.predict_features(req)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(answers) == B
    assert dict(calls) == SPANS[family]
    assert waited == calls
