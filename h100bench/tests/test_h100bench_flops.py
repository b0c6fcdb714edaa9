"""flops.py against counts made by hand at the tiny configuration: 512 text
positions cut to 64, 32^2 pages in 16^2 patches (4 + [CLS]), hidden 64,
4 heads of 16, MLP 128, 4 labels, exits vision_avg, text_avg, 1."""

from __future__ import annotations

import pytest

from h100bench import flops
from h100bench.tests import tiny

CFG = tiny.tiny_config()
S = 64 + 5
HEAD = 2 * 64 * 64 + 2 * 64 * 4            # dense, then projection to 4 labels
EMBED = 2 * 4 * (3 * 16 * 16) * 64         # 4 patches of 768 values to 64
LAYER = (4 * 2 * S * 64 * 64               # q, k, v, output projections
         + 2 * S * 64 * 128 + 2 * S * 128 * 64   # MLP up and down
         + 4 * (2 * S * S * 16) * 2)       # q k^T and p v over 4 heads of 16


def test_sequence_and_layer():
    assert flops.seq_len(CFG) == S
    assert flops.layer_flops(CFG, S) == LAYER
    assert flops.head_flops(CFG) == HEAD and flops.embed_flops(CFG) == EMBED


@pytest.mark.parametrize("exit_index,want", [
    (0, EMBED + HEAD),                              # vision_avg
    (1, EMBED + 2 * HEAD),                          # text_avg
    (2, EMBED + 3 * HEAD + LAYER),                  # after layer 1
    (3, EMBED + 4 * HEAD + 2 * LAYER),              # the classifier
])
def test_doc_flops_to_exit(exit_index, want):
    assert flops.exit_order(CFG) == ["vision_avg", "text_avg", 1]
    assert flops.doc_flops_to_exit(CFG, exit_index) == want


def test_train_doc_flops():
    assert flops.train_doc_flops(CFG) == 3 * (EMBED + 2 * LAYER + 4 * HEAD)


def test_attention_costs():
    b, h, s, d = 8, 4, 128, 16
    qkv = b * s * h * d * 2
    assert flops.attn_fwd_cost(b, h, s, d) == (4 * qkv + b * h * s * s * 2, 4 * b * h * s * s * d)
    assert flops.attn_bwd_cost(b, h, 100, d) == (
        8 * b * 100 * h * d * 2 + b * h * 100 * 100 * 2 + b * h * 128 * 128 * 2 + b * h * 128 * 4,
        10 * b * h * 100 * 100 * d)
    by_bytes = (4 * qkv + b * h * s * s * 2) / flops.PEAK_BYTES_PER_S
    assert flops.bound_s(*flops.attn_fwd_cost(b, h, s, d)) == pytest.approx(by_bytes)


def test_base_layer_flops_at_709_tokens():
    base = tiny.read(tiny.HERE / "configs" / "eelayoutlmv3-base.json")
    assert flops.seq_len(base) == 709
    assert flops.layer_flops(base, 709) == pytest.approx(11.58e9, rel=1e-3)
