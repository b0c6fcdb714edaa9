"""PyTorch port, model: the weight bridge, the backbone and ee_forward
against the JAX package's XLA path (f32, tiny config)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from _torch_parity import (
    jax_params,
    make_batch,
    port_model,
    separating_threshold,
    tiny_configs,
    to_jax,
    to_torch,
)
from multi_modal_early_exit_tpu.models.ee.model import decide_exits as j_decide
from multi_modal_early_exit_tpu.models.ee.model import ee_forward as j_ee_forward
from multi_modal_early_exit_tpu.models.layoutlmv3.modeling import (
    backbone_apply as j_backbone_apply,
)
from multi_modal_early_exit_tpu_torch.models.ee.model import (
    EEModel,
    decide_exits,
    ee_forward,
    init_ee_params,
    prune_ee_params,
)
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.convert import (
    load_jax_params,
    to_jax_params,
)
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import (
    backbone_apply,
    init_params,
)

torch.set_num_threads(2)

HEADS = {
    "ramp": dict(exits=("text_avg", "vision_avg", 1)),
    "gate": dict(exits=("text_avg", 1), encoder_layer_strategy="gate"),
    "lte": dict(exits=("text_visual_concat", "vision_avg", 1), use_lte=True,
                inference_strategy="lte", exit_head_num_layers=1),
    "patience": dict(exits=("text_avg", "vision_avg", 1),
                     inference_strategy="patience"),
    "entropy": dict(exits=("vision_avg", "text_visual_concat", 1, 2),
                    inference_strategy="entropy"),
}


@pytest.mark.parametrize("kind", ["ramp", "gate", "lte"])
def test_bridge_round_trips_every_leaf(kind):
    jcfg, tcfg = tiny_configs(**HEADS[kind])
    _, tree = jax_params(jcfg, seed=1)
    model = port_model(tcfg, tree)
    back = to_jax_params(model)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))


def test_bridge_casts_to_bf16():
    jcfg, tcfg = tiny_configs(**HEADS["ramp"])
    _, tree = jax_params(jcfg)
    model = load_jax_params(EEModel(tcfg, device="cpu"), tree, dtype=torch.bfloat16)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}


def test_init_ee_params_shapes_and_std():
    """The port's own init has the JAX tree's leaves, shapes and std."""
    jcfg, tcfg = tiny_configs(**HEADS["lte"])
    _, tree = jax_params(jcfg)
    model = init_ee_params(tcfg, torch.Generator().manual_seed(3), device="cpu")
    mine = dict(jax.tree_util.tree_flatten_with_path(to_jax_params(model))[0])
    theirs = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(mine) == len(theirs)
    for path, leaf in theirs:
        assert mine[path].shape == leaf.shape, path
    word = model.backbone.embeddings.word_embeddings.detach()
    assert abs(float(word.std()) - 0.02) < 2e-3
    assert float(word[tcfg.backbone.pad_token_id].abs().max()) == 0.0
    backbone = init_params(tcfg.backbone, torch.Generator().manual_seed(3), device="cpu")
    for name, p in backbone.state_dict().items():
        torch.testing.assert_close(p, model.backbone.state_dict()[name])


def test_backbone_cls_taps_match_jax():
    jcfg, tcfg = tiny_configs(**HEADS["ramp"])
    params, tree = jax_params(jcfg, seed=2)
    model = port_model(tcfg, tree)
    batch = make_batch(3, 3, 20, tcfg, masked_tail=5)
    def run(p, *b):
        out = j_backbone_apply(p["backbone"], jcfg.backbone, *b)
        return out.cls_per_layer, out.last_hidden_state

    want_cls, want_last = jax.jit(run)(params, *to_jax(batch))
    got = backbone_apply(model.backbone, tcfg.backbone, *to_torch(batch))
    assert got.cls_per_layer.shape == want_cls.shape
    np.testing.assert_allclose(got.cls_per_layer.numpy(), np.asarray(want_cls),
                               atol=5e-4, rtol=0)
    np.testing.assert_allclose(got.last_hidden_state.numpy(), np.asarray(want_last),
                               atol=5e-4, rtol=0)


@pytest.mark.parametrize("kind", list(HEADS))
def test_ee_forward_matches_jax(kind):
    jcfg, tcfg = tiny_configs(**HEADS[kind])
    params, tree = jax_params(jcfg, seed=3)
    model = port_model(tcfg, tree)
    batch = make_batch(4, 6, 20, tcfg, masked_tail=3)
    def run(p, *b):
        out = j_ee_forward(p, jcfg, *b)
        return out.policy_logits(), out.exit_criteria

    j_store, j_crit = jax.jit(run)(params, *to_jax(batch))
    out = ee_forward(model, tcfg, *to_torch(batch))
    np.testing.assert_allclose(out.policy_logits().numpy(), np.asarray(j_store),
                               atol=2e-4, rtol=1e-3)
    crit_j = np.asarray(j_crit)
    np.testing.assert_allclose(out.exit_criteria.numpy(), crit_j, atol=1e-5, rtol=1e-5)
    finite = crit_j[np.isfinite(crit_j)]
    thr = 1.5 if kind == "patience" else separating_threshold(finite, 0.5)
    np.testing.assert_array_equal(
        decide_exits(out, tcfg.exit, thr).numpy(),
        np.asarray(j_decide(SimpleNamespace(exit_criteria=j_crit), jcfg.exit, thr)),
    )


def test_seq_pad_multiple_keeps_outputs():
    jcfg, tcfg = tiny_configs(**HEADS["ramp"])
    _, tree = jax_params(jcfg, seed=4)
    model = port_model(tcfg, tree)
    batch = to_torch(make_batch(5, 2, 20, tcfg))
    a = ee_forward(model, tcfg, *batch).policy_logits()
    b = ee_forward(model, tcfg, *batch, seq_pad_multiple=128).policy_logits()
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_prune_ee_params_keeps_surviving_heads():
    jcfg, tcfg = tiny_configs(**HEADS["entropy"])
    _, tree = jax_params(jcfg)
    model = port_model(tcfg, tree)
    _, small = tiny_configs(exits=("vision_avg", 2), inference_strategy="entropy")
    pruned = prune_ee_params(model, tcfg, small)
    assert list(pruned.embedding_exits) == ["vision_avg"]
    assert len(pruned.encoder_exits) == 1
    assert pruned.encoder_exits[0] is model.encoder_exits[1]
    assert len(model.encoder_exits) == 2  # the original is untouched
    out = ee_forward(pruned, small, *to_torch(make_batch(6, 2, 12, small)))
    assert out.policy_logits().shape == (3, 2, 4)
