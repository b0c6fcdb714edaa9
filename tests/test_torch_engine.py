"""PyTorch port, ``models/ee/engine.py::AnytimeEngine`` against the JAX
package's engine on the tiny config, the JAX parameters carried into the
port: the exit ids bit-equal and the logits within the f32 bars (atol 2e-4
/ rtol 1e-3) for max-confidence at thresholds {0.0, 0.3, 0.9, 1.1}, LTE,
patience at t in {1, 2} and gate heads; the stores of ``collect_store``;
the exits against ``decide_exits(ee_forward())``; and that a low threshold
shrinks the deep stage's bucket. The exit heads' output layers are scaled
up in the carried tree (both packages get the same numbers), so that
random-init confidences spread over the thresholds."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from _torch_parity import jax_params, make_batch, port_model, tiny_configs, to_jax
from multi_modal_early_exit_tpu.models.ee import engine as JE
from multi_modal_early_exit_tpu_torch.models.ee import engine as TE
from multi_modal_early_exit_tpu_torch.models.ee.model import decide_exits, ee_forward

torch.set_num_threads(2)

TOL = dict(atol=2e-4, rtol=1e-3)
B, S = 13, 24
HEAD_SCALE = 80.0


def _sharpened(tree):
    """The tree with every exit head's and the classifier's output layer
    scaled by ``HEAD_SCALE``."""
    tree = jax.tree.map(np.copy, tree)
    heads = [head["out_proj"] for head in tree.get("embedding_exits", {}).values()]
    heads += [tree["encoder_exits"]["out_proj"], tree["backbone"]["classifier"]["out_proj"]]
    for head in heads:
        head["kernel"] = head["kernel"] * HEAD_SCALE
    return tree


def _engines(seed=0, **exit_kwargs):
    """(JAX params, JAX config, port model, port config, a batch)."""
    jcfg, tcfg = tiny_configs(**exit_kwargs)
    _, tree = jax_params(jcfg, seed=seed)
    tree = _sharpened(tree)
    params = jax.tree.map(jax.numpy.asarray, tree)
    return params, jcfg, port_model(tcfg, tree), tcfg, make_batch(seed + 10, B, S, tcfg)


@pytest.fixture(scope="module")
def max_conf():
    return _engines(exits=("text_avg", "vision_avg", 1), inference_strategy="max_confidence")


def _both(setup, threshold, collect_store=False, max_batch=16, min_bucket=4):
    params, jcfg, model, tcfg, batch = setup
    want = JE.AnytimeEngine(params, jcfg, threshold=threshold, max_batch=max_batch,
                            min_bucket=min_bucket).infer(*to_jax(batch),
                                                         collect_store=collect_store)
    got = TE.AnytimeEngine(model, tcfg, threshold=threshold, max_batch=max_batch,
                           min_bucket=min_bucket, device="cpu").infer(
        *batch, collect_store=collect_store)
    return got, want


def _assert_same(got, want):
    (logits, exits, store), (j_logits, j_exits, j_store) = got, want
    assert exits.dtype == np.int32 and logits.shape == j_logits.shape
    np.testing.assert_array_equal(exits, j_exits)
    np.testing.assert_allclose(logits, j_logits, **TOL)
    if j_store is not None:
        np.testing.assert_allclose(store, j_store, **TOL)


@pytest.mark.parametrize("threshold", [0.0, 0.3, 0.9, 1.1])
def test_max_confidence_matches_jax(max_conf, threshold):
    got, want = _both(max_conf, threshold)
    _assert_same(got, want)
    _, model, tcfg, batch = max_conf[1:]
    with torch.no_grad():
        out = ee_forward(model, tcfg, *map(torch.from_numpy, batch))
    np.testing.assert_array_equal(got[1], decide_exits(out, tcfg.exit, threshold).numpy())


def test_thresholds_spread_the_exits(max_conf):
    """The scaled heads put documents at every exit for some threshold."""
    seen = set()
    for threshold in (0.5, 0.7, 0.9):
        seen |= set(_both(max_conf, threshold)[0][1].tolist())
    assert seen == {0, 1, 2, 3}


def test_store_matches_jax_and_ee_forward(max_conf):
    got, want = _both(max_conf, 0.5, collect_store=True)
    _assert_same(got, want)
    _, model, tcfg, batch = max_conf[1:]
    with torch.no_grad():
        store = ee_forward(model, tcfg, *map(torch.from_numpy, batch)).policy_logits()
    np.testing.assert_allclose(got[2], store.numpy(), atol=1e-5, rtol=1e-5)


def test_low_threshold_shrinks_the_deep_stage(max_conf, monkeypatch):
    """Each stage runs on the bucket of its survivors: at 0.3 every
    document leaves at the first exit and no stage runs; at 0.7 the deep
    stage runs on a smaller bucket than at 0.9; with ``collect_store``
    every stage runs on every document."""
    _, _, model, tcfg, batch = max_conf
    rows = []
    stage = TE.AnytimeEngine._stage

    def spy(self, idx, hidden, *rest):
        rows.append((idx, hidden.shape[0]))
        return stage(self, idx, hidden, *rest)

    monkeypatch.setattr(TE.AnytimeEngine, "_stage", spy)

    def stages(threshold, collect_store=False):
        rows.clear()
        engine = TE.AnytimeEngine(model, tcfg, threshold=threshold, max_batch=16,
                                  min_bucket=4, device="cpu")
        exits = engine.infer(*batch, collect_store=collect_store)[1]
        return list(rows), exits

    assert stages(0.3)[0] == []
    sizes = (4, 8, 16)
    deep = {}
    for threshold in (0.7, 0.9):
        ran, exits = stages(threshold)
        assert ran == [(0, TE._round_bucket(int((exits >= 2).sum()), sizes)),
                       (1, TE._round_bucket(int((exits == 3).sum()), sizes))]
        deep[threshold] = ran[1][1]
    assert deep[0.7] < deep[0.9]
    assert stages(0.7, collect_store=True)[0] == [(0, 16), (1, 16)]


def test_lte_matches_jax():
    setup = _engines(seed=2, exits=("text_visual_concat", 1), inference_strategy="lte",
                     use_lte=True)
    _, _, model, tcfg, batch = setup
    with torch.no_grad():
        crit = ee_forward(model, tcfg, *map(torch.from_numpy, batch)).exit_criteria
    for threshold in (0.3, 0.5, 0.7, float(np.median(crit[0].numpy()))):
        got, want = _both(setup, threshold)
        _assert_same(got, want)


@pytest.mark.parametrize("patience", [1, 2])
def test_patience_matches_jax(patience):
    setup = _engines(seed=3, exits=("text_avg", "vision_avg", 1),
                     inference_strategy="patience")
    got, want = _both(setup, patience, collect_store=True)
    _assert_same(got, want)
    got, want = _both(setup, patience)
    _assert_same(got, want)


def test_gate_heads_match_jax():
    """Gate heads: the class logits are the classifier on the exit's input,
    the 2-logit gate output only the criterion."""
    setup = _engines(seed=4, exits=("text_avg", 1), encoder_layer_strategy="gate")
    for threshold in (0.55, 0.6, 0.8):
        got, want = _both(setup, threshold)
        assert got[0].shape == (B, 4)
        _assert_same(got, want)


def test_bucket_sizes_match_jax():
    for max_batch, minimum in ((64, 8), (32, 8), (16, 4), (12, 8), (8, 8)):
        sizes = TE._bucket_sizes(max_batch, minimum)
        assert sizes == JE._bucket_sizes(max_batch, minimum)
        for n in (1, 5, 8, 9, 17, 33, 64):
            assert TE._round_bucket(n, sizes) == JE._round_bucket(n, sizes)


def test_lte_needs_its_head():
    _, _, model, tcfg, _ = _engines(exits=("text_visual_concat", 1))
    lte_cfg = tcfg.replace(exit=dataclasses.replace(tcfg.exit, inference_strategy="lte"))
    with pytest.raises(ValueError, match="lte head"):
        TE.AnytimeEngine(model, lte_cfg, device="cpu")
