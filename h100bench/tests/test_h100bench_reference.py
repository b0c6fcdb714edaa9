"""The plain reference against the port's plain path at the tiny
configuration on the CPU, in f32: the forward's logits, the cascade's
decisions and capacities, the training loss and gradients with the same
dropout seeds, AdamW, and the hash."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from h100bench import port, traffic, weights
from h100bench.entries import serve as serve_entry
from h100bench.entries import train as train_entry
from h100bench.reference import cascade, hashing
from h100bench.reference import train as ref_train
from h100bench.reference import v3
from h100bench.tests import tiny

CFG = tiny.tiny_config()
MIX = {"pool": 16, "words": [5, 40], "bands": 8}


def batch(seed=3, n=16):
    pool = traffic.make_pool(seed, CFG, dict(MIX, pool=n), "cpu")
    return {k: torch.as_tensor(v) for k, v in pool.items()}


def test_forward_matches_the_port():
    from multi_modal_early_exit_tpu_torch.models.ee.model import ee_forward

    w = weights.make(CFG, 5, "cpu")
    b = batch()
    model = port.ee_model(CFG, w, "cpu", torch.float32)
    with torch.no_grad():
        want = ee_forward(model, port.ee_config(CFG), b["input_ids"], b["bbox"],
                          b["pixel_values"], b["attention_mask"]).policy_logits()
    got = v3.infer(w, CFG, b, 5)["logits"]
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def test_fp8_products_depart_from_f32():
    w = weights.make(CFG, 5, "cpu")
    b = batch()
    assert (v3.infer(w, CFG, b, 8, True)["logits"] - v3.infer(w, CFG, b, 8)["logits"]).abs().max() > 1e-4


@pytest.mark.parametrize("dist,batch_size", [({0: 0.05, 1: 0.05, 2: 0.8, 3: 0.1}, 64),
                                             ({0: 0.05, 1: 0.05, 2: 0.8, 3: 0.1}, 16),
                                             ({0: 0.45, 1: 0.45, 2: 0.05, 3: 0.05}, 32)])
def test_capacities_match_the_port(dist, batch_size):
    from multi_modal_early_exit_tpu_torch.models.ee.cascade import capacities_from_distribution

    assert cascade.capacities(dist, batch_size, 2, 2, 0.995) == capacities_from_distribution(
        dist, batch_size, 2, 2, tail=0.995)


def test_cascade_decisions_match_the_port():
    from multi_modal_early_exit_tpu_torch.models.ee.cascade import make_cascade_forward

    w = weights.make(CFG, 7, "cpu")
    b = batch(seed=4)
    model = port.ee_model(CFG, w, "cpu", torch.float32)
    out = v3.infer(w, CFG, b, 16)
    crit = v3.max_confidence(out["logits"])
    thr = serve_entry.thresholds_for(crit, {0: 0.2, 1: 0.2, 2: 0.3, 3: 0.3})
    for caps in ((16, 8), (8, 8), (16, 16)):
        res = make_cascade_forward(port.ee_config(CFG), caps, thr)(
            model, b["input_ids"], b["bbox"], b["pixel_values"], b["attention_mask"])
        exits, forced = cascade.decide(crit, thr, caps, 2)
        assert res.exit_ids.tolist() == exits and res.capacity_exited.tolist() == forced
        rows = torch.arange(16)
        torch.testing.assert_close(res.logits, out["logits"][res.exit_ids.long(), rows],
                                   rtol=1e-4, atol=1e-6)


def test_training_loss_and_gradients_match_the_port():
    from multi_modal_early_exit_tpu_torch.training.losses import ee_loss_fn
    from multi_modal_early_exit_tpu_torch.training.subgraphs import (
        exit_loss_weights,
        subgraph_param_counts,
    )

    w = weights.make(CFG, 9, "cpu")
    b = batch(seed=6, n=8)
    model = port.ee_model(CFG, w, "cpu", torch.float32)
    pcfg = port.ee_config(CFG)
    want_w = exit_loss_weights(subgraph_param_counts(model, pcfg))
    torch.testing.assert_close(ref_train.exit_weights(w, CFG), want_w)
    seeds = train_entry.step_seeds(11, CFG, 1)[0]
    loss, _ = ee_loss_fn(model, pcfg, b, rng=torch.Generator().manual_seed(11),
                         exit_weights=want_w, device="cpu")
    loss.backward()
    got_loss, grads = ref_train.loss_and_grads(w, CFG, b, seeds, 128, 3)
    assert got_loss == pytest.approx(float(loss.detach()), rel=1e-5)
    for name, p in model.named_parameters():
        torch.testing.assert_close(grads[name], p.grad, rtol=1e-3, atol=1e-6 * p.grad.abs().max()
                                   + 1e-12, msg=name)


def test_dropout_seeds_are_all_drawn():
    assert train_entry.draws_per_step(CFG) == 2 + 3 * 2 + 2 * 3 + 2


def test_adamw_matches_torch():
    g = torch.Generator().manual_seed(0)
    w = {"a": torch.randn(5, 3, generator=g), "b": torch.randn(7, generator=g)}
    params = {n: torch.nn.Parameter(t.clone()) for n, t in w.items()}
    opt = torch.optim.AdamW(list(params.values()), lr=1e-3, weight_decay=0.0)
    mine = ref_train.AdamW(w)
    for _ in range(3):
        grads = {n: torch.randn(t.shape, generator=g) for n, t in w.items()}
        for n, p in params.items():
            p.grad = grads[n].clone()
        opt.step()
        mine.step(w, grads, 1e-3)
    for n in w:
        torch.testing.assert_close(w[n], params[n].detach(), rtol=1e-6, atol=1e-7)


def test_hash_matches_the_port():
    from multi_modal_early_exit_tpu_torch.ops.hashing import dropout_uniform

    rows = torch.arange(97)[:, None] * 1000 + 12345
    cols = torch.arange(64)[None, :]
    for seed, plane in ((0, 0), (2 ** 31 - 2, 5), (123456789, 2 ** 20 + 7)):
        assert torch.equal(hashing.uniform(seed, plane, rows, cols),
                           dropout_uniform(seed, plane, rows, cols))


def test_thresholds_give_the_mix():
    crit = torch.rand(4, 4000, generator=torch.Generator().manual_seed(1))
    dist = {0: 0.05, 1: 0.05, 2: 0.8, 3: 0.1}
    thr = serve_entry.thresholds_for(crit, dist)
    exits, _ = cascade.decide(crit, thr, (4000, 4000), 2)
    share = np.bincount(exits, minlength=4) / 4000
    assert np.allclose(share, [0.05, 0.05, 0.8, 0.1], atol=0.01)


def test_v2_forward_matches_the_port():
    from multi_modal_early_exit_tpu_torch.models.layoutlmv2.modeling import (
        forward_sequence_classification,
    )

    from h100bench.entries.harvest import Entry
    from h100bench.reference import v2

    cfg = tiny.tiny_v2_config()
    mix = dict(tiny.read(tiny.HERE / "traffic" / "harvest-b64.json"), pool=8, words=[5, 40], batch=8)
    entry = Entry(cfg, mix, 3, "cpu", open(os.devnull, "w"))
    b = {k: torch.from_numpy(v) for k, v in entry.dataset.arrays.items()}
    with torch.no_grad():
        want = forward_sequence_classification(entry.model, entry.v2cfg, b["input_ids"], b["bbox"],
                                               b["pixel_values"], b["attention_mask"]).logits
    w = weights.make(cfg, 3, "cpu")
    got = v2.infer(w, cfg, b, 4)
    assert got.shape == (1, 8, 4)
    torch.testing.assert_close(got[0], want, rtol=1e-4, atol=1e-5 * want.abs().max())
