"""PyTorch port, cascade: exit ids and capacity exits bit-equal to the JAX
cascade (XLA path, f32), logits within tolerance."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    jax_params,
    make_batch,
    port_model,
    separating_threshold,
    tiny_configs,
    to_jax,
    to_torch,
)
from multi_modal_early_exit_tpu.models.ee.cascade import (
    capacities_from_distribution as j_capacities,
)
from multi_modal_early_exit_tpu.models.ee.cascade import (
    make_cascade_forward as j_make_cascade,
)
from multi_modal_early_exit_tpu.models.ee.model import decide_exits as j_decide
from multi_modal_early_exit_tpu.models.ee.model import ee_forward as j_ee_forward
from multi_modal_early_exit_tpu_torch.models.ee.cascade import (
    capacities_from_distribution,
    make_cascade_forward,
)
from multi_modal_early_exit_tpu_torch.models.ee.model import decide_exits, ee_forward

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _inference():
    """These tests drive the inference path, which runs under no_grad."""
    with torch.no_grad():
        yield

B, S = 12, 20

RAMP = dict(exits=("text_avg", "vision_avg", 1))


def _setup(seed=0, duplicate=False, **exit_kwargs):
    jcfg, tcfg = tiny_configs(**exit_kwargs)
    params, tree = jax_params(jcfg, seed=seed)
    model = port_model(tcfg, tree)
    batch = make_batch(seed + 10, B, S, tcfg, masked_tail=4)
    if duplicate:
        # identical documents carry identical criteria: the tie-break decides
        rows = np.array([0, 1, 0, 2, 1, 0, 3, 3, 4, 0, 5, 1])
        batch = tuple(x[rows] for x in batch)
    return jcfg, tcfg, params, model, batch


def _criteria(jcfg, params, batch):
    out = jax.jit(lambda p, *b: j_ee_forward(p, jcfg, *b).exit_criteria)(
        params, *to_jax(batch))
    return np.asarray(out)


def _compare(jcfg, tcfg, params, model, batch, capacities, threshold,
             temperatures=None):
    j_casc = jax.jit(j_make_cascade(jcfg, capacities, threshold, temperatures))
    want = j_casc(params, *to_jax(batch))
    got = make_cascade_forward(tcfg, capacities, threshold, temperatures)(
        model, *to_torch(batch))
    np.testing.assert_array_equal(got.exit_ids.numpy(), np.asarray(want.exit_ids))
    np.testing.assert_array_equal(got.capacity_exited.numpy(),
                                  np.asarray(want.capacity_exited))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=2e-4, rtol=1e-3)
    return got


@pytest.mark.parametrize("capacities", [(B, B), (4, 2)], ids=["full", "tight"])
@pytest.mark.parametrize("per_exit", [False, True], ids=["scalar", "vector"])
def test_cascade_matches_jax_ramp(capacities, per_exit):
    jcfg, tcfg, params, model, batch = _setup(**RAMP)
    crit = _criteria(jcfg, params, batch)
    if per_exit:
        threshold = [separating_threshold(crit[e], q) for e, q in
                     zip(range(3), (0.9, 0.7, 0.5))]
    else:
        threshold = separating_threshold(crit[:-1], 0.7)
    got = _compare(jcfg, tcfg, params, model, batch, capacities, threshold)
    if capacities == (4, 2):
        assert got.capacity_exited.any()


def test_full_capacity_equals_exact_policy():
    """With capacities >= survivors the cascade is the threshold policy."""
    jcfg, tcfg, params, model, batch = _setup(**RAMP)
    out = ee_forward(model, tcfg, *to_torch(batch))
    thr = separating_threshold(out.exit_criteria[:-1].numpy(), 0.6)
    expected = decide_exits(out, tcfg.exit, thr)
    res = make_cascade_forward(tcfg, (B, B), thr)(model, *to_torch(batch))
    np.testing.assert_array_equal(res.exit_ids.numpy(), expected.numpy())
    store = out.policy_logits()
    torch.testing.assert_close(res.logits, store[expected.long(), torch.arange(B)],
                               atol=3e-5, rtol=1e-4)
    assert not res.capacity_exited.any()


@pytest.mark.parametrize("kind,exit_kwargs", [
    ("gate", dict(exits=("text_avg", 1), encoder_layer_strategy="gate")),
    ("patience", dict(exits=("text_avg", "vision_avg", 1),
                      inference_strategy="patience")),
    ("entropy", dict(exits=("vision_avg", 1), inference_strategy="entropy")),
])
@pytest.mark.parametrize("capacities", ["full", "tight"])
def test_cascade_matches_jax_heads_and_criteria(kind, exit_kwargs, capacities):
    jcfg, tcfg, params, model, batch = _setup(seed=1, **exit_kwargs)
    crit = _criteria(jcfg, params, batch)
    if kind == "patience":
        threshold = 1.5
    else:
        finite = crit[:-1][np.isfinite(crit[:-1])]
        threshold = separating_threshold(finite, 0.5)
    caps = (B, B) if capacities == "full" else (6, 4)
    _compare(jcfg, tcfg, params, model, batch, caps, threshold)


LTE = dict(exits=("text_visual_concat", "vision_avg", 1), use_lte=True,
           inference_strategy="lte")


def test_lte_cascade_matches_jax_exact_policy():
    """The JAX cascade cannot run LTE (its final stage applies the identity
    criterion to the (c, K) logits and fails to scatter them), so the port's
    LTE cascade is held against the JAX exact policy at full capacity."""
    jcfg, tcfg, params, model, batch = _setup(seed=4, **LTE)

    def run(p, *b):
        out = j_ee_forward(p, jcfg, *b)
        return out.policy_logits(), out.exit_criteria

    store, crit = (np.asarray(x) for x in jax.jit(run)(params, *to_jax(batch)))
    thr = separating_threshold(crit[:-1][np.isfinite(crit[:-1])], 0.5)
    expected = np.asarray(
        j_decide(SimpleNamespace(exit_criteria=jnp.asarray(crit)), jcfg.exit, thr))
    assert len(set(expected.tolist())) > 1
    res = make_cascade_forward(tcfg, (B, B), thr)(model, *to_torch(batch))
    np.testing.assert_array_equal(res.exit_ids.numpy(), expected)
    np.testing.assert_allclose(res.logits.numpy(), store[expected, np.arange(B)],
                               atol=2e-4, rtol=1e-3)
    tight = make_cascade_forward(tcfg, (B, 2), thr)(model, *to_torch(batch))
    n_deep = int((expected == 3).sum())
    assert int(tight.capacity_exited.sum()) == max(n_deep - 2, 0)


def test_cascade_matches_jax_with_temperatures():
    jcfg, tcfg, params, model, batch = _setup(seed=2, **RAMP)
    crit = _criteria(jcfg, params, batch)
    _compare(jcfg, tcfg, params, model, batch, (8, 8),
             separating_threshold(crit[:-1], 0.6), temperatures=(0.5, 2.0, 1.5, 1.0))


@pytest.mark.parametrize("capacities", [(6, 3), (4, 2)])
def test_duplicated_rows_tie_break_matches_jax(capacities):
    """Short batches are padded by repeating rows, so tied criteria happen;
    the port keeps the lower row first, as jax.lax.top_k does."""
    jcfg, tcfg, params, model, batch = _setup(seed=3, duplicate=True, **RAMP)
    got = _compare(jcfg, tcfg, params, model, batch, capacities, 2.0)
    assert int(got.capacity_exited.sum()) == B - capacities[1]


def test_capacities_from_distribution_matches_jax():
    dist = {0: 0.26, 1: 0.02, 2: 0.707, 3: 0.011}
    for kwargs in (dict(), dict(tail=0.995), dict(margin=1.0, multiple=4)):
        assert capacities_from_distribution(dist, 64, 2, 2, **kwargs) == \
            j_capacities(dist, 64, 2, 2, **kwargs)


def test_cascade_rejects_bad_arguments():
    _, tcfg = tiny_configs(**RAMP)
    with pytest.raises(ValueError, match="capacities"):
        make_cascade_forward(tcfg, (4,), 0.5)
    with pytest.raises(ValueError, match="thresholds"):
        make_cascade_forward(tcfg, (4, 4), [0.5, 0.5])
    with pytest.raises(ValueError, match="temperatures"):
        make_cascade_forward(tcfg, (4, 4), 0.5, temperatures=(1.0,))

