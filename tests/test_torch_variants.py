"""PyTorch port, the single-modality variants against the JAX package's on
the tiny config: ``dit``'s image-only forward (no bias: the attention
composed of torch ops, as the JAX package composes it in XLA), ``bert``'s
text-only forward (the 1D relative bias, zero spatial tables), the dense
LayoutLMv3 forward, the pruned towers, and a few
optimizer steps in which the loss drops (JAX
tests/test_variants_functional.py:141). The JAX parameters are carried into
the port; f32 bars: logits atol 2e-4 / rtol 1e-3, hidden states 5e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from multi_modal_early_exit_tpu.data.datasets import synthetic_documents
from multi_modal_early_exit_tpu.models.layoutlmv3 import modeling as JM
from multi_modal_early_exit_tpu.models.layoutlmv3.config import LayoutLMv3Config as JCfg
from multi_modal_early_exit_tpu_torch.models.layoutlmv3 import modeling as TM
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import LayoutLMv3Config as TCfg
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.convert import (
    jax_tree_to_state_dict,
    load_jax_params,
)

torch.set_num_threads(2)

LOGITS = dict(atol=2e-4, rtol=1e-3)
HIDDEN = dict(atol=5e-4, rtol=1e-3)
TOWERS = {"dit": dict(with_text=False), "bert": dict(with_vision=False),
          "layoutlmv3": dict()}
FIELDS = {"dit": dict(has_relative_attention_bias=False, has_spatial_attention_bias=False),
          "bert": dict(has_spatial_attention_bias=False), "layoutlmv3": dict()}


def _backbones(name, seed=0, **fields):
    """(JAX config, port config, JAX params, the port's backbone holding
    them) of the tiny variant."""
    jcfg = JCfg.tiny(num_labels=4).replace(**FIELDS[name], **fields)
    tcfg = TCfg.tiny(num_labels=4).replace(**FIELDS[name], **fields)
    params = JM.init_params(jax.random.key(seed), jcfg, **TOWERS[name])
    model = TM.LayoutLMv3Model(tcfg, device="cpu", **TOWERS[name])
    return jcfg, tcfg, params, load_jax_params(model, jax.tree.map(np.asarray, params))


def _inputs(seed=0, b=3, s=12, masked_tail=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 1000, (b, s)).astype(np.int32)
    bbox = np.sort(rng.integers(0, 1000, (b, s, 4)), -1).astype(np.int32)
    px = rng.standard_normal((b, 3, 32, 32)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[0, -masked_tail:] = 0
    return ids, bbox, px, mask


def test_dit_forward_matches_jax():
    jcfg, tcfg, params, model = _backbones("dit")
    px = _inputs()[2]
    want = JM.forward_image_classification(params, jcfg, jnp.asarray(px))
    vis = JM.embed_vision(params["visual"], jcfg, jnp.asarray(px))
    want_hidden, _, _ = JM.encoder_apply(params["encoder"], jcfg, vis, attn_bias=None)
    with torch.no_grad():
        got = TM.forward_image_classification(model, tcfg, torch.from_numpy(px))
        hidden, _, _ = TM.encoder_apply(model.encoder, tcfg,
                                        TM.embed_vision(model.visual, tcfg, torch.from_numpy(px)),
                                        None, collect_cls=False)
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_hidden), **HIDDEN)


@pytest.mark.parametrize("layout", [False, True])
def test_bert_forward_matches_jax(layout):
    """With the default zero boxes (plain BERT) and with word boxes, a
    masked tail on the first document."""
    jcfg, tcfg, params, model = _backbones("bert", seed=1)
    ids, bbox, _, mask = _inputs(seed=2)
    kwargs = dict(bbox=bbox) if layout else {}
    want = JM.forward_text_classification(
        params, jcfg, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        **{k: jnp.asarray(v) for k, v in kwargs.items()})
    with torch.no_grad():
        got = TM.forward_text_classification(
            model, tcfg, torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
            **{k: torch.from_numpy(v) for k, v in kwargs.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def test_dense_layoutlmv3_forward_matches_jax():
    jcfg, tcfg, params, model = _backbones("layoutlmv3", seed=3)
    batch = _inputs(seed=4)
    want = JM.forward_sequence_classification(params, jcfg, *map(jnp.asarray, batch))
    with torch.no_grad():
        got = TM.forward_sequence_classification(model, tcfg, *map(torch.from_numpy, batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def test_dit_attention_dropout_uses_the_seeds():
    """At attention dropout above 0 a training forward differs from the
    deterministic one and repeats itself from the same generator state."""
    _, tcfg, _, model = _backbones("dit", attention_probs_dropout_prob=0.5,
                                   hidden_dropout_prob=0.0, classifier_dropout=0.0)
    px = torch.from_numpy(_inputs()[2])
    with torch.no_grad():
        det = TM.forward_image_classification(model, tcfg, px)
        a = TM.forward_image_classification(model, tcfg, px, deterministic=False,
                                            rng=torch.Generator().manual_seed(3))
        b = TM.forward_image_classification(model, tcfg, px, deterministic=False,
                                            rng=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.allclose(a, det)


@pytest.mark.parametrize("name,towers", [
    ("dit", {"visual", "encoder", "classifier"}),
    ("bert", {"embeddings", "encoder", "classifier"}),
])
def test_pruned_trees_match_jax(name, towers):
    """``init_params(with_text=False)`` / ``(with_vision=False)``: the JAX
    tree's names and shapes (no unused tower, no post-concat LayerNorm,
    no bias tables the config lacks), from the port's own random init."""
    jcfg = JCfg.tiny(num_labels=4).replace(**FIELDS[name])
    tcfg = TCfg.tiny(num_labels=4).replace(**FIELDS[name])
    params = JM.init_params(jax.random.key(0), jcfg, **TOWERS[name])
    model = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu",
                           **TOWERS[name])
    assert set(params) == towers
    assert {n for n, _ in model.named_children()} == towers
    want = {k: v.shape for k, v in jax_tree_to_state_dict(jax.tree.map(np.asarray, params)).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want


@pytest.mark.parametrize("name", ["dit", "bert"])
def test_variant_trains_like_jax(name):
    """15 Adam steps at lr 3e-3 on 16 synthetic documents (the JAX test's
    recipe at a larger rate), from the same parameters: each loss within
    1e-4 of JAX's, and the last under 0.9 of the first."""
    fields = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    jcfg, tcfg, params, model = _backbones(name, seed=5, **fields)
    docs = synthetic_documents(16, num_labels=4, seq_len=16, image_size=32, seed=3)
    docs["input_ids"] = docs["input_ids"] % 1024  # the tiny vocabulary
    keys = ("pixel_values",) if name == "dit" else ("input_ids", "bbox", "attention_mask")
    jfwd, tfwd = ((JM.forward_image_classification, TM.forward_image_classification)
                  if name == "dit" else
                  (JM.forward_text_classification, TM.forward_text_classification))
    labels = docs["labels"]

    def jloss(p):
        logp = jax.nn.log_softmax(jfwd(p, jcfg, *(jnp.asarray(docs[k]) for k in keys)))
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], 1))

    tx = optax.adam(3e-3)
    opt = tx.init(params)

    @jax.jit
    def step(p, o):
        loss, grads = jax.value_and_grad(jloss)(p)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    adam = torch.optim.Adam(model.parameters(), lr=3e-3)
    inputs = [torch.tensor(docs[k]) for k in keys]
    target = torch.tensor(labels).long()
    want, got = [], []
    for _ in range(15):
        params, opt, loss = step(params, opt)
        want.append(float(loss))
        t_loss = torch.nn.functional.cross_entropy(tfwd(model, tcfg, *inputs), target)
        adam.zero_grad()
        t_loss.backward()
        adam.step()
        got.append(t_loss.item())
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.isfinite(got).all() and got[-1] < 0.9 * got[0], got
