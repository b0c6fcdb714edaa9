"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; the
port's parameters are the JAX package's ``init_ee_params`` carried over by
the weight bridge, so both sides compute with identical numbers.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from multi_modal_early_exit_tpu.config.exit_config import ExitConfig as JExitConfig
from multi_modal_early_exit_tpu.models.ee.model import init_ee_params as j_init
from multi_modal_early_exit_tpu.models.layoutlmv3.config import (
    EEModelConfig as JEEModelConfig,
    LayoutLMv3Config as JLayoutLMv3Config,
)
from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig
from multi_modal_early_exit_tpu_torch.models.ee.model import EEModel
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import (
    EEModelConfig,
    LayoutLMv3Config,
)
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.convert import load_jax_params

# the suite runs several workers; keep each one's intra-op pool small
torch.set_num_threads(2)


def tiny_configs(num_labels=4, **exit_kwargs):
    """(JAX config, port config) of the tiny model with the same exits."""
    jcfg = JEEModelConfig(
        backbone=JLayoutLMv3Config.tiny(num_labels=num_labels),
        exit=JExitConfig(**exit_kwargs),
    )
    tcfg = EEModelConfig(
        backbone=LayoutLMv3Config.tiny(num_labels=num_labels),
        exit=ExitConfig(**exit_kwargs),
    )
    return jcfg, tcfg


def jax_params(jcfg, seed=0):
    """(JAX parameter tree, the same tree as numpy arrays)."""
    params = jax.jit(lambda k: j_init(k, jcfg))(jax.random.key(seed))
    return params, jax.tree.map(np.asarray, params)


def port_model(tcfg, tree):
    """The port's EEModel on the CPU holding the JAX parameters."""
    return load_jax_params(EEModel(tcfg, device="cpu"), tree)


def make_batch(seed, B, S, cfg, masked_tail=0):
    """numpy (input_ids, bbox, pixel_values, attention_mask)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.backbone.vocab_size, (B, S)).astype(np.int32)
    bbox = np.sort(rng.integers(0, 1000, (B, S, 4)), -1).astype(np.int32)
    px = rng.standard_normal(
        (B, 3, cfg.backbone.input_size, cfg.backbone.input_size)
    ).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    if masked_tail:
        mask[0, -masked_tail:] = 0
        ids[0, -masked_tail:] = cfg.backbone.pad_token_id
    return ids, bbox, px, mask


def to_jax(batch):
    return tuple(jnp.asarray(x) for x in batch)


def to_torch(batch):
    return tuple(torch.from_numpy(x) for x in batch)


def separating_threshold(values, q, window=0.15):
    """A threshold near the q-quantile of ``values``: the midpoint of the
    widest gap between neighbouring values whose lower end lies within
    ``window`` of that quantile, so f32 differences between the two
    packages cannot move a value across it."""
    v = np.unique(np.asarray(values, np.float64).ravel())
    n = len(v) - 1
    lo = int(np.clip(round((q - window) * n), 0, n - 1))
    hi = int(np.clip(round((q + window) * n), lo + 1, n))
    k = lo + int(np.argmax(np.diff(v[lo:hi + 1])))
    return float((v[k] + v[k + 1]) / 2)


def no_dropout(jcfg, tcfg):
    """The two configs with every dropout rate 0, so that a training forward
    (``deterministic=False``) is comparable across the two packages, whose
    random streams differ."""
    rates = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                 classifier_dropout=0.0)
    return (jcfg.replace(backbone=jcfg.backbone.replace(**rates)),
            tcfg.replace(backbone=tcfg.backbone.replace(**rates)))


def train_batch(seed, B, S, cfg, masked_tail=0):
    """A numpy training batch: make_batch's arrays plus labels."""
    ids, bbox, px, mask = make_batch(seed, B, S, cfg, masked_tail)
    labels = np.random.default_rng(seed + 1).integers(0, cfg.backbone.num_labels, B)
    return dict(input_ids=ids, bbox=bbox, pixel_values=px, attention_mask=mask,
                labels=labels.astype(np.int32))


def assert_state_close(got, want_tree, tol, what=""):
    """``got`` (port name -> tensor) against a JAX tree of the same
    parameters: each tensor within ``tol`` of its own largest value, plus
    1e-9 for tensors whose true value is zero (the key bias gradient)."""
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.convert import (
        jax_tree_to_state_dict,
    )

    want = jax_tree_to_state_dict(jax.tree.map(np.asarray, want_tree))
    assert set(got) == set(want), what
    for name, a in got.items():
        w = want[name]
        np.testing.assert_allclose(
            a.detach().to(torch.float32).numpy(), w,
            atol=tol * np.abs(w).max() + 1e-9, rtol=tol, err_msg=f"{what} {name}",
        )
