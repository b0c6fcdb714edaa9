"""PyTorch port, base-config golden parity: EE LayoutLMv3-base (12 layers,
hidden 768, 512 text + 197 visual tokens) with the JAX package's
``init_params(key(42))`` weights carried into the port by
``load_jax_params``, against the stored outputs of
tests/golden/layoutlmv3_base_golden.npz at the bars of
tests/test_golden_base.py: the classifier's logits (atol 2e-4, rtol 1e-3)
and every per-layer [CLS] tap and the last hidden [CLS] state (atol 5e-4,
rtol 1e-3). f32 on the CPU; slow (a base-size forward in both packages'
set-up).
"""

import os

import numpy as np
import pytest
import torch

import jax

from multi_modal_early_exit_tpu.config.exit_config import ExitConfig as JExitConfig
from multi_modal_early_exit_tpu.models.ee.model import init_ee_params as j_init_ee
from multi_modal_early_exit_tpu.models.layoutlmv3.config import (
    EEModelConfig as JEEModelConfig,
    LayoutLMv3Config as JLayoutLMv3Config,
)
from multi_modal_early_exit_tpu.models.layoutlmv3.modeling import init_params as j_init
from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig
from multi_modal_early_exit_tpu_torch.models.ee.model import EEModel, ee_forward
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import (
    EEModelConfig,
    LayoutLMv3Config,
)
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.convert import load_jax_params
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import backbone_apply

pytestmark = pytest.mark.slow

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "layoutlmv3_base_golden.npz")
EXITS = ("text_avg", "vision_avg", 7)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def base(golden):
    """The port's EE model at base size holding the golden's backbone
    weights (JAX ``init_params`` at the golden's seed) and JAX-initialised
    exit heads, and the golden's batch as tensors."""
    jcfg = JEEModelConfig(backbone=JLayoutLMv3Config.base(num_labels=16),
                          exit=JExitConfig(exits=EXITS))
    tree = j_init_ee(jax.random.key(0), jcfg)
    tree["backbone"] = j_init(jax.random.key(int(golden["jax_seed"])), jcfg.backbone)
    tree = jax.tree.map(np.asarray, tree)
    cfg = EEModelConfig(backbone=LayoutLMv3Config.base(num_labels=16),
                        exit=ExitConfig(exits=EXITS))
    model = load_jax_params(EEModel(cfg, device="cpu"), tree)
    batch = [torch.from_numpy(golden[k]) for k in
             ("input_ids", "bbox", "pixel_values", "attention_mask")]
    return cfg, model, batch


def test_port_base_logits_match_the_golden(base, golden):
    cfg, model, batch = base
    with torch.inference_mode():
        out = ee_forward(model, cfg, *batch)
    assert out.policy_logits().shape == (4, 2, 16)
    np.testing.assert_allclose(out.logits.numpy(), golden["logits"], atol=2e-4, rtol=1e-3)


def test_port_base_cls_taps_match_the_golden(base, golden):
    cfg, model, batch = base
    with torch.inference_mode():
        out = backbone_apply(model.backbone, cfg.backbone, *batch, collect_cls=True)
    got = torch.stack(list(out.cls_per_layer)).numpy()
    assert got.shape == golden["cls_per_layer"].shape
    np.testing.assert_allclose(got, golden["cls_per_layer"], atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(out.last_hidden_state[:, 0, :].numpy(), golden["last_hidden_cls"],
                               atol=5e-4, rtol=1e-3)
