"""PyTorch port, cascade vs the JAX cascade's kernel path: the Pallas bias
kernel and packed flash attention run in interpret mode (the setup of
tests/test_cascade.py::test_cascade_with_flash_kernels_matches_xla_path)."""

import numpy as np
import torch

import jax

from _torch_parity import (
    jax_params,
    make_batch,
    port_model,
    tiny_configs,
    to_jax,
    to_torch,
)
from multi_modal_early_exit_tpu.models.ee.cascade import (
    make_cascade_forward as j_make_cascade,
)
from multi_modal_early_exit_tpu_torch.models.ee.cascade import make_cascade_forward
from multi_modal_early_exit_tpu_torch.models.ee.model import ee_forward

torch.set_num_threads(2)


def _widest_gap_threshold(values):
    """Midpoint of the widest gap between neighbouring criterion values (the
    kernel path quantizes the bias table lookups to bf16, so a decision is
    only comparable away from the threshold)."""
    v = np.unique(values)
    k = int(np.argmax(np.diff(v)))
    return float((v[k] + v[k + 1]) / 2), float(v[k + 1] - v[k])


def test_port_cascade_matches_jax_kernel_path(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu

    import multi_modal_early_exit_tpu.models.ee.cascade as cascade_mod
    from multi_modal_early_exit_tpu.ops import flash_attention as fa_mod

    jcfg, tcfg = tiny_configs(exits=("text_avg", "vision_avg", 1))
    _, tree = jax_params(jcfg, seed=0)
    # sharpen the heads so the confidences spread over (1/K, 1)
    for head in (*tree["embedding_exits"].values(), tree["encoder_exits"],
                 tree["backbone"]["classifier"]):
        head["out_proj"]["kernel"] = head["out_proj"]["kernel"] * 40.0
    params = jax.tree.map(jax.numpy.asarray, tree)
    model = port_model(tcfg, tree)
    B = 8
    batch = make_batch(9, B, 20, tcfg, masked_tail=4)

    crit = ee_forward(model, tcfg, *to_torch(batch)).exit_criteria[:-1].numpy()
    threshold, gap = _widest_gap_threshold(crit)
    assert gap > 0.02

    monkeypatch.setattr(fa_mod, "use_flash_attention", lambda: True)
    # cascade binds the gate at import; patch its name too
    monkeypatch.setattr(cascade_mod, "use_flash_attention", lambda: True)
    for caps in ((B, B), (6, 3)):
        with pltpu.force_tpu_interpret_mode():
            want = j_make_cascade(jcfg, caps, threshold)(params, *to_jax(batch))
        got = make_cascade_forward(tcfg, caps, threshold)(model, *to_torch(batch))
        np.testing.assert_array_equal(got.exit_ids.numpy(), np.asarray(want.exit_ids))
        np.testing.assert_array_equal(got.capacity_exited.numpy(),
                                      np.asarray(want.capacity_exited))
        np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                                   atol=5e-2, rtol=5e-2)
