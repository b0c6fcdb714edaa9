"""PyTorch port, ``utils/profiling.py`` and ``evaluation/analysis.py::
xla_flops`` against the JAX package's: the FLOPs of a matmul, a grouped
convolution and a tiny model's forward as ``FlopCounterMode`` counts them
beside XLA's cost analysis of the same function, ``runtime_wrapper``,
``profile_trace`` (a Chrome trace on disk) and ``DeviceTimer``."""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from multi_modal_early_exit_tpu.evaluation import analysis as JA
from multi_modal_early_exit_tpu.utils import profiling as JP
from multi_modal_early_exit_tpu_torch.evaluation import analysis as TA
from multi_modal_early_exit_tpu_torch.utils import profiling as TP

torch.set_num_threads(2)


def _matmul(rng):
    a = rng.standard_normal((24, 40)).astype(np.float32)
    b = rng.standard_normal((40, 16)).astype(np.float32)
    return (lambda x, y: x @ y), (lambda x, y: x @ y), (a, b)


def _conv(rng, padding=0):
    x = rng.standard_normal((2, 8, 12, 12)).astype(np.float32)
    w = rng.standard_normal((16, 4, 3, 3)).astype(np.float32)  # 2 groups

    def jconv(x, w):
        return jax.lax.conv_general_dilated(x, w, (2, 2), [(padding, padding)] * 2,
                                            dimension_numbers=("NCHW", "OIHW", "NCHW"),
                                            feature_group_count=2)

    return jconv, (lambda x, w: F.conv2d(x, w, stride=2, padding=padding, groups=2)), (x, w)


@pytest.mark.parametrize("case", [_matmul, _conv])
def test_flops_match_xla_cost_analysis(case):
    """Two FLOPs a multiply-add on both sides: the port's count equals
    XLA's for a matmul and a strided grouped convolution."""
    jfn, tfn, args = case(np.random.default_rng(0))
    want = JA.xla_flops(jfn, *(jnp.asarray(a) for a in args))
    got = TA.xla_flops(tfn, *(torch.from_numpy(a) for a in args))
    assert got == want > 0
    cost = TP.compiled_cost(tfn, *(torch.from_numpy(a) for a in args))
    assert cost["flops"] == got
    out = tfn(*(torch.from_numpy(a) for a in args))
    assert cost["output_size_bytes"] == out.numel() * 4
    assert JP.compiled_cost(jfn, *(jnp.asarray(a) for a in args))["flops"] == want


def test_padded_convolution_counts_every_tap():
    """With zero padding the counts differ: XLA counts the taps that fall
    inside the image, ``FlopCounterMode`` every tap of every output."""
    jfn, tfn, args = _conv(np.random.default_rng(1), padding=1)
    want = JA.xla_flops(jfn, *(jnp.asarray(a) for a in args))
    got = TA.xla_flops(tfn, *(torch.from_numpy(a) for a in args))
    assert got == 2 * (2 * 16 * 6 * 6) * (4 * 3 * 3) > want


def test_model_flops_count_the_matmuls():
    """A tiny LayoutLMv3 forward: the port's count is the sum of its
    projections', MLPs' and attention products' multiply-adds, twice."""
    from _torch_parity import jax_params, make_batch, port_model, tiny_configs
    from multi_modal_early_exit_tpu_torch.models.ee.model import ee_forward

    jcfg, tcfg = tiny_configs(exits=())
    model = port_model(tcfg, jax_params(jcfg)[1])
    b, s = 2, 12
    batch = [torch.from_numpy(x) for x in make_batch(0, b, s, tcfg)]
    with torch.no_grad():
        flops = TA.xla_flops(lambda *a: ee_forward(model, tcfg, *a).logits, *batch)
    bb = tcfg.backbone
    h, seq = bb.hidden_size, s + bb.num_visual_tokens
    per_layer = 4 * seq * h * h + 2 * seq * h * bb.intermediate_size + 2 * seq * seq * h
    patches = (bb.num_visual_tokens - 1) * 3 * bb.patch_size ** 2 * h
    classifier = h * h + h * bb.num_labels
    assert flops == 2 * b * (bb.num_hidden_layers * per_layer + patches + classifier)


def test_xla_flops_is_none_when_the_call_fails():
    def broken(x):
        raise RuntimeError("no")

    assert TA.xla_flops(broken, torch.ones(2)) is None
    assert JA.xla_flops(lambda x: x @ jnp.ones((3, 3)), jnp.ones(2)) is None


def test_runtime_wrapper_returns_the_result_and_seconds():
    result, seconds = TP.runtime_wrapper(lambda x, k=1: x + k)(2, k=3)
    want, _ = JP.runtime_wrapper(lambda x, k=1: x + k)(2, k=3)
    assert result == want == 5 and seconds >= 0.0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with TP.profile_trace(log_dir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def test_device_timer_counts_iterations():
    calls = []
    timer = TP.DeviceTimer(lambda x: calls.append(x), k=4)
    out = timer.measure(7, n_calls=3, warmup=2)
    assert calls == [7] * 5
    assert out["iterations"] == 12 and out["seconds"] >= 0.0
    assert out["sec_per_iteration"] == pytest.approx(out["seconds"] / 12)
    assert set(out) == set(JP.TunnelSafeTimer(lambda: 0.0, 4).measure(n_calls=1, warmup=0))
