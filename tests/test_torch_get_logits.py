"""PyTorch port, the logit harvest and the calibrate-evaluate steps after it,
against the JAX package's ``evaluation/pipeline.py`` on the tiny config: the
JAX ``init_ee_params`` carried into the port by ``load_jax_params``, both
packages' ``get_logits`` over ``synthetic_rvl_cdip_tiny``, the files each
dumps read by the other, the cache, and ``calibrate`` -> ``eval_model`` on
both packages' stores. The port runs on the CPU here (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

from multi_modal_early_exit_tpu.data import datasets as jds
from multi_modal_early_exit_tpu.evaluation import pipeline as jpipe
from multi_modal_early_exit_tpu.evaluation import policy as jpolicy
from multi_modal_early_exit_tpu_torch.data import datasets as tds
from multi_modal_early_exit_tpu_torch.evaluation import pipeline as tpipe
from multi_modal_early_exit_tpu_torch.evaluation import policy as tpolicy
from multi_modal_early_exit_tpu_torch.models.ee.model import ee_forward

from _torch_parity import jax_params, port_model, tiny_configs

STORE_TOL = dict(atol=2e-4, rtol=1e-3)  # the north star's f32 bars
VOCAB = 50265  # load_tokenizer()'s vocabulary


@pytest.fixture(scope="module")
def harvested(tmp_path_factory):
    """Both packages' stores of the tiny config's test and validation
    splits (4 exits: text_avg, vision_avg, layer 1, the classifier)."""
    jcfg, tcfg = tiny_configs(exits=("text_avg", "vision_avg", 1))
    # the datasets' token ids span the hash tokenizer's vocabulary (JAX
    # clamps an id past the embedding table; torch raises)
    jcfg = jcfg.replace(backbone=jcfg.backbone.replace(vocab_size=VOCAB))
    tcfg = tcfg.replace(backbone=tcfg.backbone.replace(vocab_size=VOCAB))
    params, tree = jax_params(jcfg, seed=3)
    model = port_model(tcfg, tree)
    root = tmp_path_factory.mktemp("harvest")
    out = {}
    for split in ("test", "validation"):
        tdata = tds.build_dataset("synthetic_rvl_cdip_tiny", split)
        jdata = jds.build_dataset("synthetic_rvl_cdip_tiny", split)
        config = {"checkpoint": "tiny", "test_dataset": "synthetic_rvl_cdip_tiny",
                  "labelset": split}
        out[split] = (
            tpipe.get_logits(model, tcfg, tdata, dict(config), batch_size=3,
                             root=str(root / "port"), device="cpu"),
            jpipe.get_logits(params, jcfg, jdata, dict(config), batch_size=3,
                             root=str(root / "jax")),
        )
    return out, model, tcfg, root


def test_stores_agree_with_the_jax_package(harvested):
    out, _, _, _ = harvested
    for split, ((store, refs, stats), (jstore, jrefs, _)) in out.items():
        assert store.dtype == np.float64 and store.shape == jstore.shape == (4, 8, 4)
        np.testing.assert_array_equal(refs, jrefs)
        np.testing.assert_allclose(store, jstore, err_msg=split, **STORE_TOL)
        assert set(stats) == {"batch_time_avg", "docs_per_sec"} and stats["docs_per_sec"] > 0


def test_the_store_is_the_direct_forward_on_the_real_rows(harvested):
    """The padded last batch's extra rows are dropped by ``sample_mask``;
    each row is ``ee_forward(...).policy_logits()`` of its document."""
    out, model, tcfg, _ = harvested
    store = out["test"][0][0]
    data = tds.build_dataset("synthetic_rvl_cdip_tiny", "test")
    cols = [torch.from_numpy(data.arrays[k]) for k in
            ("input_ids", "bbox", "pixel_values", "attention_mask")]
    with torch.inference_mode():
        want = ee_forward(model, tcfg, *cols).policy_logits().double().numpy()
    np.testing.assert_allclose(store, want, rtol=0, atol=1e-5)


def test_dumped_stores_load_in_the_other_package(harvested):
    """evaluate_checkpoint of each package on the other's directory."""
    out, _, _, root = harvested
    for mine, other in (("port", jpipe), ("jax", tpipe)):
        res = other.evaluate_checkpoint(str(root / mine / "tiny-synthetic_rvl_cdip_tiny"))
        assert len(res["fixed"]) == 4 * 7 and len(res["adaptive_exits"]) == 100


def test_the_cache_is_read_back(harvested):
    out, model, tcfg, root = harvested
    data = tds.build_dataset("synthetic_rvl_cdip_tiny", "test")
    config = {"checkpoint": "tiny", "test_dataset": "synthetic_rvl_cdip_tiny",
              "labelset": "test"}
    store, refs, stats = tpipe.get_logits(model, tcfg, data, config, batch_size=3,
                                          root=str(root / "port"), device="cpu")
    assert stats == {}
    np.testing.assert_array_equal(store, out["test"][0][0])
    np.testing.assert_array_equal(refs, out["test"][0][1])


def _msp(store):
    z = np.exp(store - store.max(-1, keepdims=True))
    return (z / z.sum(-1, keepdims=True)).max(-1)


def test_calibrate_then_eval_model_matches_the_jax_package(harvested, tmp_path):
    """Both packages' stores through their own ``calibrate`` and
    ``eval_model``: finite, positive temperatures, which differ by the
    stores' f32 differences amplified by an 8-document fit (1.2e-3 read
    here, held within 1e-2), and each policy's exits equal for the
    documents whose calibrated MSPs lie on the same side of the threshold,
    more than 1e-3 from it, in both packages' stores at every exit."""
    out, _, _, _ = harvested
    (tt, tr, _), (jt, jr, _) = out["test"]
    (tv, tvr, _), (jv, jvr, _) = out["validation"]
    base = {"checkpoint": "cal", "test_dataset": "tiny", "exit_threshold": 0.5,
            "epsilon": 0.1}
    tcfg_, jcfg_ = dict(base), dict(base)
    tcal = tpipe.calibrate(tt, tv, tvr, tcfg_, root=str(tmp_path / "port"))
    jcal = jpipe.calibrate(jt, jv, jvr, jcfg_, root=str(tmp_path / "jax"))
    temps = np.asarray(tcfg_["calibration_metrics"]["temperature"])
    assert np.all(np.isfinite(temps)) and np.all(temps > 0)
    np.testing.assert_allclose(temps, jcfg_["calibration_metrics"]["temperature"], rtol=1e-2)
    tmsp, jmsp = _msp(tcal), _msp(jcal)
    checked = 0
    for policy in ("max_confidence_global_thresholding_policy", "patience_policy"):
        for threshold in (0.3, 0.5, 0.7):
            t = threshold if policy != "patience_policy" else 1
            tc = dict(tcfg_, exit_policy=policy, exit_threshold=t)
            jc = dict(jcfg_, exit_policy=policy, exit_threshold=t)
            got = tpipe.eval_model(tcal, tr, tc)
            want = jpipe.eval_model(jcal, jr, jc)
            far = np.all((np.abs(tmsp - threshold) > 1e-3) & (np.abs(jmsp - threshold) > 1e-3)
                         & ((tmsp > threshold) == (jmsp > threshold)), axis=0)
            texits = getattr(tpolicy.Policy(tcal, tc), policy)()[0]
            jexits = getattr(jpolicy.Policy(jcal, jc), policy)()[0]
            np.testing.assert_array_equal(texits[far], jexits[far])
            checked += int(far.sum())
            if far.all():
                assert got["exit_distribution"] == want["exit_distribution"]
                assert got["average_exit"] == want["average_exit"]
    assert checked >= 24  # most of the 6 x 8 (policy, document) pairs


def test_get_logits_needs_a_card_or_the_cpu(harvested):
    _, model, tcfg, root = harvested
    data = tds.build_dataset("synthetic_rvl_cdip_tiny", "test")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipe.get_logits(model, tcfg, data, {}, root=str(root / "none"), use_cache=False)


def test_dense_layoutlmv2_harvest_matches_jax(tmp_path):
    """The dense branch: both packages' ``get_logits`` of a tiny LayoutLMv2
    (the JAX parameters carried into the port) write a single-row (1, N, K)
    float64 store, equal within the f32 bars, and the same references."""
    import jax

    from multi_modal_early_exit_tpu.models.layoutlmv2 import modeling as JM
    from multi_modal_early_exit_tpu.models.layoutlmv2.config import LayoutLMv2Config as JC
    from multi_modal_early_exit_tpu_torch.models.layoutlmv2 import modeling as TM
    from multi_modal_early_exit_tpu_torch.models.layoutlmv2.config import LayoutLMv2Config as TC
    from multi_modal_early_exit_tpu_torch.models.layoutlmv2.convert import load_jax_params

    jcfg, tcfg = JC.tiny().replace(vocab_size=VOCAB), TC.tiny().replace(vocab_size=VOCAB)
    params = JM.init_params(jax.random.key(2), jcfg)
    model = load_jax_params(TM.LayoutLMv2Model(tcfg, device="cpu"),
                            jax.tree.map(np.asarray, params))
    config = {"checkpoint": "v2", "test_dataset": "synthetic_rvl_cdip_tiny", "labelset": "test"}
    store, refs, _ = tpipe.get_logits(
        model, tcfg, tds.build_dataset("synthetic_rvl_cdip_tiny", "test"), dict(config),
        batch_size=3, root=str(tmp_path / "port"), device="cpu")
    jstore, jrefs, _ = jpipe.get_logits(
        params, jcfg, jds.build_dataset("synthetic_rvl_cdip_tiny", "test"), dict(config),
        batch_size=3, root=str(tmp_path / "jax"))
    assert store.dtype == jstore.dtype == np.float64 and store.shape == jstore.shape == (1, 8, 4)
    np.testing.assert_array_equal(refs, jrefs)
    np.testing.assert_allclose(store, jstore, **STORE_TOL)
