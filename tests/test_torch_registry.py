"""PyTorch port, the model registry (``models/registry.py``) against the
JAX package's: the same backbone config and the same parameter names and
shapes from ``build_model`` (the weights differ: the two packages' random
generators differ), ``infer_backbone_config`` on the JAX parameters and on
the port's conversion of them, ``pad_embedding_tables``, and
``_maybe_load_pretrained`` of a random tiny HuggingFace ``LayoutLMv3Model``
written here with ``save_pretrained`` (nothing is downloaded)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from multi_modal_early_exit_tpu.config.experiment import parse_cli as j_parse_cli
from multi_modal_early_exit_tpu.models import registry as JR
from multi_modal_early_exit_tpu.models.layoutlmv3.config import (
    LayoutLMv3Config as JLayoutLMv3Config,
)
from multi_modal_early_exit_tpu_torch.config.experiment import parse_cli
from multi_modal_early_exit_tpu_torch.models import registry as TR
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import LayoutLMv3Config
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.convert import jax_tree_to_state_dict

torch.set_num_threads(2)

TINY = ["debugEE", "with", "model_weights=", "exits=text_avg,vision_avg,1"]


def _configs(argv):
    return j_parse_cli(list(argv)), parse_cli(list(argv) + ["with", "device=cpu"])


def _fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("model", ["EElayoutlmv3", "LTElayoutlmv3", "layoutlmv3"])
def test_build_model_matches_jax_structure(model):
    jcfg, tcfg = _configs(TINY + [f"model={model}"])
    kwargs = dict(num_labels=4, image_size=32, seq_len=64)
    j_model_cfg, params = JR.build_model(jcfg, rng=jax.random.key(0), **kwargs)
    t_model_cfg, t_model = TR.build_model(tcfg, **kwargs)
    assert _fields(t_model_cfg.backbone) == _fields(j_model_cfg.backbone)
    assert t_model_cfg.exit.to_dict() == j_model_cfg.exit.to_dict()
    want = {k: v.shape for k, v in jax_tree_to_state_dict(jax.tree.map(np.asarray, params)).items()}
    got = {k: tuple(v.shape) for k, v in t_model.state_dict().items()}
    assert got == want
    assert all(v.device.type == "cpu" for v in t_model.state_dict().values())


@pytest.mark.parametrize("argv,kwargs", [
    (["with", "model_size=base", "scan_fold=12"], dict(num_labels=16)),
    (["with", "model_size=base"], dict(num_labels=7, image_size=128, seq_len=600)),
    (["debugEE"], dict(num_labels=4, image_size=32, seq_len=64)),
])
def test_backbone_config_matches_jax(argv, kwargs):
    jcfg, tcfg = _configs(argv)
    want = JR._backbone_config(jcfg, kwargs.get("num_labels"), kwargs.get("image_size"),
                               kwargs.get("seq_len"))
    got = TR._backbone_config(tcfg, kwargs.get("num_labels"), kwargs.get("image_size"),
                              kwargs.get("seq_len"))
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("model", ["pix2struct"])
def test_models_the_port_lacks_raise(model):
    _, tcfg = _configs(TINY + [f"model={model}"])
    with pytest.raises(NotImplementedError, match="pix2"):
        TR.build_model(tcfg, num_labels=4)
    with pytest.raises(ValueError, match="unknown model"):
        TR.build_model(tcfg.replace(model="nonsense"), num_labels=4)


@pytest.mark.parametrize("model", ["dit", "dit_rvl", "bert", "layoutlmv2"])
def test_build_model_variants_match_jax(model):
    """The variants the port once refused: the JAX registry's config (for
    dit no relative or spatial bias, for bert no spatial bias, no exits;
    for layoutlmv2 its own config with the widened vocabulary) and its
    parameter names and shapes (dit without the text tower, bert without
    the visual one), on the CPU when asked."""
    jcfg, tcfg = _configs(TINY + [f"model={model}"])
    kwargs = dict(num_labels=4, image_size=32, seq_len=64)
    j_model_cfg, params = JR.build_model(jcfg, rng=jax.random.key(0), **kwargs)
    t_model_cfg, t_model = TR.build_model(tcfg, **kwargs)
    if model == "layoutlmv2":
        assert _fields(t_model_cfg) == _fields(j_model_cfg)
        assert t_model_cfg.vocab_size == 50265
    else:
        assert _fields(t_model_cfg.backbone) == _fields(j_model_cfg.backbone)
        assert t_model_cfg.exit.to_dict() == j_model_cfg.exit.to_dict()
        assert t_model_cfg.num_exits == 0
    want = {k: v.shape for k, v in jax_tree_to_state_dict(jax.tree.map(np.asarray, params)).items()}
    got = {k: tuple(v.shape) for k, v in t_model.state_dict().items()}
    assert got == want
    assert all(v.device.type == "cpu" for v in t_model.state_dict().values())


@pytest.mark.parametrize("model", ["EElayoutlmv3", "layoutlmv3"])
def test_infer_backbone_config_matches_jax(model):
    jcfg, _ = _configs(TINY + [f"model={model}"])
    j_model_cfg, params = JR.build_model(jcfg.replace(model_size="tiny"), num_labels=4,
                                         num_hidden_layers=3, image_size=32, seq_len=64,
                                         rng=jax.random.key(1))
    state = {k: torch.tensor(v) for k, v in
             jax_tree_to_state_dict(jax.tree.map(np.asarray, params)).items()}
    base_j, base_t = JLayoutLMv3Config.tiny(), LayoutLMv3Config.tiny()
    want = JR.infer_backbone_config(params, base_j)
    got = TR.infer_backbone_config(state, base_t)
    assert _fields(got) == _fields(want) == _fields(j_model_cfg.backbone.replace(
        scan_fold=want.scan_fold))
    # without the ``backbone.`` prefix, as a bare backbone state dict
    bare = {k[len("backbone."):]: v for k, v in state.items() if k.startswith("backbone.")}
    assert _fields(TR.infer_backbone_config(bare, base_t)) == _fields(want)


def test_pad_embedding_tables_matches_jax():
    rng = np.random.default_rng(0)
    pre = {"word_embeddings": rng.standard_normal((5, 4)).astype(np.float32),
           "position_embeddings": rng.standard_normal((7, 4)).astype(np.float32),
           "LayerNorm": {"scale": np.ones(4, np.float32)}}
    init = {"word_embeddings": rng.standard_normal((9, 4)).astype(np.float32),
            "position_embeddings": rng.standard_normal((7, 4)).astype(np.float32),
            "LayerNorm": {"scale": np.zeros(4, np.float32)}}
    want = JR.pad_embedding_tables(pre, init)
    got = TR.pad_embedding_tables(pre, {k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                                        else v for k, v in init.items()})
    assert got.keys() == want.keys()
    for k in ("word_embeddings", "position_embeddings"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    assert got["LayerNorm"] is pre["LayerNorm"]


def _hf_tiny(tmp_path):
    from transformers import LayoutLMv3Config as HFConfig
    from transformers import LayoutLMv3Model as HFModel

    cfg = LayoutLMv3Config.tiny()
    hf_cfg = HFConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_hidden_layers, num_attention_heads=cfg.num_attention_heads,
        intermediate_size=cfg.intermediate_size,
        max_position_embeddings=cfg.max_position_embeddings,
        coordinate_size=cfg.coordinate_size, shape_size=cfg.shape_size,
        rel_pos_bins=cfg.rel_pos_bins, max_rel_pos=cfg.max_rel_pos,
        rel_2d_pos_bins=cfg.rel_2d_pos_bins, max_rel_2d_pos=cfg.max_rel_2d_pos,
        input_size=cfg.input_size, patch_size=cfg.patch_size,
    )
    torch.manual_seed(0)
    HFModel(hf_cfg).save_pretrained(tmp_path / "hf")
    return cfg, str(tmp_path / "hf")


def test_maybe_load_pretrained_matches_jax(tmp_path):
    cfg, path = _hf_tiny(tmp_path)
    want = JR._maybe_load_pretrained(JLayoutLMv3Config.tiny(), path)
    got = TR._maybe_load_pretrained(cfg, path)
    assert want is not None and got is not None
    want = jax_tree_to_state_dict(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert TR._maybe_load_pretrained(cfg, str(tmp_path / "absent")) is None


def test_build_model_loads_the_pretrained_backbone(tmp_path, monkeypatch):
    """build_model takes a cached checkpoint's backbone (the classifier
    keeps its random init), as the JAX package's does."""
    cfg, path = _hf_tiny(tmp_path)
    pre = _pretrained_at_224(TR._maybe_load_pretrained(cfg, path), cfg)
    monkeypatch.setattr(TR, "_backbone_config", lambda *a: cfg.replace(input_size=224))
    monkeypatch.setattr(TR, "_maybe_load_pretrained", lambda bb, weights: dict(pre))
    _, tcfg = _configs(["with", "model_size=base", "exits=text_avg,1", f"model_weights={path}"])
    _, model = TR.build_model(tcfg, num_labels=4)
    state = model.backbone.state_dict()
    for k, v in pre.items():
        if not k.startswith("classifier."):
            np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)


def _pretrained_at_224(state, bb):
    """The tiny checkpoint with its visual position table widened to 224
    pixels' patches, so it loads into a model of input size 224."""
    n = (224 // bb.patch_size) ** 2 + 1
    pos = np.zeros((1, n, bb.hidden_size), np.float32)
    pos[:, : state["visual.pos_embed"].shape[1]] = state["visual.pos_embed"]
    state["visual.pos_embed"] = pos
    return state
