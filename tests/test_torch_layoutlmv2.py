"""PyTorch port, LayoutLMv2 (``models/layoutlmv2``) against the JAX
package's on the tiny config: the JAX ``init_params`` carried into the port
by ``convert.load_jax_params``, the same numpy inputs on both sides. The
visual tower's features, ``visual_grid_bbox``, both embeddings, the forward
(with and without ``seq_pad_multiple``), the loss and its gradients, two
``EETrainer`` steps, the HuggingFace-layout converter, the registry's build,
and the command-line path's dense branch. f32 bars: logits atol 2e-4 / rtol
1e-3, hidden states 5e-4 (tests/test_golden_base.py:65,78). The base-width
forward is ``slow``."""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_modal_early_exit_tpu.models.layoutlmv2 import config as JC
from multi_modal_early_exit_tpu.models.layoutlmv2 import convert as JCV
from multi_modal_early_exit_tpu.models.layoutlmv2 import modeling as JM
from multi_modal_early_exit_tpu.training import trainer as JT
from multi_modal_early_exit_tpu_torch.models.layoutlmv2 import config as TC
from multi_modal_early_exit_tpu_torch.models.layoutlmv2 import convert as TCV
from multi_modal_early_exit_tpu_torch.models.layoutlmv2 import modeling as TM
from multi_modal_early_exit_tpu_torch.training import trainer as TT

from _torch_parity import assert_state_close

torch.set_num_threads(2)

LOGITS = dict(atol=2e-4, rtol=1e-3)
HIDDEN = dict(atol=5e-4, rtol=1e-3)


def _configs(**fields):
    return JC.LayoutLMv2Config.tiny().replace(**fields), TC.LayoutLMv2Config.tiny().replace(
        **fields)


def _port(tcfg, tree):
    return TCV.load_jax_params(TM.LayoutLMv2Model(tcfg, device="cpu"), tree)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _configs()
    params = jax.jit(lambda k: JM.init_params(k, jcfg))(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    return jcfg, tcfg, params, _port(tcfg, tree)


def _batch(cfg, seed=0, b=2, s=12, masked_tail=3):
    """numpy (input_ids, bbox, pixel_values, attention_mask) with a masked
    tail on the first document."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 900, (b, s)).astype(np.int32)
    x0, y0 = rng.integers(0, 900, (b, s)), rng.integers(0, 900, (b, s))
    bbox = np.stack([x0, y0, x0 + 50, y0 + 30], -1).astype(np.int32)
    px = rng.standard_normal((b, 3, cfg.input_size, cfg.input_size)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[0, -masked_tail:] = 0
    return ids, bbox, px, mask


def _j(batch):
    return tuple(jnp.asarray(x) for x in batch)


def _t(batch):
    return tuple(torch.from_numpy(x) for x in batch)


@pytest.mark.parametrize("size", ["tiny", "base"])
def test_visual_grid_bbox_matches_jax(size):
    jcfg, tcfg = getattr(JC.LayoutLMv2Config, size)(), getattr(TC.LayoutLMv2Config, size)()
    want = np.asarray(JM.visual_grid_bbox(jcfg))
    got = TM.visual_grid_bbox(tcfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_the_port_holds_the_jax_tree(tiny):
    """Every leaf of the JAX tree is a parameter of the port (strict load),
    the frozen-BN affines and the pixel statistics among them: the
    optimizer updates them in both packages."""
    _, tcfg, _, model = tiny
    names = dict(model.named_parameters())
    for name in ("visual_backbone.pixel_mean", "visual_backbone.stem_bn.weight",
                 "visual_backbone.stages.0.0.bn2.bias", "visual_backbone.fpn_lateral.1.conv",
                 "visual_backbone.fpn_output_p2.bias"):
        assert name in names
    fresh = TM.init_params(tcfg, device="cpu")
    assert {k: v.shape for k, v in fresh.state_dict().items()} == {
        k: v.shape for k, v in model.state_dict().items()}
    np.testing.assert_array_equal(fresh.visual_backbone.pixel_std.detach().numpy().ravel(),
                                  np.asarray(TM.PIXEL_STD, np.float32))


def test_visual_tower_matches_jax(tiny):
    jcfg, tcfg, params, model = tiny
    px = _batch(tcfg)[2]
    want = np.asarray(JM.visual_backbone_apply(params["visual_backbone"], jcfg, jnp.asarray(px)))
    with torch.no_grad():
        got = TM.visual_backbone_apply(model.visual_backbone, tcfg, torch.from_numpy(px))
    assert got.shape == want.shape == (2, 4, 32)
    np.testing.assert_allclose(got.numpy(), want, **HIDDEN)


@pytest.mark.parametrize("which", ["text", "vision"])
def test_embeddings_match_jax(tiny, which):
    jcfg, tcfg, params, model = tiny
    ids, bbox, px, _ = _batch(tcfg, seed=1)
    with torch.no_grad():
        if which == "text":
            want = JM.embed_text_v2(params["embeddings"], jcfg, jnp.asarray(ids),
                                    jnp.asarray(bbox))
            got = TM.embed_text_v2(model.embeddings, tcfg, torch.from_numpy(ids),
                                   torch.from_numpy(bbox))
        else:
            want = JM.embed_vision_v2(params, jcfg, jnp.asarray(px))
            got = TM.embed_vision_v2(model, tcfg, torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HIDDEN)


@pytest.mark.parametrize("pad", [None, 128])
def test_forward_matches_jax(tiny, pad):
    jcfg, tcfg, params, model = tiny
    batch = _batch(tcfg, seed=2)
    want = JM.forward_sequence_classification(params, jcfg, *_j(batch), seq_pad_multiple=pad)
    with torch.no_grad():
        got = TM.forward_sequence_classification(model, tcfg, *_t(batch), seq_pad_multiple=pad)
    s = 12 + 4
    assert got.logits.shape == (2, 4) and got.last_hidden_state.shape[1] == (pad or s)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), **LOGITS)
    np.testing.assert_allclose(got.last_hidden_state[:, :s].numpy(),
                               np.asarray(want.last_hidden_state)[:, :s], **HIDDEN)
    np.testing.assert_allclose(got.initial_visual_embeddings.numpy(),
                               np.asarray(want.initial_visual_embeddings), **HIDDEN)


def test_loss_and_gradients_match_jax(tiny):
    """``sequence_classification_loss`` at dropout 0 (deterministic): the
    loss to 1e-5, every gradient to 2e-4 of its tensor's largest value
    (the key biases' true gradient is zero: rounding noise, 1e-9)."""
    jcfg, tcfg, params, model = tiny
    ids, bbox, px, mask = _batch(tcfg, seed=3)
    labels = np.asarray([1, 3], np.int32)
    batch = dict(input_ids=ids, bbox=bbox, pixel_values=px, attention_mask=mask, labels=labels)
    (want, _), jgrads = jax.value_and_grad(JM.sequence_classification_loss, has_aux=True)(
        params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, deterministic=True)
    loss, aux = TM.sequence_classification_loss(model, tcfg, batch, deterministic=True,
                                                device="cpu")
    assert set(aux) == {"logits"} and aux["logits"].dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert_state_close(dict(zip(names, grads)), jgrads, 2e-4, "gradient")


@pytest.mark.parametrize("switch", ["MMEE_FUSED_BIAS", "MMEE_TABLE_GRADS", "MMEE_CHAINED_DBIAS"])
def test_v2_ignores_the_bias_mode_switches(tiny, switch, monkeypatch):
    """v2 hands every layer the plain bias tensor, as the JAX package does:
    with a switch set the forward (deterministic, no autograd) and the
    training loss's gradients (at dropout 0, where a mode would change the
    attention's arithmetic) are bit-equal to those with it unset."""
    _, tcfg, _, model = tiny
    ids, bbox, px, mask = _batch(tcfg, seed=6)
    batch = dict(input_ids=ids, bbox=bbox, pixel_values=px, attention_mask=mask,
                 labels=np.asarray([2, 0], np.int32))
    cfg0 = tcfg.replace(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)

    def run():
        with torch.no_grad():
            logits = TM.forward_sequence_classification(model, cfg0, *_t((ids, bbox, px, mask)))
        loss, _ = TM.sequence_classification_loss(model, cfg0, batch, device="cpu")
        return [logits.logits, *torch.autograd.grad(loss, list(model.parameters()))]

    monkeypatch.delenv(switch, raising=False)
    want = run()
    monkeypatch.setenv(switch, "1")
    got = run()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_trainer_steps_match_jax():
    """Two ``EETrainer`` steps of the dense v2 (AdamW, warmup, clipping,
    weight decay; every dropout rate 0): the losses to 1e-5, the final
    parameters to the trainer test's bar (2e-4 of each tensor's largest
    value, plus 1e-3 lr for the key biases' noise)."""
    zero = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    jcfg, tcfg = _configs(**zero)
    params = JM.init_params(jax.random.key(5), jcfg)
    model = _port(tcfg, jax.tree.map(np.asarray, params))
    lr = 1e-3
    args = dict(learning_rate=lr, warmup_ratio=0.5, max_grad_norm=0.5, weight_decay=0.01)
    jtrainer = JT.EETrainer(jcfg, params, JT.TrainingArguments(**args), total_steps=2)
    ttrainer = TT.EETrainer(tcfg, model, TT.TrainingArguments(**args), total_steps=2,
                            device="cpu")
    for step in range(2):
        ids, bbox, px, mask = _batch(tcfg, seed=10 + step, b=3)
        batch = dict(input_ids=ids, bbox=bbox, pixel_values=px, attention_mask=mask,
                     labels=np.asarray([0, 2, 3], np.int32))
        batch = {k: v[None] for k, v in batch.items()}
        want = jtrainer.train_step({k: jnp.asarray(v) for k, v in batch.items()},
                                   jax.random.key(step))[0]
        got = ttrainer.train_step(batch, torch.Generator().manual_seed(step))[0]
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"loss of step {step}")
    final = {n: p.detach() for n, p in ttrainer.model.named_parameters()}
    want = TCV.jax_tree_to_state_dict(jax.tree.map(np.asarray, jtrainer.params))
    assert final.keys() == want.keys()
    for n, a in final.items():
        w = want[n]
        np.testing.assert_allclose(a.numpy(), w, atol=2e-4 * np.abs(w).max() + 1e-3 * lr,
                                   rtol=2e-4, err_msg=n)
    ev_batch = {k: v for k, v in zip(("input_ids", "bbox", "pixel_values", "attention_mask"),
                                     _batch(tcfg, seed=20, b=3))}
    ev_batch["labels"] = np.asarray([0, 1, 2], np.int32)
    got = ttrainer.evaluate([ev_batch])
    assert set(got) == set(jtrainer.evaluate([ev_batch])) == {"accuracy", "exit_0_share"}
    assert got["exit_0_share"] == 1.0


def _hf_state_dict(cfg, fast_qkv: bool, seed: int = 0):
    """A synthetic state dict in HuggingFace LayoutLMv2Model's names and
    layouts (no checkpoint: random numbers of the right shapes)."""
    rng = np.random.default_rng(seed)
    h, inter = cfg.hidden_size, cfg.intermediate_size

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {f"embeddings.{n}.weight": r(rows, width) for n, rows, width in (
        ("word_embeddings", cfg.vocab_size, h),
        ("position_embeddings", cfg.max_position_embeddings, h),
        ("token_type_embeddings", cfg.type_vocab_size, h),
        ("x_position_embeddings", cfg.max_2d_position_embeddings, cfg.coordinate_size),
        ("y_position_embeddings", cfg.max_2d_position_embeddings, cfg.coordinate_size),
        ("h_position_embeddings", cfg.max_2d_position_embeddings, cfg.shape_size),
        ("w_position_embeddings", cfg.max_2d_position_embeddings, cfg.shape_size))}

    def linear(name, d_in, d_out):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = r(d_out, d_in), r(d_out)

    def norm(name):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = r(h), r(h)

    norm("embeddings.LayerNorm")
    for i in range(cfg.num_hidden_layers):
        lp = f"encoder.layer.{i}."
        if fast_qkv:
            sd[f"{lp}attention.self.qkv_linear.weight"] = r(3 * h, h)
            sd[f"{lp}attention.self.q_bias"] = r(1, 1, h)
            sd[f"{lp}attention.self.v_bias"] = r(1, 1, h)
        else:
            for name in ("query", "key", "value"):
                linear(f"{lp}attention.self.{name}", h, h)
        linear(f"{lp}attention.output.dense", h, h)
        norm(f"{lp}attention.output.LayerNorm")
        linear(f"{lp}intermediate.dense", h, inter)
        linear(f"{lp}output.dense", inter, h)
        norm(f"{lp}output.LayerNorm")
    sd["encoder.rel_pos_bias.weight"] = r(cfg.num_attention_heads, cfg.rel_pos_bins)
    sd["encoder.rel_pos_x_bias.weight"] = r(cfg.num_attention_heads, cfg.rel_2d_pos_bins)
    sd["encoder.rel_pos_y_bias.weight"] = r(cfg.num_attention_heads, cfg.rel_2d_pos_bins)
    linear("visual_proj", cfg.image_feature_pool_shape[2], h)
    norm("visual_LayerNorm")
    return sd


@pytest.mark.parametrize("fast_qkv", [True, False])
def test_hf_converter_matches_jax(tiny, fast_qkv):
    """One synthetic HF-named state dict through both converters: the same
    partial tree (fast_qkv folded into q/k/v with k's bias 0), which loads
    over the port's model and leaves the visual tower as it was."""
    jcfg, tcfg, params, model = tiny
    sd = _hf_state_dict(tcfg, fast_qkv)
    want = JCV.convert_v2_torch_state_dict(sd, jcfg, prefix="")
    got = TCV.convert_v2_torch_state_dict(
        {f"layoutlmv2.{k}": torch.from_numpy(v) for k, v in sd.items()}, tcfg)
    want_flat = TCV.jax_tree_to_state_dict(jax.tree.map(np.asarray, want))
    got_flat = TCV.jax_tree_to_state_dict(got)
    assert got_flat.keys() == want_flat.keys()
    for k in want_flat:
        np.testing.assert_array_equal(got_flat[k], want_flat[k], err_msg=k)
    if fast_qkv:
        assert not got_flat["encoder.layers.0.attention.key.bias"].any()
    state = model.state_dict()
    state.update({k: torch.from_numpy(np.asarray(v)) for k, v in got_flat.items()})
    loaded = TM.LayoutLMv2Model(tcfg, device="cpu")
    loaded.load_state_dict(state, strict=True)
    assert torch.equal(loaded.visual_backbone.stem_conv, model.visual_backbone.stem_conv)


def test_registry_builds_v2_like_jax():
    """``build_model(model=layoutlmv2)``: the JAX registry's config and
    parameter names and shapes, the vocabulary widened to the tokenizer's
    50265 rows, on the CPU when asked."""
    from multi_modal_early_exit_tpu.config.experiment import parse_cli as j_parse
    from multi_modal_early_exit_tpu.models import registry as JR
    from multi_modal_early_exit_tpu_torch.config.experiment import parse_cli
    from multi_modal_early_exit_tpu_torch.models import registry as TR

    argv = ["debugEE", "with", "model=layoutlmv2"]
    kwargs = dict(num_labels=5, image_size=32, seq_len=64)
    jcfg, params = JR.build_model(j_parse(argv), rng=jax.random.key(0), **kwargs)
    tcfg, model = TR.build_model(parse_cli(argv + ["device=cpu"]), **kwargs)
    assert isinstance(tcfg, TC.LayoutLMv2Config)
    import dataclasses

    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.vocab_size == 50265 == model.embeddings.word_embeddings.shape[0]
    want = {k: v.shape for k, v in
            TCV.jax_tree_to_state_dict(jax.tree.map(np.asarray, params)).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert all(v.device.type == "cpu" for v in model.state_dict().values())
    assert tuple(model.classifier.weight.shape) == (5, 3 * tcfg.hidden_size)


def test_registry_loads_cached_v2_weights_over_the_init(monkeypatch):
    """``model_weights`` at base size: a cached HF checkpoint (here the
    converter's output of a synthetic HF state dict with a 120-row
    vocabulary, the base config swapped for the tiny one) replaces the
    transformer side; the classifier and the visual tower keep their init,
    and the widened word table keeps its init past the checkpoint's rows.
    With nothing cached the random init stays, with a warning."""
    from multi_modal_early_exit_tpu_torch.config.experiment import parse_cli
    from multi_modal_early_exit_tpu_torch.models import registry as TR

    assert TR._maybe_load_pretrained_v2(TC.LayoutLMv2Config.tiny(), "no/such-model") is None
    monkeypatch.setattr(TC.LayoutLMv2Config, "base",
                        classmethod(lambda cls, num_labels=16: cls.tiny(num_labels)))
    cfg = parse_cli(["with", "model=layoutlmv2", "model_size=base", "device=cpu",
                     "model_weights=microsoft/layoutlmv3-base"])
    kwargs = dict(num_labels=4, image_size=32, seq_len=64)
    _, init = TR.build_model(cfg, **kwargs)
    hf_cfg = TC.LayoutLMv2Config.tiny().replace(vocab_size=120)
    pre = TCV.jax_tree_to_state_dict(
        TCV.convert_v2_torch_state_dict(_hf_state_dict(hf_cfg, fast_qkv=True), hf_cfg, prefix=""))
    asked = []
    monkeypatch.setattr(TR, "_maybe_load_pretrained_v2",
                        lambda v2, weights: asked.append(weights) or dict(pre))
    _, model = TR.build_model(cfg, **kwargs)
    assert asked == ["microsoft/layoutlmv2-base-uncased"]
    got, before = model.state_dict(), init.state_dict()
    for k, v in pre.items():
        if k == "embeddings.word_embeddings":
            np.testing.assert_array_equal(got[k][:120].numpy(), v)
            assert torch.equal(got[k][120:], before[k][120:])
        elif k.startswith("classifier."):
            assert torch.equal(got[k], before[k])
        else:
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    for k in got:
        if k.startswith(("visual_backbone.", "classifier.")):
            assert torch.equal(got[k], before[k]), k


def test_cli_trains_and_dumps_layoutlmv2(tmp_path, monkeypatch):
    """The command-line path's dense branch, as the JAX package's CLI smoke
    test runs it: ``cli.train`` with ``model=layoutlmv2`` (test metrics of
    the single-row store), then ``cli.evaluate`` dumps a (1, N, K) float64
    store of the checkpoint."""
    from multi_modal_early_exit_tpu_torch.cli import evaluate, train

    monkeypatch.chdir(tmp_path)
    metrics = train.main(["with", "debugEE", "model=layoutlmv2", "epochs=1", "batch_size=8",
                          "lr=3e-4", "output_dir=save_v2", "eval_batch_size=8",
                          "device=cpu"])
    assert set(metrics) == {"accuracy", "exit_0_share"} and metrics["exit_0_share"] == 1.0
    ckpts = sorted(glob.glob("save_v2/*/checkpoint-*"))
    assert ckpts
    out = evaluate.main(["-c", ckpts[-1], "-d", "synthetic_rvl_cdip_tiny",
                         "--exit_threshold", "-1", "with", "device=cpu"])
    assert out["mode"] == "dump"
    (dump,) = glob.glob("results/*/exit_logits-test.npz")
    store = np.load(dump)["arr_0"]
    assert store.dtype == np.float64 and store.shape[0] == 1 and np.isfinite(store).all()
    assert os.path.exists(os.path.join(os.path.dirname(dump), "config.json"))


@pytest.mark.slow
def test_base_forward_matches_jax():
    """LayoutLMv2-base (the ResNeXt-101 32x8d FPN tower at 224 pixels, 12
    layers) on 1 document of 64 tokens: logits and hidden states at the f32
    bars."""
    jcfg, tcfg = JC.LayoutLMv2Config.base(), TC.LayoutLMv2Config.base()
    params = jax.jit(lambda k: JM.init_params(k, jcfg))(jax.random.key(1))
    model = _port(tcfg, jax.tree.map(np.asarray, params))
    batch = _batch(tcfg, seed=4, b=1, s=64, masked_tail=1)
    def fwd(p, *a):
        out = JM.forward_sequence_classification(p, jcfg, *a)
        return out.logits, out.last_hidden_state

    logits, hidden = jax.jit(fwd)(params, *_j(batch))
    with torch.no_grad():
        got = TM.forward_sequence_classification(model, tcfg, *_t(batch))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(logits), **LOGITS)
    np.testing.assert_allclose(got.last_hidden_state.numpy(), np.asarray(hidden), **HIDDEN)
