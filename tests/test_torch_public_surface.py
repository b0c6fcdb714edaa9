"""PyTorch port, the rest of the JAX package's public surface against the JAX
package: the names every ``__init__`` exports, an import that loads no JAX and
builds nothing, ``collect_hidden`` under every attention schedule, the full
``TrainingArguments``, the HuggingFace exporter, ``batch_features``,
``native.sweep.available``, ``prefetch_to_device(buffer_size=)``, and the
early refusal of the single-tower variants by ``cli.train`` and ``EETrainer``
(ROADMAP.md C12). Tiny config, inputs made by numpy from seeds.
"""

import ast
import dataclasses
import importlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    jax_params,
    make_batch,
    no_dropout,
    port_model,
    tiny_configs,
    train_batch,
    with_backbone,
)
from multi_modal_early_exit_tpu.data import features as JF
from multi_modal_early_exit_tpu.data import loader as JLD
from multi_modal_early_exit_tpu.models.ee import model as JEE
from multi_modal_early_exit_tpu.models.layoutlmv3 import convert as JC
from multi_modal_early_exit_tpu.models.layoutlmv3 import modeling as JM
from multi_modal_early_exit_tpu.native import sweep as JS
from multi_modal_early_exit_tpu.training import trainer as JT
from multi_modal_early_exit_tpu_torch.data import features as TF
from multi_modal_early_exit_tpu_torch.data import loader as TLD
from multi_modal_early_exit_tpu_torch.models.ee import model as TEE
from multi_modal_early_exit_tpu_torch.models.layoutlmv3 import convert as TC
from multi_modal_early_exit_tpu_torch.models.layoutlmv3 import modeling as TM
from multi_modal_early_exit_tpu_torch.native import sweep as TS
from multi_modal_early_exit_tpu_torch.training import trainer as TT

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PACKAGE = ROOT / "multi_modal_early_exit_tpu"
PORT = "multi_modal_early_exit_tpu_torch"
SWITCHES = ("MMEE_CHAINED_DBIAS", "MMEE_LAYERS_PER_STEP", "MMEE_TABLE_GRADS", "MMEE_FUSED_BIAS")
EXITS = dict(exits=("text_avg", "vision_avg", 1), training_strategy="one_stage_subgraphs_weighted")
HIDDEN = dict(atol=5e-4, rtol=1e-3)  # the north star's hidden-state bar
LOGITS = dict(atol=2e-4, rtol=1e-3)
B, S = 2, 12


@pytest.fixture(autouse=True)
def _switches_unset(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


# ---------------------------------------------------------------------------
# (a) the names every JAX __init__ exports
# ---------------------------------------------------------------------------

# JAX names the port has no counterpart for, deliberately: a head is made by
# its module's constructor (``models/ee/__init__.py``'s docstring)
DELIBERATE = {"init_exit_head", "init_lte_head"}
JAX_INITS = sorted(p.relative_to(JAX_PACKAGE).as_posix()
                   for p in JAX_PACKAGE.rglob("__init__.py"))


def _exported(path: pathlib.Path):
    """The names an ``__init__`` imports from its package's modules, and its
    ``__all__`` (None without one)."""
    names, all_ = [], None
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            all_ = ast.literal_eval(node.value)
    return names, all_


@pytest.mark.parametrize("init", JAX_INITS)
def test_every_jax_export_exists_in_the_port(init):
    names, all_ = _exported(JAX_PACKAGE / init)
    package = ".".join((PORT,) + pathlib.PurePosixPath(init).parent.parts)
    port = importlib.import_module(package)
    missing = [n for n in names if n not in DELIBERATE and not hasattr(port, n)]
    assert not missing, (package, missing)
    assert getattr(port, "__all__", None) == all_, package


def test_the_root_exports():
    from multi_modal_early_exit_tpu_torch import (
        EarlyExitHead,
        EarlyExitInference,
        EarlyExitStrategy,
        ExitConfig,
        Pipeline,
    )
    from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig as Exit
    from multi_modal_early_exit_tpu_torch.serving import Pipeline as Pipe

    assert (Pipeline, ExitConfig) == (Pipe, Exit)
    assert {EarlyExitHead.RAMP, EarlyExitInference.ENTROPY,
            EarlyExitStrategy.JOINT} <= set(EarlyExitHead) | set(EarlyExitInference) | set(
        EarlyExitStrategy)


# ---------------------------------------------------------------------------
# (b) importing the port loads no JAX and builds nothing
# ---------------------------------------------------------------------------


def test_importing_the_port_loads_no_jax_and_builds_nothing(tmp_path):
    """A clean process imports the port's root and every sub-package from a
    copy of the package with no ``_build/``: no ``jax*`` module and nothing
    of the JAX package is loaded, and no ``_build/`` appears."""
    copy = tmp_path / PORT
    shutil.copytree(ROOT / PORT, copy, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    packages = sorted(".".join([PORT] + list(p.relative_to(copy).parent.parts))
                      for p in copy.rglob("__init__.py"))
    assert len(packages) >= 13
    script = (
        "import importlib, json, sys\n"
        f"mods = [importlib.import_module(m) for m in {packages!r}]\n"
        "print(json.dumps({'files': [m.__file__ for m in mods],\n"
        "    'loaded': sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "        ('jax', 'jaxlib', 'flax', 'optax', 'multi_modal_early_exit_tpu'))}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(f.startswith(str(copy)) for f in out["files"]), out["files"]
    assert out["loaded"] == []
    assert not (copy / "_build").exists()


# ---------------------------------------------------------------------------
# (c) collect_hidden against the JAX package, under every schedule
# ---------------------------------------------------------------------------

L = 2  # the tiny config's layers
# name -> (backbone fields, training forward (rates 0, autograd on), switches,
#          the bias kind encoder_apply must receive)
SCHEDULES = {
    "inference": ({}, False, {}, "Tensor"),
    "fused": ({}, False, {"MMEE_FUSED_BIAS": "1"}, "FusedBiasContext"),
    "scan_fold_1": ({}, True, {}, "Tensor"),
    "chained": ({"scan_fold": L}, True, {}, "ChainedBiasContext"),
    "tables": ({}, True, {"MMEE_TABLE_GRADS": "1"}, "TrainBiasContext"),
    "checkpointed": ({"gradient_checkpointing": True}, True, {}, "Tensor"),
    "checkpointed_chained": ({"gradient_checkpointing": True, "scan_fold": L}, True, {},
                             "ChainedBiasContext"),
}
_JAX_HIDDEN = {}


def _jax_hidden(fields, pad):
    """JAX's ``ee_forward`` and ``backbone_apply`` with ``collect_hidden`` on
    the schedule's fields (deterministic): (last_hidden_state,
    hidden_per_layer, logits)."""
    key = (tuple(sorted(fields.items())), pad)
    if key not in _JAX_HIDDEN:
        jcfg, _ = with_backbone(*tiny_configs(**EXITS), **fields)
        params, _ = jax_params(jcfg)
        batch = tuple(jnp.asarray(x) for x in make_batch(5, B, S, jcfg, masked_tail=3))

        def run(p, *b):
            out = JEE.ee_forward(p, jcfg, *b, collect_hidden=True, seq_pad_multiple=pad)
            bb = JM.backbone_apply(p["backbone"], jcfg.backbone, *b, collect_hidden=True,
                                   seq_pad_multiple=pad)
            return out.last_hidden_state, bb.hidden_per_layer, out.logits

        _JAX_HIDDEN[key] = tuple(np.asarray(x) for x in jax.jit(run)(params, *batch))
    return _JAX_HIDDEN[key]


def _port_forward(model, tcfg, batch, train, pad, collect):
    kwargs = dict(deterministic=not train, rng=torch.Generator().manual_seed(0),
                  seq_pad_multiple=pad)
    with torch.set_grad_enabled(train):
        out = TEE.ee_forward(model, tcfg, *batch, collect_hidden=collect, **kwargs)
        bb = TM.backbone_apply(model.backbone, tcfg.backbone, *batch, collect_hidden=collect,
                               **kwargs)
    return out, bb


@pytest.mark.parametrize("pad", [None, 128])
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_collect_hidden_matches_jax(monkeypatch, schedule, pad):
    """``ee_forward(collect_hidden=True).last_hidden_state`` and
    ``backbone_apply(collect_hidden=True).hidden_per_layer`` against JAX's
    in f32, within the hidden-state bar, shapes equal (the pad rows of
    ``seq_pad_multiple`` included); the last layer's state is the last
    hidden state. The schedule took the bias it names (and the checkpointed
    groups ran), and with ``collect_hidden=False`` the outputs are the same
    bits and carry no states."""
    fields, train, env, kind = SCHEDULES[schedule]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    jcfg, tcfg = no_dropout(*with_backbone(*tiny_configs(**EXITS), **fields))
    _, tree = jax_params(jcfg)
    model = port_model(tcfg, tree)
    batch = tuple(torch.from_numpy(x) for x in make_batch(5, B, S, jcfg, masked_tail=3))

    seen, groups = [], []
    encoder_apply, checkpoint = TM.encoder_apply, TM.checkpoint

    def spy_encoder(p, cfg, hidden, attn_bias, *args, **kwargs):
        seen.append(type(attn_bias).__name__)
        return encoder_apply(p, cfg, hidden, attn_bias, *args, **kwargs)

    def spy_checkpoint(*args, **kwargs):
        groups.append(1)
        return checkpoint(*args, **kwargs)

    monkeypatch.setattr(TM, "encoder_apply", spy_encoder)
    monkeypatch.setattr(TM, "checkpoint", spy_checkpoint)
    out, bb = _port_forward(model, tcfg, batch, train, pad, collect=True)
    assert seen == [kind, kind], seen
    assert bool(groups) == bool(fields.get("gradient_checkpointing"))

    want_last, want_layers, want_logits = _jax_hidden(fields, pad)
    assert out.last_hidden_state.shape == want_last.shape
    assert bb.hidden_per_layer.shape == want_layers.shape == (L,) + want_last.shape
    if pad:
        assert want_last.shape[1] % pad == 0
    np.testing.assert_allclose(out.last_hidden_state.detach().numpy(), want_last, **HIDDEN)
    np.testing.assert_allclose(bb.hidden_per_layer.detach().numpy(), want_layers, **HIDDEN)
    np.testing.assert_allclose(out.logits.detach().numpy(), want_logits, **LOGITS)
    assert torch.equal(bb.hidden_per_layer[-1], bb.last_hidden_state)
    assert torch.equal(bb.last_hidden_state, out.last_hidden_state)

    off, bb_off = _port_forward(model, tcfg, batch, train, pad, collect=False)
    assert off.last_hidden_state is None and bb_off.hidden_per_layer is None
    for name in ("logits", "exit_logits", "exit_criteria"):
        assert torch.equal(getattr(off, name), getattr(out, name)), name
    assert torch.equal(bb_off.cls_per_layer, bb.cls_per_layer)


@pytest.mark.parametrize("schedule", ["chained", "checkpointed", "checkpointed_chained"])
def test_collect_hidden_leaves_the_gradients_bit_equal(schedule):
    """A training forward's gradients (the chained bias cotangent, the
    checkpointed groups' recompute) are the same bits with the states
    collected as without."""
    fields = SCHEDULES[schedule][0]
    jcfg, tcfg = no_dropout(*with_backbone(*tiny_configs(**EXITS), **fields))
    _, tree = jax_params(jcfg)
    model = port_model(tcfg, tree)
    batch = tuple(torch.from_numpy(x) for x in make_batch(6, B, S, jcfg, masked_tail=2))
    grads = []
    for collect in (False, True):
        out = TEE.ee_forward(model, tcfg, *batch, deterministic=False,
                             rng=torch.Generator().manual_seed(0), collect_hidden=collect,
                             seq_pad_multiple=128)
        loss = out.logits.square().sum() + out.exit_logits.square().sum()
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# ---------------------------------------------------------------------------
# (d) TrainingArguments
# ---------------------------------------------------------------------------

NEW_FIELDS = dict(num_epochs=3, train_batch_size=16, eval_batch_size=4, alpha=0.5,
                  temperature=2.0, gamma=0.3, seed=7, log_every=1)


def test_training_arguments_are_the_jax_package_s():
    """JAX's field names, in its order, with its defaults."""
    assert [(f.name, f.default) for f in dataclasses.fields(TT.TrainingArguments)] == [
        (f.name, f.default) for f in dataclasses.fields(JT.TrainingArguments)]


def test_the_fields_the_step_does_not_read_leave_it_bit_equal():
    """One step with the eight fields the train step does not read set away
    from their defaults gives the same loss and parameters, bit for bit, as
    one without them."""
    jcfg, tcfg = tiny_configs(**EXITS)
    _, tree = jax_params(jcfg)
    batch = {k: v[None] for k, v in train_batch(7, B, S, jcfg).items()}
    base = dict(learning_rate=1e-3, max_grad_norm=1.0)
    results = []
    for extra in ({}, NEW_FIELDS):
        trainer = TT.EETrainer(tcfg, port_model(tcfg, tree), TT.TrainingArguments(**base, **extra),
                               10, device="cpu")
        loss, _ = trainer.train_step(batch, torch.Generator().manual_seed(1))
        results.append((loss, {n: p.detach().clone() for n, p in
                               trainer.model.named_parameters()}))
    (loss_a, params_a), (loss_b, params_b) = results
    assert loss_a == loss_b
    assert all(torch.equal(params_a[n], params_b[n]) for n in params_a)


# ---------------------------------------------------------------------------
# (e) the HuggingFace exporter
# ---------------------------------------------------------------------------


def _hf_model(cfg):
    from transformers import LayoutLMv3Config as HFConfig
    from transformers import LayoutLMv3ForSequenceClassification

    conf = HFConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_hidden_layers, num_attention_heads=cfg.num_attention_heads,
        intermediate_size=cfg.intermediate_size,
        max_position_embeddings=cfg.max_position_embeddings,
        coordinate_size=cfg.coordinate_size, shape_size=cfg.shape_size,
        rel_pos_bins=cfg.rel_pos_bins, max_rel_pos=cfg.max_rel_pos,
        rel_2d_pos_bins=cfg.rel_2d_pos_bins, max_rel_2d_pos=cfg.max_rel_2d_pos,
        input_size=cfg.input_size, patch_size=cfg.patch_size, num_labels=cfg.num_labels,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, classifier_dropout=0.0)
    return LayoutLMv3ForSequenceClassification(conf).eval()


@pytest.mark.parametrize("prefix", ["layoutlmv3.", ""])
def test_exporter_matches_jax_and_inverts_the_importer(prefix):
    """The port's ``jax_params_to_torch_state_dict`` of a model holding the
    JAX init is JAX's, key by key and bit for bit; the importer after it
    gives back every parameter bit for bit."""
    jcfg, tcfg = tiny_configs(**EXITS)
    params, tree = jax_params(jcfg)
    model = port_model(tcfg, tree)
    got = TC.jax_params_to_torch_state_dict(TC.to_jax_params(model.backbone), tcfg.backbone,
                                            prefix=prefix)
    want = JC.jax_params_to_torch_state_dict(params["backbone"], jcfg.backbone, prefix=prefix)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
    fresh = TEE.init_ee_params(tcfg, torch.Generator().manual_seed(9), device="cpu")
    TC.load_jax_params(fresh.backbone, TC.convert_torch_state_dict(got, tcfg.backbone,
                                                                   prefix=prefix))
    a, b = model.backbone.state_dict(), fresh.backbone.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_exported_state_dict_loads_strictly_into_transformers():
    """The exported state dict loads ``strict`` into ``transformers``'
    ``LayoutLMv3ForSequenceClassification``, whose logits agree with the
    port's within the f32 bars."""
    jcfg, tcfg = tiny_configs(**EXITS)
    _, tree = jax_params(jcfg)
    model = port_model(tcfg, tree)
    sd = TC.jax_params_to_torch_state_dict(TC.to_jax_params(model.backbone), tcfg.backbone)
    hf = _hf_model(tcfg.backbone)
    hf.load_state_dict(sd, strict=True)
    ids, bbox, px, mask = make_batch(8, B, S, tcfg, masked_tail=4)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids).long(), bbox=torch.from_numpy(bbox).long(),
                  pixel_values=torch.from_numpy(px),
                  attention_mask=torch.from_numpy(mask).long()).logits
        got = TM.forward_sequence_classification(
            model.backbone, tcfg.backbone, *(torch.from_numpy(x) for x in (ids, bbox, px, mask)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGITS)


# ---------------------------------------------------------------------------
# (f) batch_features, sweep.available, prefetch_to_device(buffer_size=)
# ---------------------------------------------------------------------------


def test_batch_features_equals_jax():
    tok = TF.HashWordTokenizer()
    rng = np.random.default_rng(0)
    examples = [TF.convert_words_to_features(
        [f"w{i}{j}" for j in range(5 + i)], rng.integers(0, 1000, (5 + i, 4)).tolist(), tok,
        max_seq_length=16) for i in range(3)]
    extra = {"labels": np.arange(3, dtype=np.int32)}
    for kwargs in ({}, {"extra": extra}):
        got, want = TF.batch_features(examples, **kwargs), JF.batch_features(examples, **kwargs)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_sweep_available_equals_jax():
    assert TS.available() == JS.available()


@pytest.mark.parametrize("buffer_size", [0, 1, 2, 3])
def test_prefetch_buffer_size_matches_jax(buffer_size):
    """The same batches in order for every ``buffer_size``, and each batch
    handed out when as many batches have been drawn as in the JAX package's
    (``buffer_size`` 1 or less: at once)."""
    batches = [{"x": np.full((2, 3), i, np.float32), "y": np.arange(2, dtype=np.int32) + i}
               for i in range(5)]

    def run(prefetch, *args):
        drawn, out = [], []

        def source():
            for b in batches:
                drawn.append(1)
                yield b

        for got in prefetch(source(), *args, buffer_size=buffer_size):
            out.append(({k: np.asarray(v) for k, v in got.items()}, len(drawn)))
        return out

    got, want = run(TLD.prefetch_to_device, "cpu"), run(JLD.prefetch_to_device, None)
    assert [n for _, n in got] == [n for _, n in want]
    assert len(got) == len(batches)
    for (g, _), b in zip(got, batches):
        assert all(np.array_equal(g[k], b[k]) for k in b)


# ---------------------------------------------------------------------------
# (g) the early refusal of the single-tower variants (ROADMAP.md C12)
# ---------------------------------------------------------------------------


def test_trainer_rule_by_name():
    from multi_modal_early_exit_tpu_torch.models.registry import (
        MODEL_NAMES,
        trains_through_ee_trainer,
    )

    assert {n for n in MODEL_NAMES if not trains_through_ee_trainer(n)} == {
        "dit", "dit_rvl", "bert", "EEmoonlight", "EEkimivl", "EEkimilinear"}


@pytest.mark.parametrize("model", ["dit", "dit_rvl", "bert"])
def test_single_tower_variants_are_refused_before_any_step(monkeypatch, tmp_path, model):
    """The port's ``cli.train`` raises ``NotImplementedError`` naming the
    model before it builds a world, data or a model, and ``EETrainer``
    before any step, on the model ``build_model`` makes; the JAX package's
    ``cli.train`` fails there too, inside its first step."""
    from multi_modal_early_exit_tpu.cli import train as j_train
    from multi_modal_early_exit_tpu_torch.cli import train
    from multi_modal_early_exit_tpu_torch.config.experiment import parse_cli
    from multi_modal_early_exit_tpu_torch.models.registry import build_model

    def built(*args, **kwargs):
        raise AssertionError("built before the refusal")

    monkeypatch.chdir(tmp_path)
    with monkeypatch.context() as m:
        for name in ("setup_mesh", "build_dataset", "build_model"):
            m.setattr(train, name, built)
        with pytest.raises(NotImplementedError, match=model):
            train.main(["with", "debugEE", "device=cpu", f"model={model}", "output_dir=save"])

    cfg = parse_cli(["with", "debugEE", "device=cpu", "model_weights=", f"model={model}"])
    mcfg, built_model = build_model(cfg, num_labels=4, image_size=32, seq_len=16)
    monkeypatch.setattr(TT, "make_train_step", built)
    with pytest.raises(NotImplementedError, match=model):
        TT.EETrainer(mcfg, built_model, TT.TrainingArguments(), 1, device="cpu")

    # the reference's fault: its loss runs the two-tower backbone
    with pytest.raises(KeyError, match="visual" if model == "bert" else "embeddings"):
        j_train.main(["with", "debugEE", f"model={model}", "output_dir=save"])


@pytest.mark.parametrize("model", ["EElayoutlmv3", "layoutlmv2"])
def test_the_other_models_still_build_a_trainer(model):
    from multi_modal_early_exit_tpu_torch.config.experiment import parse_cli
    from multi_modal_early_exit_tpu_torch.models.registry import build_model

    cfg = parse_cli(["with", "debugEE", "device=cpu", "model_weights=", f"model={model}",
                     "exits=text_avg,1"])
    mcfg, built_model = build_model(cfg, num_labels=4, image_size=32, seq_len=16)
    assert built_model.model_name == model
    assert TT.EETrainer(mcfg, built_model, TT.TrainingArguments(), 1, device="cpu").step == 0
