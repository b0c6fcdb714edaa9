"""PyTorch port, checkpoints (``training/checkpoint.py``), the resume they
allow, ``Pipeline.from_checkpoint`` and the bf16 first moment
(``training/trainer.py::AdamWBf16Mu``), against the JAX package where it
has the same function: ``CheckpointManager``'s rolling deletions,
``Pipeline.from_checkpoint``'s predictions on the same parameters, and
optax's ``adamw(mu_dtype=bfloat16)`` over 5 steps. The port's own format
(``state.pt`` + ``config.json``) round-trips bit for bit."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from _torch_parity import jax_params, no_dropout, port_model, tiny_configs, train_batch
from multi_modal_early_exit_tpu.config.experiment import parse_cli as j_parse_cli
from multi_modal_early_exit_tpu.training import checkpoint as JC
from multi_modal_early_exit_tpu_torch.config.experiment import parse_cli
from multi_modal_early_exit_tpu_torch.training import checkpoint as TC
from multi_modal_early_exit_tpu_torch.training import trainer as TT

EXITS = dict(exits=("text_avg", "vision_avg", 1), global_threshold=0.3)


def _trainer(tcfg, tree, steps, **args):
    return TT.EETrainer(tcfg, port_model(tcfg, tree), TT.TrainingArguments(
        learning_rate=1e-3, **args), total_steps=steps, device="cpu")


@pytest.mark.parametrize("bf16_momentum", [False, True])
def test_save_load_round_trip_is_bit_equal(tmp_path, bf16_momentum):
    jcfg, tcfg = no_dropout(*tiny_configs(**EXITS))
    _, tree = jax_params(jcfg)
    trainer = _trainer(tcfg, tree, 4, bf16_momentum=bf16_momentum)
    trainer.train_step({k: v[None] for k, v in train_batch(1, 2, 12, jcfg).items()}, None)
    config = parse_cli(["debugEE", "with", "device=cpu"]).to_dict()
    TC.save_checkpoint(str(tmp_path), trainer.model.state_dict(), config,
                       trainer.optimizer.state_dict(), step=3)
    payload = torch.load(tmp_path / TC.STATE_FILE, weights_only=True)  # no pickled classes
    assert set(payload) == {"state_dict", "opt_state", "step"}
    state, got_config, opt_state, step = TC.load_checkpoint(str(tmp_path), with_opt_state=True)
    assert got_config == json.loads(json.dumps(config)) and step == 3
    want = trainer.model.state_dict()
    assert state.keys() == want.keys()
    assert all(torch.equal(state[k], want[k]) for k in want)
    saved = trainer.optimizer.state_dict()
    assert opt_state["step"] == saved["step"] == 1
    moments = [(a, opt_state["adamw"]["state"][i][a], v) for i, s in saved["adamw"]["state"].items()
               for a, v in s.items()]
    assert moments and all(torch.equal(got, v) for _, got, v in moments)
    assert {v.dtype for a, _, v in moments if a == "exp_avg"} == {
        torch.bfloat16 if bf16_momentum else torch.float32}
    assert TC.load_checkpoint(str(tmp_path))[2] is None  # opt state only when asked


def test_checkpoint_manager_keeps_three_and_the_best_as_jax(tmp_path, monkeypatch):
    """The same saves and metrics through both managers (the JAX one's
    orbax write replaced by a directory), the same deletions in the same
    order: the rolling window of 3, never the best."""
    metrics = [0.5, 0.9, 0.4, 0.6, 0.7, 0.95, 0.1]
    monkeypatch.setattr(JC, "save_checkpoint",
                        lambda d, *a, **k: os.makedirs(d, exist_ok=True) or d)
    deleted = {"jax": [], "port": []}
    managers = {}
    for name, module in (("jax", JC), ("port", TC)):
        manager = managers[name] = module.CheckpointManager(str(tmp_path / name), keep=3)
        for epoch, m in enumerate(metrics):
            before = set(os.listdir(manager.root))
            manager.save(epoch, {"w": torch.full((1,), float(epoch))}, metric=m)
            deleted[name] += sorted(before - set(os.listdir(manager.root)))
        deleted[name].append(sorted(os.listdir(manager.root)))
        deleted[name].append(os.path.basename(manager.best_dir))
    assert deleted["port"] == deleted["jax"]
    assert deleted["port"][-1] == "checkpoint-5"
    state, _, _, step = managers["port"].load_best()
    assert step == 5 and torch.equal(state["w"], torch.full((1,), 5.0))


@pytest.mark.parametrize("bf16_momentum", [False, True])
def test_resume_equals_straight_training(tmp_path, bf16_momentum):
    """N/2 steps, a save, a load into a fresh trainer and N/2 more steps give
    the parameters of N straight steps, bit for bit (CPU, dropout 0)."""
    n = 4
    jcfg, tcfg = no_dropout(*tiny_configs(**EXITS))
    _, tree = jax_params(jcfg)
    batches = [{k: v[None] for k, v in train_batch(10 + i, 2, 12, jcfg, 2).items()}
               for i in range(n)]
    straight = _trainer(tcfg, tree, n, bf16_momentum=bf16_momentum)
    for b in batches:
        straight.train_step(b, None)
    first = _trainer(tcfg, tree, n, bf16_momentum=bf16_momentum)
    for b in batches[: n // 2]:
        first.train_step(b, None)
    TC.save_checkpoint(str(tmp_path), first.model.state_dict(), None,
                       first.optimizer.state_dict(), step=n // 2)
    state, _, opt_state, _ = TC.load_checkpoint(str(tmp_path), with_opt_state=True)
    jcfg2, _ = no_dropout(*tiny_configs(**EXITS))
    resumed = _trainer(tcfg, jax_params(jcfg2, seed=5)[1], n, bf16_momentum=bf16_momentum)
    resumed.model.load_state_dict(state)
    resumed.optimizer.load_state_dict(opt_state)
    for b in batches[n // 2:]:
        resumed.train_step(b, None)
    want = straight.model.state_dict()
    got = resumed.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_pipeline_from_checkpoint_matches_jax(tmp_path):
    """The same parameters and run config saved by each package (orbax for
    the JAX one): both ``Pipeline.from_checkpoint``s give the same labels,
    exits and, within f32 noise, confidences, and the same backbone config."""
    from multi_modal_early_exit_tpu.serving import Pipeline as JPipeline
    from multi_modal_early_exit_tpu_torch.serving import Pipeline

    argv = ["debugEE", "with", "exits=text_avg,vision_avg,1", "global_threshold=0.3"]
    jcfg, tcfg = tiny_configs(**EXITS)
    params, tree = jax_params(jcfg, seed=3)
    model = port_model(tcfg, tree)
    JC.save_checkpoint(str(tmp_path / "jax"), params, j_parse_cli(argv).to_dict())
    TC.save_checkpoint(str(tmp_path / "port"), model.state_dict(),
                       parse_cli(argv + ["with", "device=cpu"]).to_dict())
    kwargs = dict(batch_size=4, seq_len=12)
    jpipe = JPipeline.from_checkpoint(str(tmp_path / "jax"), **kwargs)
    tpipe = Pipeline.from_checkpoint(str(tmp_path / "port"), device="cpu", **kwargs)
    assert dataclasses.asdict(tpipe.cfg.backbone) == dataclasses.asdict(jpipe.cfg.backbone)
    assert tpipe.cfg.exit.to_dict() == jpipe.cfg.exit.to_dict()
    batch = train_batch(7, 6, 12, jcfg)
    feats = {k: batch[k] for k in ("input_ids", "bbox", "attention_mask", "pixel_values")}
    want = jpipe.predict_features(feats)
    got = tpipe.predict_features(feats)
    assert [(r["label_id"], r["exit"]) for r in got] == [(r["label_id"], r["exit"]) for r in want]
    np.testing.assert_allclose([r["confidence"] for r in got],
                               [r["confidence"] for r in want], atol=2e-4, rtol=1e-3)


def test_bf16_first_moment_matches_optax():
    """5 AdamW steps with the first moment in bf16 against optax's
    ``adamw(mu_dtype=bfloat16)`` on the same parameters and gradients: the
    moment stored in bf16, within one bf16 ulp of optax's (XLA may fuse what
    torch rounds twice), the parameters within 1e-6 relative."""
    rng = np.random.default_rng(0)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 10.0 ** rng.integers(-4, 1)).astype(np.float32)
              for s in shapes] for _ in range(5)]
    args = TT.TrainingArguments(learning_rate=1e-2, weight_decay=0.01, warmup_ratio=0.2,
                                bf16_momentum=True)
    schedule = TT.linear_schedule(args, 10)
    tx = optax.adamw(lambda c: jnp.asarray([schedule(i) for i in range(11)],
                                           jnp.float32)[c],
                     b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01, mu_dtype=jnp.bfloat16)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = TT.AdamWBf16Mu(tp, lr=args.learning_rate, weight_decay=0.01)
    for step, gs in enumerate(grads):
        updates, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g)
        opt.param_groups[0]["lr"] = schedule(step)
        opt.step()
        mu_j = state[0].mu
        for p, m, want_p in zip(tp, mu_j, jp):
            got_mu = opt.state[p]["exp_avg"]
            assert got_mu.dtype == torch.bfloat16 and m.dtype == jnp.bfloat16
            a = got_mu.to(torch.float32).numpy()
            w = np.asarray(m, np.float32)
            ulp = np.abs(w) * 2.0 ** -7 + 1e-30
            assert np.all(np.abs(a - w) <= ulp), (step, np.max(np.abs(a - w) / ulp))
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want_p), rtol=1e-6,
                                       atol=1e-7)
