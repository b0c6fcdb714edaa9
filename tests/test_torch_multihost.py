"""PyTorch port, training across ranks: the multihost helpers in a world of
2 (``tests/test_multihost_dcn.py``'s assertions), ``EETrainer`` steps
under (2, 2) and (2, 1) meshes against the single-device port and the JAX
trainer (default strategy, the weighted exits, entropyreg, clipping), the
table-gradient attention under a model axis, checkpoints written under one
mesh and read under another, ``cli.train`` under a (2, 1) world at
gradient accumulation 1, its step batch (the micro-batch axis's rows) and
its refusal of a model axis, decided by name as ``shard_model`` decides it
on the built model.

The port runs in spawned gloo ranks on the CPU (``parallel.dryrun.
spawn_world``): one world of 4 ranks (``world4``) and one of 2
(``world2``), each running all of its computations. Every dropout rate is 0
where steps are compared, so a step under any mesh is the single-device
step to reduction order."""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import jax_params, no_dropout, tiny_configs, train_batch
from multi_modal_early_exit_tpu.training import trainer as JT
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.convert import jax_tree_to_state_dict
from multi_modal_early_exit_tpu_torch.parallel import dryrun as D
from multi_modal_early_exit_tpu_torch.training import checkpoint as TC
from multi_modal_early_exit_tpu_torch.training import trainer as TT

torch.set_num_threads(2)

STEPS, S, MICRO, LR = 2, 12, 4, 1e-3
CASES = {
    "default": dict(exit=dict(exits=("text_avg", "vision_avg", 1)),
                    args=dict(gradient_accumulation_steps=2)),
    "weighted": dict(exit=dict(exits=("text_avg", "vision_avg", 1), gamma=0.4,
                               training_strategy="one_stage_subgraphs_weighted"),
                     args=dict(gradient_accumulation_steps=1, weight_decay=0.01)),
    "entropyreg": dict(exit=dict(exits=("text_avg", "vision_avg", 1), gamma=0.4,
                                 training_strategy="one_stage_subgraphs_weighted_entropyreg"),
                       args=dict(gradient_accumulation_steps=2)),
    # the global norm is above 0.05 at every step: the update is clipped
    "clipping": dict(exit=dict(exits=("text_avg", 1)),
                     args=dict(gradient_accumulation_steps=1, max_grad_norm=0.05)),
}
CLI_TRAIN = ["with", "debugEE", "device=cpu", "epochs=1", "batch_size=4", "exits=text_avg,1",
             "training_strategy=joint_weighted_avg", "lr=3e-4", "eval_batch_size=8",
             "mesh_shape=2,1", "gradient_accumulation_steps=1"]


def _case(case):
    spec = CASES[case]
    jcfg, tcfg = no_dropout(*tiny_configs(**spec["exit"]))
    args = dict(learning_rate=LR, **spec["args"])
    accum = args["gradient_accumulation_steps"]
    batches = []
    for step in range(STEPS):
        micros = [train_batch(100 * step + i, MICRO, S, jcfg, masked_tail=2)
                  for i in range(accum)]
        batches.append({k: np.stack([m[k] for m in micros]) for k in micros[0]})
    return jcfg, tcfg, args, batches


def _train_jobs(shape):
    jobs = []
    for case in CASES:
        jcfg, tcfg, args, batches = _case(case)
        state = jax_tree_to_state_dict(jax_params(jcfg)[1])
        jobs.append((f"train_{case}", "job_train", dict(shape=shape, cfg=tcfg, state=state,
                                                        args=args, batches=batches)))
    return jobs


@pytest.fixture(scope="module")
def single_device():
    """Each case's steps on one device: the port (losses and parameters) and
    the JAX trainer (parameters in the port's names)."""
    out = {}
    for case in CASES:
        jcfg, tcfg, args, batches = _case(case)
        params, tree = jax_params(jcfg)
        trainer = TT.EETrainer(tcfg, D.ee_model(tcfg, jax_tree_to_state_dict(tree)),
                               TT.TrainingArguments(**args), STEPS, device="cpu")
        jtrainer = JT.EETrainer(jcfg, params, JT.TrainingArguments(**args), STEPS)
        gen, key = torch.Generator().manual_seed(1), jax.random.key(1)
        losses = [trainer.train_step(b, gen)[0] for b in batches]
        for b in batches:
            jtrainer.train_step({k: jnp.asarray(v) for k, v in b.items()}, key)
        out[case] = dict(
            losses=losses,
            port={n: p.detach().numpy() for n, p in trainer.model.named_parameters()},
            jax=jax_tree_to_state_dict(jax.tree.map(np.asarray, jtrainer.params)))
    return out


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """A world of 4: the (2, 2) steps of every case; one more with
    ``MMEE_TABLE_GRADS=1``; a checkpoint saved after 1 of 3 steps and the
    resume from it; a single-device checkpoint loaded under (2, 2)."""
    d = tmp_path_factory.mktemp("mesh_ckpt")
    jcfg, tcfg, args, batches = _case("default")
    state = jax_tree_to_state_dict(jax_params(jcfg)[1])
    three = batches + [_case("entropyreg")[3][0]]
    single_dir = str(d / "single")
    TC.save_checkpoint(single_dir, {k: torch.tensor(v) for k, v in state.items()})
    jobs = _train_jobs((2, 2)) + [
        ("tables", "job_train", dict(shape=(2, 2), cfg=tcfg, state=state, args=args,
                                     batches=batches[:1], env={"MMEE_TABLE_GRADS": "1"})),
        ("ckpt", "job_train", dict(shape=(2, 2), cfg=tcfg, state=state, args=args,
                                   batches=three, checkpoint_dir=str(d / "mesh"), save_after=1)),
        ("load", "job_load", dict(shape=(2, 2), cfg=tcfg, checkpoint_dir=single_dir)),
    ]
    results = D.spawn_world(4, D.run_jobs, jobs, timeout=300)
    return dict(results[0], all=results, dir=str(d / "mesh"), state=state, tcfg=tcfg,
                args=args, batches=batches)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """A world of 2: the multihost helpers, the (2, 1) steps of every case,
    and ``cli.train`` under mesh_shape=2,1 from a temporary directory."""
    d = str(tmp_path_factory.mktemp("mesh_cli"))
    jobs = [("multihost", "job_multihost", dict(global_batch=8))] + _train_jobs((2, 1)) + [
        ("cli", "job_cli", dict(argv=CLI_TRAIN + [f"output_dir={d}/save"], cwd=d))]
    results = D.spawn_world(2, D.run_jobs, jobs, timeout=300)
    return dict(results[0], all=results, dir=d)


def _close(got, want, what):
    """tests/test_torch_trainer.py's bar on the parameters after the steps:
    2e-4 of each tensor's largest value plus 1e-3 lr, rtol 2e-4."""
    assert set(got) == set(want), what
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, atol=2e-4 * np.abs(w).max() + 1e-3 * LR,
                                   rtol=2e-4, err_msg=f"{what} {n}")


def test_multihost_helpers_in_a_world_of_two(world2):
    r0, r1 = (r["multihost"] for r in world2["all"])
    assert (r0["info"]["process_count"], r1["info"]["process_index"]) == (2, 1)
    assert r0["info"]["global_device_count"] == 2
    assert r0["slice"] == [0, 4] and r1["slice"] == [4, 8]
    assert r0["sum_err"] < 1e-4 and r1["sum_err"] < 1e-4
    # the replicated step's loss agrees across the ranks and is finite
    l0, l1 = (r["train_default"]["losses"] for r in world2["all"])
    assert np.isfinite(l0).all() and l0 == l1


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", ["2x2", "2x1"])
def test_mesh_steps_match_single_device_and_jax(world4, world2, single_device, case, mesh):
    """The losses of every step (equal on every rank; 1e-5 of the
    single-device port's) and the gathered parameters after the steps
    against the single-device port's and the JAX trainer's."""
    world = world4 if mesh == "2x2" else world2
    got = world[f"train_{case}"]
    want = single_device[case]
    for r in world["all"]:
        assert r[f"train_{case}"]["losses"] == got["losses"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _close(got["params"], want["port"], f"{mesh} {case} against the port")
    _close(got["params"], want["jax"], f"{mesh} {case} against JAX")


def test_table_grad_attention_under_a_model_axis(world4):
    """``MMEE_TABLE_GRADS=1`` under (2, 2): the tables backward on this
    rank's heads, the table gradients summed over the model group; one step
    against the single-device step without the switch."""
    tcfg, args, batches = world4["tcfg"], world4["args"], world4["batches"]
    trainer = TT.EETrainer(tcfg, D.ee_model(tcfg, world4["state"]),
                           TT.TrainingArguments(**args), STEPS, device="cpu")
    trainer.train_step(batches[0], torch.Generator().manual_seed(1))
    want = {n: p.detach().numpy() for n, p in trainer.model.named_parameters()}
    _close(world4["tables"]["params"], want, "MMEE_TABLE_GRADS=1 under (2, 2)")


def test_mesh_checkpoint_loads_on_one_device(world4):
    """A checkpoint written under (2, 2) holds the full state: it loads on
    one device bit-equal to the state gathered when it was saved, and its
    optimizer state loads into a single-device trainer."""
    state, _, opt, step = TC.load_checkpoint(world4["dir"], with_opt_state=True)
    saved = world4["ckpt"]["saved"]
    assert step == 1 and set(state) == set(saved)
    for n, w in saved.items():
        np.testing.assert_array_equal(state[n].numpy(), w, err_msg=n)
    tcfg, args = world4["tcfg"], world4["args"]
    trainer = TT.EETrainer(tcfg, D.ee_model(tcfg, state), TT.TrainingArguments(**args), STEPS,
                           device="cpu")
    trainer.optimizer.load_state_dict(opt)
    params = trainer.optimizer.params
    for i, s in opt["adamw"]["state"].items():
        assert s["exp_avg"].shape == params[list(params)[i]].shape


def test_mesh_resume_equals_uninterrupted_training(world4):
    got, want = world4["ckpt"]["resumed"], world4["ckpt"]["params"]
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_array_equal(got[n], w, err_msg=n)


def test_single_device_checkpoint_loads_under_a_mesh(world4):
    got, want = world4["load"], world4["state"]
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_array_equal(got[n], w, err_msg=n)


def test_cli_train_under_two_ranks_at_accumulation_one(world2):
    """``cli.train`` under mesh_shape=2,1 at gradient accumulation 1 (the
    JAX CLI shards the accumulation axis there and raises): rank 0 returns
    the metrics, rank 1 nothing; the checkpoint serves through
    ``Pipeline.from_checkpoint``."""
    from multi_modal_early_exit_tpu_torch.serving import Pipeline

    m0, m1 = (r["cli"] for r in world2["all"])
    assert set(m0) == {"accuracy", "exit_0_accuracy", "exit_1_accuracy", "exit_0_share",
                       "exit_1_share", "exit_2_share"} and m1 == {}
    ckpts = sorted(glob.glob(os.path.join(world2["dir"], "save", "*", "checkpoint-*")))
    assert len(ckpts) == 1
    pipe = Pipeline.from_checkpoint(ckpts[0], device="cpu", batch_size=2)
    ids, bbox, px, mask = (train_batch(5, 2, S, pipe.cfg)[k] for k in (
        "input_ids", "bbox", "pixel_values", "attention_mask"))
    out = pipe.predict_features(dict(input_ids=ids, bbox=bbox, pixel_values=px,
                                     attention_mask=mask))
    assert len(out) == 2 and all(np.isfinite(r["confidence"]) for r in out)


@pytest.mark.parametrize("model", ["layoutlmv2", "dit", "bert"])
def test_cli_refuses_a_model_axis_for_other_models(model):
    """A model axis above 1 needs LayoutLMv3 with both towers: any other
    model raises, named, before a world is set up."""
    from multi_modal_early_exit_tpu_torch.cli import train

    with pytest.raises(NotImplementedError, match=model):
        train.main(["with", "debugEE", "device=cpu", f"model={model}", "mesh_shape=1,2"])


@pytest.mark.parametrize("with_text", [False, True])
def test_shard_model_refuses_a_model_axis_without_both_towers(with_text):
    """``dit`` (no text tower) and ``bert`` (no visual tower) refuse a
    model axis above 1."""
    from multi_modal_early_exit_tpu_torch.models.ee.model import EEModel
    from multi_modal_early_exit_tpu_torch.parallel.mesh import Mesh
    from multi_modal_early_exit_tpu_torch.parallel.sharding import shard_model

    _, tcfg = tiny_configs(exits=())
    model = EEModel(tcfg, device="cpu", with_text=with_text, with_vision=not with_text)
    with pytest.raises(NotImplementedError, match="EEModel"):
        shard_model(model, Mesh((1, 2), 0, torch.device("cpu")))


@pytest.mark.parametrize("model", ["EElayoutlmv3", "LTElayoutlmv3", "layoutlmv3", "dit",
                                   "dit_rvl", "bert"])
def test_model_axis_decision_agrees_with_the_built_model(model):
    """The CLI's early refusal (``splits_over_model_axis``, by name) and
    ``shard_model``'s (``tensor_parallel_model``, on the built model) decide
    alike for every model the registry builds as an ``EEModel``."""
    from multi_modal_early_exit_tpu_torch.config.experiment import parse_cli
    from multi_modal_early_exit_tpu_torch.models.registry import (
        build_model,
        splits_over_model_axis,
    )
    from multi_modal_early_exit_tpu_torch.parallel.sharding import tensor_parallel_model

    cfg = parse_cli(["with", "debugEE", "device=cpu", "model_weights=", f"model={model}"])
    _, built = build_model(cfg, num_labels=4, image_size=32, seq_len=16)
    assert splits_over_model_axis(model) == tensor_parallel_model(built)
    assert splits_over_model_axis(model) == (model in ("EElayoutlmv3", "LTElayoutlmv3",
                                                       "layoutlmv3"))


@pytest.mark.parametrize("model", ["layoutlmv2", "pix2struct", "nonsense"])
def test_model_axis_refused_by_name_for_models_without_the_encoder(model):
    from multi_modal_early_exit_tpu_torch.models.registry import splits_over_model_axis

    assert not splits_over_model_axis(model)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("rank", [0, 1])
def test_cli_step_batch_takes_the_micro_axis_rows(accum, rank):
    """``cli.train``'s ``step_batch`` under a data axis of 2: the
    accumulation layout, then this rank's half of every micro-batch (at
    accumulation 1 too, where sharding axis 0 would fail); with no mesh the
    accumulation layout alone."""
    from multi_modal_early_exit_tpu_torch.cli.train import step_batch
    from multi_modal_early_exit_tpu_torch.parallel.mesh import Mesh

    batch = {"input_ids": np.arange(8 * 3).reshape(8, 3), "labels": np.arange(8)}
    micro = 8 // accum
    got = step_batch(batch, accum, Mesh((2, 1), rank, torch.device("cpu")))
    half = slice(rank * micro // 2, (rank + 1) * micro // 2)
    for k, v in batch.items():
        laid = v.reshape((accum, micro) + v.shape[1:])
        np.testing.assert_array_equal(step_batch(batch, accum, None)[k], laid)
        np.testing.assert_array_equal(got[k], laid[:, half])
