"""PyTorch port, the parallel layer (``parallel/``) against the JAX
package's on the tiny config: the mesh, the partition specs, the sharded
head-form attention, the sharded EE forward and its gradients, the dropout
seeds under a mesh, the bias switches under a model axis and
``dryrun_multichip``.

The port runs in spawned gloo ranks on the CPU (``parallel.dryrun.
spawn_world``), at the kernels' plain versions; one world of 4 ranks runs
every sharded computation of this file (``world4``). The reference is the
JAX package in this process, on conftest's 8 virtual CPU devices, the Pallas
kernels in interpret mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import jax_params, make_batch, no_dropout, tiny_configs, with_backbone
from multi_modal_early_exit_tpu.models.ee.model import ee_forward as j_ee_forward
from multi_modal_early_exit_tpu.parallel.sharding import (
    param_partition_specs as j_param_partition_specs,
)
from multi_modal_early_exit_tpu_torch.models.ee.model import EEModel
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.convert import jax_tree_to_state_dict
from multi_modal_early_exit_tpu_torch.ops.flash_attention import (
    attention_dropout_scale,
    flash_attention,
    reference_attention_hash_dropout,
)
from multi_modal_early_exit_tpu_torch.parallel import dryrun as D
from multi_modal_early_exit_tpu_torch.parallel.kernels import sharded_flash_attention
from multi_modal_early_exit_tpu_torch.parallel.layers import shard_seed, wrap_int32
from multi_modal_early_exit_tpu_torch.parallel.mesh import Mesh, create_mesh, default_mesh_shape
from multi_modal_early_exit_tpu_torch.parallel.multihost import maybe_initialize_distributed
from multi_modal_early_exit_tpu_torch.parallel.sharding import param_partition_specs
from multi_modal_early_exit_tpu_torch.training.losses import ee_loss_fn

torch.set_num_threads(2)

EXITS = ("text_avg", "vision_avg", 1)
B, S = 8, 12
# sharded_flash_attention's shapes (tests/test_parallel.py) and seeds: the
# large one wraps in int32 at every shard index above 0
ATT_SHAPE = (8, 4, 32, 8)
ATT_SEEDS = (1234, 2 ** 31 - 1000)


def _configs():
    return no_dropout(*tiny_configs(exits=EXITS))


def _attention_inputs(seed=0):
    rng = np.random.default_rng(seed)
    b, h, s, d = ATT_SHAPE
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((b, h, s, s)).astype(np.float32)
    cot = rng.standard_normal((b, h, s, d)).astype(np.float32)
    return q, k, v, bias, cot


def _batch():
    ids, bbox, px, mask = make_batch(2, B, S, _configs()[0], masked_tail=2)
    return dict(input_ids=ids, bbox=bbox, pixel_values=px, attention_mask=mask,
                labels=(np.arange(B) % 4).astype(np.int32))


@pytest.fixture(scope="module")
def world4():
    """One world of 4 gloo ranks on the CPU running every sharded
    computation of this file; rank 0's results (each gathered to full
    shapes) by key, and every rank's for the dropout job."""
    jcfg, tcfg = _configs()
    _, tree = jax_params(jcfg)
    state = jax_tree_to_state_dict(tree)
    batch = _batch()
    q, k, v, bias, cot = _attention_inputs()
    both = with_backbone(*tiny_configs(exits=EXITS), attention_probs_dropout_prob=0.1,
                         hidden_dropout_prob=0.1, classifier_dropout=0.0)[1]
    jobs = [("round_trip", "job_round_trip", dict(shape=(2, 2), state=state)),
            ("fwd22", "job_forward", dict(shape=(2, 2), cfg=tcfg, state=state, batch=batch,
                                          grad=True)),
            ("fwd41", "job_forward", dict(shape=(4, 1), cfg=tcfg, state=state, batch=batch)),
            ("fused22", "job_forward", dict(shape=(2, 2), cfg=tcfg, state=state, batch=batch,
                                            env={"MMEE_FUSED_BIAS": "1"})),
            ("dropout", "job_dropout", dict(shape=(2, 2), cfg=both, state=state, batch=batch))]
    for rate in (0.0, 0.1):
        for seed in ATT_SEEDS:
            jobs.append((f"att_{rate}_{seed}", "job_sharded_attention",
                         dict(shape=(2, 2), q=q, k=k, v=v, bias=bias, rate=rate, seed=seed,
                              cotangent=cot)))
    results = D.spawn_world(4, D.run_jobs, jobs, timeout=240)
    return dict(results[0], dropout_all=[r["dropout"] for r in results], state=state,
                tree=tree)


# ---------------------------------------------------------------------------
# mesh, multihost, specs
# ---------------------------------------------------------------------------


def test_default_mesh_shape_is_pure_dp():
    assert default_mesh_shape(8) == (8, 1)


def test_create_mesh_validates_shape():
    with pytest.raises(ValueError):
        create_mesh((3, 2))


def test_maybe_initialize_distributed_is_false_without_torchrun(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert maybe_initialize_distributed() is False


def test_param_specs_match_jax_leaf_for_leaf():
    """Each JAX leaf marked along its model-sharded axis (0 elsewhere) and
    carried through the converter (layer unstacking, kernel transposes):
    the port dim along which the marks vary is ``param_partition_specs``'s."""
    jcfg, tcfg = _configs()
    params, tree = jax_params(jcfg)
    specs = j_param_partition_specs(params)

    def mark(x, spec):
        x = np.asarray(x)
        axes = [i for i, a in enumerate(spec) if a == "model"]
        if not axes:
            return np.zeros(x.shape, np.float32)
        a = axes[0]
        ramp = np.arange(1, x.shape[a] + 1, dtype=np.float32)
        return np.broadcast_to(ramp.reshape([-1 if i == a else 1 for i in range(x.ndim)]),
                               x.shape).copy()

    marks = jax_tree_to_state_dict(jax.tree.map(mark, tree, specs,
                                                is_leaf=lambda s: isinstance(s, jax.sharding.
                                                                             PartitionSpec)))
    mine = param_partition_specs(EEModel(tcfg, device="cpu"))
    assert set(marks) == set(mine)
    sharded = 0
    for name, m in marks.items():
        varying = [d for d in range(m.ndim) if m.shape[d] > 1 and np.any(np.diff(m, axis=d))]
        want = varying[0] if varying else None
        assert len(varying) <= 1 and mine[name] == want, (name, varying, mine[name])
        sharded += want is not None
    assert sharded == 1 + 5 + 2 * 10  # word + 5 position tables + 10 per layer


def test_shard_then_gather_is_bit_equal(world4):
    got, want = world4["round_trip"], world4["state"]
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)


# ---------------------------------------------------------------------------
# sharded_flash_attention
# ---------------------------------------------------------------------------


def _local_meshes():
    """The (2, 2) mesh as each of its ranks sees it; no world is needed:
    ``sharded_flash_attention`` runs no collective."""
    return [Mesh((2, 2), r, torch.device("cpu")) for r in range(4)]


def test_shard_seeds_wrap_as_int32():
    """``seed + shard * 1000003`` in int32 arithmetic, as numpy's int32
    arrays (and JAX's) wrap."""
    for seed in ATT_SEEDS:
        for shard in range(4):
            want = (np.array([seed], np.int32) + np.array([shard], np.int32)
                    * np.array([1000003], np.int32))[0]
            assert shard_seed(seed, shard) == int(want)
    assert wrap_int32(2 ** 31) == -2 ** 31 and shard_seed(ATT_SEEDS[1], 1) < 0


@pytest.mark.parametrize("seed", ATT_SEEDS)
def test_sharded_attention_blocks_against_the_port_and_the_hash_reference(seed):
    """Each rank's block at rate 0 is the unsharded port's block bit for
    bit; at rate 0.1 it is ``reference_attention_hash_dropout`` of the
    block with the shard's offset seed."""
    q, k, v, bias, _ = (torch.from_numpy(x) for x in _attention_inputs())
    whole = flash_attention(q, k, v, bias)
    b, h = ATT_SHAPE[0] // 2, ATT_SHAPE[1] // 2
    for mesh in _local_meshes():
        rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
        heads = slice(mesh.model_index * h, (mesh.model_index + 1) * h)
        got = sharded_flash_attention(mesh, q, k, v, bias)
        torch.testing.assert_close(got, whole[rows, heads], rtol=0, atol=0)
        got = sharded_flash_attention(mesh, q, k, v, bias, dropout_rate=0.1, dropout_seed=seed)
        blk = [x[rows, heads] for x in (q, k, v, bias)]
        want = reference_attention_hash_dropout(*blk, shard_seed(seed, mesh.shard_index), 0.1)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


def test_sharded_attention_rejects_heads_not_divisible():
    q, k, v, bias, _ = (torch.from_numpy(x) for x in _attention_inputs())
    with pytest.raises(ValueError):
        sharded_flash_attention(_local_meshes()[0], q[:, :3], k[:, :3], v[:, :3], bias[:, :3])


@pytest.mark.parametrize("seed", ATT_SEEDS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_sharded_attention_matches_jax(world4, rate, seed):
    """The (2, 2) world's output against the JAX package's
    ``sharded_flash_attention`` on a (2, 2) CPU mesh (Pallas in interpret
    mode), at ``tests/test_parallel.py``'s tolerance."""
    from jax.experimental.pallas import tpu as pltpu

    from multi_modal_early_exit_tpu.parallel.kernels import (
        sharded_flash_attention as j_sharded,
    )
    from multi_modal_early_exit_tpu.parallel.mesh import create_mesh as j_create_mesh

    q, k, v, bias, _ = (jnp.asarray(x) for x in _attention_inputs())
    mesh = j_create_mesh((2, 2), devices=jax.devices()[:4])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_sharded(mesh, q, k, v, bias, block_q=16, dropout_rate=rate,
                                    dropout_seed=jnp.int32(seed)))
    np.testing.assert_allclose(world4[f"att_{rate}_{seed}"]["out"], want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_sharded_attention_gradients_match_the_unsharded_port(world4, rate):
    """The gradients of sum(out * g) in q, k, v and the bias from the
    (2, 2) world (each rank's block, summed) against the unsharded port's,
    per block at the shard's seed, within 1e-5."""
    q, k, v, bias, cot = (torch.from_numpy(x) for x in _attention_inputs())
    got = world4[f"att_{rate}_{ATT_SEEDS[0]}"]["grads"]
    want = [torch.zeros_like(x) for x in (q, k, v, bias)]
    b, h = ATT_SHAPE[0] // 2, ATT_SHAPE[1] // 2
    for mesh in _local_meshes():
        rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
        heads = slice(mesh.model_index * h, (mesh.model_index + 1) * h)
        blk = [x[rows, heads].clone().requires_grad_() for x in (q, k, v, bias)]
        seed = shard_seed(ATT_SEEDS[0], mesh.shard_index) if rate else None
        out = flash_attention(*blk, dropout_rate=rate, dropout_seed=seed)
        for w, g in zip(want, torch.autograd.grad((out * cot[rows, heads]).sum(), blk)):
            w[rows, heads] = g
    for name, a, w in zip("q k v bias".split(), got, want):
        np.testing.assert_allclose(a, w.numpy(), atol=1e-5, rtol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# the sharded EE forward
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_forward():
    jcfg, _ = _configs()
    params, _ = jax_params(jcfg)
    b = _batch()
    def fwd(p, *args):
        out = j_ee_forward(p, jcfg, *args)
        return out.policy_logits(), out.exit_criteria

    logits, crit = jax.jit(fwd)(params, *(jnp.asarray(b[k]) for k in (
        "input_ids", "bbox", "pixel_values", "attention_mask")))
    return {"policy_logits": np.asarray(logits), "exit_criteria": np.asarray(crit)}


@pytest.mark.parametrize("key", ["fwd22", "fwd41", "fused22"])
def test_sharded_forward_matches_jax(world4, jax_forward, key):
    """(2, 2), (4, 1), and (2, 2) with ``MMEE_FUSED_BIAS=1`` (the fused
    attention on this rank's heads and table columns) against JAX
    ``ee_forward`` on one device, at tests/test_parallel.py's tolerance."""
    for name, want in jax_forward.items():
        np.testing.assert_allclose(world4[key][name], want, atol=1e-5, rtol=1e-5,
                                   err_msg=f"{key} {name}")


def test_sharded_gradients_match_the_single_device_port(world4):
    """The deterministic loss's gradients from the (2, 2) world (reduced as
    the train step reduces them, gathered) against the single-device port's:
    each tensor within 2e-4 of its own largest value, plus 1e-9 for the
    key biases, whose true gradient is zero."""
    _, tcfg = _configs()
    model = D.ee_model(tcfg, world4["state"])
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    loss, _ = ee_loss_fn(model, tcfg, b, deterministic=True, device="cpu")
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    got = world4["fwd22"]
    np.testing.assert_allclose(got["loss"], loss.item(), rtol=1e-6)
    assert set(got["grads"]) == set(named)
    for name, g in zip(named, grads):
        w = g.numpy()
        np.testing.assert_allclose(got["grads"][name], w, atol=2e-4 * np.abs(w).max() + 1e-9,
                                   rtol=2e-4, err_msg=name)


def test_dropout_masks_differ_by_shard_and_model_groups_stay_bit_equal(world4):
    """At dropout 0.1 under (2, 2): every rank draws its attention seed at
    its own shard offset (so the masks of its local (batch, head) planes
    differ from every other rank's), its hidden seed at its data index
    only; the [CLS] state after the first layer is bit-equal within each
    model group."""
    runs = world4["dropout_all"]
    att = [r["seeds"]["attention"] for r in runs]
    hid = [r["seeds"]["hidden"] for r in runs]
    assert att == [shard_seed(att[0], r) for r in range(4)]
    assert hid == [hid[0], hid[0], shard_seed(hid[0], 1), shard_seed(hid[0], 1)]
    masks = [attention_dropout_scale(s, B // 2, 2, S, 0.1, "cpu") for s in att]
    for i in range(4):
        for j in range(i + 1, 4):
            assert not torch.equal(masks[i], masks[j]), (i, j)
    for group in ((0, 1), (2, 3)):
        a, b = (runs[r]["cls_after_layer_1"] for r in group)
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(runs[0]["cls_after_layer_1"], runs[2]["cls_after_layer_1"])


def test_dryrun_multichip_on_four_cpu_ranks():
    D.dryrun_multichip(4)


def test_spawn_world_fails_with_the_rank_traceback():
    """A rank that raises fails the call, and the error carries its
    traceback; the other ranks are stopped."""
    with pytest.raises(RuntimeError, match="job_that_does_not_exist"):
        D.spawn_world(2, D.run_jobs, [("x", "job_that_does_not_exist", {})], timeout=60)
