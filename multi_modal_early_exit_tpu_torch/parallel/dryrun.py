"""Worlds of ranks on one machine, and the proofs of the sharded paths.

``spawn_world(n, fn, ...)`` runs ``fn(device, *args)`` in ``n`` new
processes joined into one ``torch.distributed`` world (start method
``spawn``: the caller may hold JAX or CUDA state, which ``fork`` would
copy; a ``file://`` rendezvous in a temporary directory, so concurrent
worlds never race for a port). It returns each rank's result, in rank
order. A rank that raises, dies or outlives ``timeout`` fails the call with
its traceback, and the other ranks are stopped. ``fn`` must be importable
by the children (a function of this package: a test module is not).

``dryrun_multichip(n)`` is the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``: on ``n`` ranks (gloo on the CPU by
default) it proves

- one training step at ``gradient_accumulation_steps=2`` on the tiny
  config, exits ``text_avg, vision_avg, 1, 2``, mesh ``(n/2, 2)`` (``(n,
  1)`` for odd or small ``n``): a finite loss, equal on every rank;
- the sharded deterministic EE forward equals the single-device forward
  (the gathered parameters, one device) within 1e-4;
- the cascade under a data axis of ``n``, per shard: each rank serves its
  own rows at capacities sized for its shard (the JAX package's documented
  serving contract), and its exits and capacity flags equal the
  single-device cascade run shard by shard, its logits within 1e-4.

The ``job_*`` functions are the sharded computations the tests and
``chip_smoke.py`` drive in such worlds (``run_jobs`` runs several in one
world); each returns numpy arrays, gathered to full shapes.
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from multi_modal_early_exit_tpu_torch.parallel.layers import all_reduce
from multi_modal_early_exit_tpu_torch.parallel.mesh import Mesh, create_mesh
from multi_modal_early_exit_tpu_torch.parallel.sharding import (
    gather_params,
    shard_batch,
    shard_model,
)


# ---------------------------------------------------------------------------
# worlds
# ---------------------------------------------------------------------------


COLLECTIVE_TIMEOUT = 60.0  # seconds: a hung collective fails the rank


def _rank_main(rank: int, n: int, init: str, backend: str, device: str, threads: int,
               fn: Callable, args: tuple, out: str) -> None:
    torch.set_num_threads(threads)
    dev = torch.device(device.format(rank=rank))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    result: Any
    try:
        dist.init_process_group(backend, init_method=f"file://{init}", rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
        result = ("ok", fn(dev, *args))
    except Exception:  # reported to the parent, which fails the call
        result = ("error", traceback.format_exc())
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)
    if dist.is_initialized():
        dist.destroy_process_group()
    sys.exit(0 if result[0] == "ok" else 1)


def spawn_world(n: int, fn: Callable, *args, backend: str = "gloo", device: str = "cpu",
                timeout: float = 120.0, threads: int = 1) -> List[Any]:
    """``fn(device, *args)`` on ``n`` spawned ranks of one world; their
    results in rank order. ``device`` may name the rank (``"cuda:{rank}"``);
    ``"cuda:0"`` puts every rank on one card (gloo only: NCCL refuses two
    ranks on one device). ``timeout`` (seconds) bounds the whole call,
    ``COLLECTIVE_TIMEOUT`` each collective; ``threads`` is each rank's
    intra-op pool."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mmee-world-") as tmp:
        init = os.path.join(tmp, "rendezvous")
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(n)]
        procs = [ctx.Process(target=_rank_main, args=(r, n, init, backend, device, threads, fn,
                                                      args, outs[r]))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break  # one rank failed: the others would wait on it
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                multiprocessing.connection.wait(
                    [p.sentinel for p in procs if p.is_alive()], timeout=min(left, 1.0))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        results, errors = [], []
        for r, (p, out) in enumerate(zip(procs, outs)):
            if os.path.exists(out):
                with open(out, "rb") as f:
                    status, value = pickle.load(f)
            else:
                status, value = "error", f"exit code {p.exitcode}, no result"
            if status != "ok":
                errors.append(f"rank {r}: {value}")
            results.append(value)
        if errors or hung:
            hung_note = f"ranks {hung} still running after {timeout} s\n" if hung else ""
            raise RuntimeError(f"world of {n} failed:\n{hung_note}" + "\n".join(errors))
        return results


def run_jobs(device: torch.device, jobs: Sequence[tuple]) -> Dict[str, Any]:
    """``jobs``: ``(key, function name in this module, kwargs)``; each runs in
    turn in this rank's world, and the results come back by key."""
    module = sys.modules[__name__]
    return {key: getattr(module, name)(device, **kwargs) for key, name, kwargs in jobs}


# ---------------------------------------------------------------------------
# helpers of the jobs
# ---------------------------------------------------------------------------


def numpy_state(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A state dict as numpy copies on the host (bf16 widened to f32): later
    in-place updates of the tensors do not reach them."""
    return {k: np.array((v.detach().float() if v.dtype == torch.bfloat16 else v.detach())
                        .cpu().numpy())
            for k, v in state.items()}


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: int = 0) -> torch.Tensor:
    """The data group's rows of ``x`` (this rank's, split on ``axis``) put
    back together on every rank, by an all-reduce of zero-padded buffers."""
    if mesh.data_size == 1:
        return x
    n = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = n * mesh.data_size
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    buf.narrow(axis, mesh.data_index * n, n).copy_(x)
    return all_reduce(buf, mesh.data_group, mesh.data_size)


def ee_model(cfg, state: Optional[Dict[str, Any]] = None, seed: int = 0):
    """An EEModel on the CPU holding ``state`` (numpy arrays or tensors),
    or random parameters from ``seed``."""
    from multi_modal_early_exit_tpu_torch.models.ee.model import EEModel, init_ee_params

    if state is None:
        return init_ee_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    model = EEModel(cfg, device="cpu")
    model.load_state_dict({k: torch.as_tensor(np.array(v)) for k, v in state.items()})
    return model


def example_batch(cfg, batch: int, seq: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """A numpy batch of the tiny shapes (ids, boxes, pixels, mask, labels)."""
    rng = np.random.default_rng(seed)
    bb = cfg.backbone
    return {
        "input_ids": rng.integers(3, bb.vocab_size, (batch, seq)).astype(np.int32),
        "bbox": np.sort(rng.integers(0, 1000, (batch, seq, 4)), -1).astype(np.int32),
        "pixel_values": rng.standard_normal(
            (batch, 3, bb.input_size, bb.input_size)).astype(np.float32),
        "attention_mask": np.ones((batch, seq), np.int32),
        "labels": rng.integers(0, bb.num_labels, batch).astype(np.int32),
    }


def _tensors(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


def _sharded_model(device, shape, cfg, state, seed=0):
    mesh = create_mesh(shape, device)
    model = shard_model(ee_model(cfg, state, seed), mesh, cfg.backbone.num_attention_heads)
    return mesh, model.to(device)


@contextlib.contextmanager
def _environ(env: Optional[Dict[str, str]]):
    """``os.environ`` updated by ``env`` inside, restored after."""
    old = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _forward(model, cfg, batch, **kwargs):
    from multi_modal_early_exit_tpu_torch.models.ee.model import ee_forward

    return ee_forward(model, cfg, batch["input_ids"], batch["bbox"], batch["pixel_values"],
                      batch["attention_mask"], **kwargs)


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------


def job_multihost(device, global_batch: int = 8) -> Dict[str, Any]:
    """``host_batch_slice`` of ``global_batch`` rows, and the error of a
    cross-rank sum of each rank's rows against the host's sum of all of
    them (``tests/dcn_worker.py``'s assertions)."""
    from multi_modal_early_exit_tpu_torch.parallel.multihost import (
        global_batch_from_local,
        host_batch_slice,
        process_info,
    )

    mesh = create_mesh(None, device)
    rows = host_batch_slice(global_batch)
    full = np.arange(global_batch * 4, dtype=np.float32).reshape(global_batch, 4)
    local = global_batch_from_local({"x": full[rows]}, mesh)["x"]
    total = all_reduce(local.sum(), mesh.data_group, mesh.data_size)
    return {"slice": [rows.start, rows.stop], "info": process_info(),
            "sum_err": abs(float(total) - float(full.sum())), "device": str(local.device)}


def job_round_trip(device, shape, state) -> Dict[str, np.ndarray]:
    """``gather_params(shard_params(state))`` under mesh ``shape``."""
    from multi_modal_early_exit_tpu_torch.parallel.sharding import shard_params

    mesh = create_mesh(shape, device)
    full = {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in state.items()}
    return numpy_state(gather_params(shard_params(full, mesh), mesh))


def job_forward(device, shape, cfg, state, batch, grad: bool = False,
                exit_weights=None, env: Optional[Dict[str, str]] = None, forward: bool = True,
                compute_dtype: Optional[str] = None, deterministic: bool = True
                ) -> Dict[str, Any]:
    """The deterministic EE forward under mesh ``shape`` on this rank's
    rows: the policy logits and exit criteria of the whole batch (gathered
    over the data group); with ``grad``, also the loss (``ee_loss_fn`` with
    ``deterministic`` and ``compute_dtype``, e.g. ``"bfloat16"``; its mean
    over the data group) and every parameter's gradient, reduced as the
    train step reduces them and gathered to full shapes (on rank 0 only).
    ``state=None``: random parameters from seed 0. ``env``: the environment
    variables (the bias switches) it runs under."""
    from multi_modal_early_exit_tpu_torch.training.losses import ee_loss_fn
    from multi_modal_early_exit_tpu_torch.training.trainer import data_mean, reduce_gradients

    mesh, model = _sharded_model(device, shape, cfg, state)
    local = _tensors(shard_batch(batch, mesh), device)
    result: Dict[str, Any] = {}
    if forward:
        with torch.no_grad(), _environ(env):
            out = _forward(model, cfg, local)
        result = {"policy_logits": gather_rows(out.policy_logits(), mesh, 1).cpu().numpy(),
                  "exit_criteria": gather_rows(out.exit_criteria, mesh, 1).cpu().numpy()}
    if grad:
        weights = None if exit_weights is None else torch.as_tensor(exit_weights).to(device)
        dtype = getattr(torch, compute_dtype) if compute_dtype else None
        named = dict(model.named_parameters())
        with _environ(env):
            loss, _ = ee_loss_fn(model, cfg, local, exit_weights=weights,
                                 deterministic=deterministic, compute_dtype=dtype, device=device)
            gs = torch.autograd.grad(loss, list(named.values()))
        grads = reduce_gradients(dict(zip(named, gs)), mesh)
        result["loss"] = float(data_mean(loss.detach(), mesh))
        full = gather_params(grads, mesh)
        result["grads"] = numpy_state(full) if mesh.rank == 0 else None
    return result


def job_train(device, shape, cfg, state, args: Dict[str, Any], batches, seed: int = 1,
              total_steps: Optional[int] = None, checkpoint_dir: Optional[str] = None,
              save_after: int = 1, env: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """``EETrainer`` steps under mesh ``shape`` on this rank's rows of each
    (accum, micro, ...) batch (``shard_batch(axis=1)``), every rank's
    generator seeded with ``seed``: the losses and the gathered parameters.
    With ``checkpoint_dir``, the state after ``save_after`` steps is saved
    there (with the optimizer's, gathered) and returned, then a second
    trainer (other random parameters) resumes from it and takes the
    remaining steps with a generator in the state the first one had: its
    gathered parameters come back as ``resumed``. ``env``: the environment
    variables (the bias switches) the steps run under."""
    from multi_modal_early_exit_tpu_torch.training.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from multi_modal_early_exit_tpu_torch.training.trainer import EETrainer, TrainingArguments

    mesh, model = _sharded_model(device, shape, cfg, state)
    total = total_steps or len(batches)
    trainer = EETrainer(cfg, model, TrainingArguments(**args), total, device=device, mesh=mesh)
    gen = torch.Generator().manual_seed(seed)
    losses, saved, resume_gen = [], None, None
    for i, b in enumerate(batches):
        with _environ(env):
            losses.append(trainer.train_step(shard_batch(b, mesh, axis=1), gen)[0])
        if checkpoint_dir is not None and i + 1 == save_after:
            names = list(trainer.optimizer.params)
            save_checkpoint(checkpoint_dir, trainer.model.state_dict(),
                            opt_state=trainer.optimizer.state_dict(), step=i + 1, mesh=mesh,
                            opt_names=names)
            saved = numpy_state(gather_params(trainer.model.state_dict(), mesh))
            resume_gen = gen.get_state()
    result = {"losses": losses,
              "params": numpy_state(gather_params(dict(trainer.model.named_parameters()), mesh))}
    if checkpoint_dir is not None:
        other = shard_model(ee_model(cfg, None, seed=7), mesh, cfg.backbone.num_attention_heads)
        resumed = EETrainer(cfg, other, TrainingArguments(**args), total, device=device,
                            mesh=mesh)
        names = list(resumed.optimizer.params)
        sd, _, opt, step = load_checkpoint(checkpoint_dir, with_opt_state=True, mesh=mesh,
                                           opt_names=names)
        resumed.model.load_state_dict(sd)
        resumed.optimizer.load_state_dict(opt)
        gen = torch.Generator()
        gen.set_state(resume_gen)
        for b in batches[step:]:
            resumed.train_step(shard_batch(b, mesh, axis=1), gen)
        result["saved"] = saved
        result["resumed"] = numpy_state(
            gather_params(dict(resumed.model.named_parameters()), mesh))
    return result


def job_load(device, shape, cfg, checkpoint_dir: str) -> Dict[str, np.ndarray]:
    """A checkpoint loaded under mesh ``shape`` (each rank its slices), then
    gathered back to full shapes."""
    from multi_modal_early_exit_tpu_torch.training.checkpoint import load_checkpoint

    mesh, model = _sharded_model(device, shape, cfg, None, seed=7)
    sd, _, _, _ = load_checkpoint(checkpoint_dir, mesh=mesh)
    model.load_state_dict(sd)
    return numpy_state(gather_params(model.state_dict(), mesh))


def job_dropout(device, shape, cfg, state, batch, seed: int = 3) -> Dict[str, Any]:
    """A training forward (dropout on) under mesh ``shape``: this rank's
    first attention and hidden dropout seeds and its hidden state after the
    first layer (the [CLS] taps), to show that attention masks differ by
    shard while one model group's activations stay bit-identical."""
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import RngStream

    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import backbone_apply

    mesh, model = _sharded_model(device, shape, cfg, state)
    local = _tensors(shard_batch(batch, mesh), device)
    stream = RngStream(torch.Generator().manual_seed(seed), mesh)
    seeds = {"attention": stream.next_attention(), "hidden": stream.next()}
    with torch.no_grad():
        bb = backbone_apply(model.backbone, cfg.backbone, local["input_ids"], local["bbox"],
                            local["pixel_values"], local["attention_mask"], deterministic=False,
                            rng=torch.Generator().manual_seed(seed))
    return {"seeds": seeds, "rank": mesh.rank, "data_index": mesh.data_index,
            "cls_after_layer_1": bb.cls_per_layer[0].cpu().numpy()}


def job_sharded_attention(device, shape, q, k, v, bias, rate: float = 0.0, seed: int = 0,
                          cotangent=None) -> Dict[str, Any]:
    """``sharded_flash_attention`` under mesh ``shape`` on full numpy inputs:
    the whole output (each rank's block, gathered), the offset seed, and
    with ``cotangent`` the gradients of ``sum(out * cotangent)`` in q, k, v
    and the bias (summed over the world: each rank reaches its block)."""
    from multi_modal_early_exit_tpu_torch.parallel.kernels import (
        shard_block,
        sharded_flash_attention,
    )
    from multi_modal_early_exit_tpu_torch.parallel.layers import shard_seed

    mesh = create_mesh(shape, device)
    ins = [torch.as_tensor(np.asarray(x)).to(device).requires_grad_(cotangent is not None)
           for x in (q, k, v, bias)]
    out = sharded_flash_attention(mesh, *ins, dropout_rate=rate, dropout_seed=seed)
    full = torch.zeros(ins[0].shape, dtype=out.dtype, device=device)
    shard_block(full, mesh).copy_(out.detach())
    world = dist.get_world_size()
    result = {"out": all_reduce(full, None, world).cpu().numpy(),
              "seed": shard_seed(seed, mesh.shard_index) if rate > 0 else None}
    if cotangent is not None:
        g = shard_block(torch.as_tensor(np.asarray(cotangent)).to(device), mesh)
        grads = torch.autograd.grad((out * g).sum(), ins)
        result["grads"] = [all_reduce(x, None, world).cpu().numpy() for x in grads]
    return result


def job_cli(device, argv: List[str], cwd: str) -> Dict[str, float]:
    """``cli.train.main(argv)`` in this rank of the world, from ``cwd``."""
    from multi_modal_early_exit_tpu_torch.cli import train

    os.chdir(cwd)
    return train.main(list(argv))


def job_cascade(device, cfg, state, batch, capacities, threshold, dtype: str = "float32"
                ) -> Dict[str, np.ndarray]:
    """The cascade under a data axis of the whole world: this rank serves
    its own rows at ``capacities`` (sized for its shard) with the replicated
    model (in ``dtype``); the per-shard results gathered in row order."""
    from multi_modal_early_exit_tpu_torch.models.ee.cascade import make_cascade_forward

    mesh = create_mesh(None, device)
    model = ee_model(cfg, state).to(device=device, dtype=getattr(torch, dtype))
    local = _tensors(shard_batch(batch, mesh), device)
    cascade = make_cascade_forward(cfg, capacities=capacities, threshold=threshold)
    r = cascade(model, local["input_ids"], local["bbox"], local["pixel_values"],
                local["attention_mask"])
    return {"logits": gather_rows(r.logits, mesh).cpu().numpy(),
            "exit_ids": gather_rows(r.exit_ids, mesh).cpu().numpy(),
            "capacity_exited": gather_rows(r.capacity_exited.to(torch.int32), mesh)
            .cpu().numpy().astype(bool)}


def job_launches(device, directory: Optional[str] = None, reset: bool = False
                 ) -> Dict[str, int]:
    """This rank's kernel launch counts (written to
    ``<directory>/launches-rank<R>.json`` when given); ``reset`` sets the
    counters to 0 after reading them."""
    from multi_modal_early_exit_tpu_torch.utils.profiling import (
        launch_counts,
        write_launch_counts,
    )

    if directory:
        write_launch_counts(directory, dist.get_rank())
    return launch_counts(reset=reset)


def _synced(device) -> float:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def job_unit_mesh(device, cfg, args: Dict[str, Any], batches, seed: int = 1) -> Dict[str, Any]:
    """The same steps (``EETrainer``, random parameters from seed 0, every
    generator seeded with ``seed``) under a (1, 1) mesh of this world of one
    and with no mesh: whether the parameters are bit-equal, and each step's
    seconds. Only the mesh trainer's launches count."""
    from multi_modal_early_exit_tpu_torch.training.trainer import EETrainer, TrainingArguments
    from multi_modal_early_exit_tpu_torch.utils.profiling import uncounted

    model = ee_model(cfg)
    single = EETrainer(cfg, copy.deepcopy(model), TrainingArguments(**args), 10, device=device)
    meshed = EETrainer(cfg, model, TrainingArguments(**args), 10, device=device,
                       mesh=create_mesh((1, 1), device))
    seconds = {}
    for name, trainer in (("mesh", meshed), ("single", single)):
        gen = torch.Generator().manual_seed(seed)
        times = []
        with contextlib.ExitStack() as stack:
            if name == "single":
                stack.enter_context(uncounted())
            for b in batches:
                t0 = _synced(device)
                trainer.train_step(b, gen)
                times.append(_synced(device) - t0)
        seconds[name] = times
    want = dict(single.model.named_parameters())
    differ = [n for n, p in meshed.model.named_parameters() if not torch.equal(p, want[n])]
    one = torch.ones(1, device=device)
    dist.all_reduce(one)  # the world's backend reduces on this device
    return {"differ": differ, "seconds": seconds, "backend": dist.get_backend(),
            "all_reduce": float(one)}


def job_sharded_headform(device, shape, dtype: str, rate: float, shape_bhsd=(16, 12, 768, 64),
                         seed: int = 0) -> Dict[str, Any]:
    """``sharded_flash_attention`` (forward and gradients) under mesh
    ``shape`` on inputs made on the device from ``seed`` (q/k/v/do in
    ``dtype``, an f32 bias), against, uncounted: at rate 0 the unsharded
    entry's block (``equal``: whether every output is bit-equal), above it
    the plain head-form forward and backward at the shard's seed (each
    output's max error over its scale, ``errors``)."""
    from multi_modal_early_exit_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd_plain,
        flash_attention_fwd_plain,
    )
    from multi_modal_early_exit_tpu_torch.parallel.kernels import (
        shard_block,
        sharded_flash_attention,
    )
    from multi_modal_early_exit_tpu_torch.parallel.layers import shard_seed
    from multi_modal_early_exit_tpu_torch.utils.profiling import uncounted

    mesh = create_mesh(shape, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    b, h, s, d = shape_bhsd
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device=device).to(dt)
                   for _ in range(4))
    bias = torch.randn((b, h, s, s), generator=gen, device=device)
    ins = [x.requires_grad_() for x in (q, k, v, bias)]
    out = sharded_flash_attention(mesh, *ins, dropout_rate=rate, dropout_seed=seed)
    grads = [shard_block(g, mesh) for g in torch.autograd.grad(out, ins, shard_block(do, mesh))]
    with uncounted():
        blk = [shard_block(x.detach(), mesh) for x in (q, k, v, bias, do)]
        if rate == 0.0:
            full = [x.detach().clone().requires_grad_() for x in (q, k, v, bias)]
            want_out = flash_attention(*full)
            want = [shard_block(g, mesh)
                    for g in torch.autograd.grad(want_out, full, do)]
            names = ("out", "dq", "dk", "dv", "dbias")
            pairs = zip(names, [out] + grads, [shard_block(want_out, mesh)] + want)
            return {"equal": {n: bool(torch.equal(a, w)) for n, a, w in pairs}}
        sseed = shard_seed(seed, mesh.shard_index)
        o, lse = flash_attention_fwd_plain(*blk[:4], sseed, rate)
        want = flash_attention_bwd_plain(*blk[:4], sseed, o, lse, blk[4], rate)
        errors = {}
        for n, a, w in zip(("out", "dq", "dk", "dv", "dbias"), [out] + grads, [o, *want]):
            errors[n] = float((a.detach().float() - w.float()).abs().max()
                              / w.float().abs().max())
        return {"errors": errors, "seed": sseed}


def job_step_timing(device, shape, cfg, args: Dict[str, Any], batches, seed: int = 1,
                    state: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """``EETrainer`` steps under mesh ``shape`` (``state``, else random
    parameters from seed 0) on this rank's rows of each batch: each step's
    seconds and the seconds inside collectives (``all_reduce`` and
    ``broadcast``, timed from a synchronised device to a synchronised
    device) in it."""
    from multi_modal_early_exit_tpu_torch.training.trainer import EETrainer, TrainingArguments

    mesh, model = _sharded_model(device, shape, cfg, state)
    trainer = EETrainer(cfg, model, TrainingArguments(**args), 10, device=device, mesh=mesh)
    gen = torch.Generator().manual_seed(seed)
    inside = [0.0]

    def timed(fn):
        def run(*a, **kw):
            t0 = _synced(device)
            out = fn(*a, **kw)
            inside[0] += _synced(device) - t0
            return out
        return run

    originals = dist.all_reduce, dist.broadcast
    dist.all_reduce, dist.broadcast = (timed(f) for f in originals)
    steps, collectives = [], []
    try:
        for b in batches:
            inside[0] = 0.0
            t0 = _synced(device)
            loss = trainer.train_step(shard_batch(b, mesh, axis=1), gen)[0]
            steps.append(_synced(device) - t0)
            collectives.append(inside[0])
    finally:
        dist.all_reduce, dist.broadcast = originals
    return {"seconds": steps, "collective_seconds": collectives, "loss": loss}


# ---------------------------------------------------------------------------
# dryrun_multichip
# ---------------------------------------------------------------------------


def dryrun_config():
    """The tiny config with exits ``text_avg, vision_avg, 1, 2``."""
    from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import (
        EEModelConfig,
        LayoutLMv3Config,
    )

    return EEModelConfig(backbone=LayoutLMv3Config.tiny(num_labels=4),
                         exit=ExitConfig(exits=("text_avg", "vision_avg", 1, 2)))


def dryrun_shape(n: int) -> tuple:
    """DP x TP (n/2, 2) for even n >= 4, else pure DP."""
    return (n // 2, 2) if n % 2 == 0 and n >= 4 else (n, 1)


def _dryrun_rank(device, n: int) -> Dict[str, Any]:
    cfg = dryrun_config()
    shape = dryrun_shape(n)
    accum, micro, seq = 2, 2 * shape[0], 16
    batch = example_batch(cfg, accum * micro, seq)
    batch = {k: v.reshape((accum, micro) + v.shape[1:]) for k, v in batch.items()}
    trained = job_train(device, shape, cfg, None,
                        dict(gradient_accumulation_steps=accum), [batch], total_steps=10)
    state = trained["params"]
    fwd = job_forward(device, shape, cfg, state, example_batch(cfg, 2 * shape[0], seq, seed=3))
    shard_b = 4
    serve = job_cascade(device, cfg, state, example_batch(cfg, n * shard_b, seq, seed=5),
                        capacities=(shard_b,) * 3, threshold=0.4)
    return {"loss": trained["losses"][0], "state": state, "forward": fwd, "serve": serve}


def dryrun_multichip(n_devices: int, device: str = "cpu", backend: str = "gloo",
                     timeout: float = 300.0) -> None:
    """Run the proofs above on ``n_devices`` ranks; raise on any failure."""
    from multi_modal_early_exit_tpu_torch.models.ee.cascade import make_cascade_forward

    results = spawn_world(n_devices, _dryrun_rank, n_devices, backend=backend, device=device,
                          timeout=timeout)
    losses = [r["loss"] for r in results]
    assert np.isfinite(losses[0]), f"non-finite loss {losses[0]}"
    assert all(x == losses[0] for x in losses), f"the ranks' losses differ: {losses}"

    cfg, seq = dryrun_config(), 16
    shape = dryrun_shape(n_devices)
    r0 = results[0]
    single = ee_model(cfg, r0["state"])
    batch = _tensors(example_batch(cfg, 2 * shape[0], seq, seed=3), "cpu")
    with torch.no_grad():
        out = _forward(single, cfg, batch)
    for name, want in (("policy_logits", out.policy_logits()),
                       ("exit_criteria", out.exit_criteria)):
        diff = float(np.max(np.abs(r0["forward"][name] - want.numpy())))
        assert diff < 1e-4, f"sharded forward diverges in {name}: {diff}"

    shard_b = 4
    cascade = make_cascade_forward(cfg, capacities=(shard_b,) * 3, threshold=0.4)
    serve_batch = _tensors(example_batch(cfg, n_devices * shard_b, seq, seed=5), "cpu")
    want = {"logits": [], "exit_ids": [], "capacity_exited": []}
    for s in range(0, n_devices * shard_b, shard_b):
        rows = {k: v[s:s + shard_b] for k, v in serve_batch.items()}
        r = cascade(single, rows["input_ids"], rows["bbox"], rows["pixel_values"],
                    rows["attention_mask"])
        want["logits"].append(r.logits.numpy())
        want["exit_ids"].append(r.exit_ids.numpy())
        want["capacity_exited"].append(r.capacity_exited.numpy())
    got = r0["serve"]
    np.testing.assert_array_equal(got["exit_ids"], np.concatenate(want["exit_ids"]))
    np.testing.assert_array_equal(got["capacity_exited"],
                                  np.concatenate(want["capacity_exited"]))
    diff = float(np.max(np.abs(got["logits"] - np.concatenate(want["logits"]))))
    assert diff < 1e-4, f"sharded cascade logits diverge: {diff}"

