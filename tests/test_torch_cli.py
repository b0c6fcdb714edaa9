"""PyTorch port, the command-line path: ``cli.train`` (the debugEE preset on
the CPU) -> a checkpoint -> ``cli.evaluate`` (dump, then a full sweep with
calibration) -> ``cli.research`` (numpy backend), with the JAX CLIs'
artifact layout; and the logit stores of the two packages feed each other's
``cli.research``, whose Pareto fronts are equal on the same store. The JAX
side's own train -> evaluate run is ``slow``; the fast test writes its store
with the JAX package's ``dump_logits``, the function its ``cli.evaluate``
dumps with."""

import glob
import json
import os

import numpy as np
import pytest

from multi_modal_early_exit_tpu.cli import research as j_research
from multi_modal_early_exit_tpu.utils import artifacts as JA
from multi_modal_early_exit_tpu_torch.cli import evaluate, research, train
from multi_modal_early_exit_tpu_torch.utils import artifacts as TA

TRAIN = ["with", "debugEE", "device=cpu", "epochs=1", "batch_size=4", "exits=text_avg,1",
         "training_strategy=joint_weighted_avg", "lr=3e-4", "output_dir=save",
         "eval_batch_size=8"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    cwd = os.getcwd()
    os.chdir(d)
    yield str(d)
    os.chdir(cwd)


@pytest.fixture(scope="module")
def trained(workdir):
    metrics = train.main(list(TRAIN))
    return metrics, sorted(glob.glob("save/*/checkpoint-*"))


def test_train_writes_metrics_and_checkpoints(trained):
    from multi_modal_early_exit_tpu_torch.training.checkpoint import load_checkpoint

    metrics, ckpts = trained
    # the JAX trainer's keys: accuracy, exit_j_accuracy and exit_j_share
    assert set(metrics) == {"accuracy", "exit_0_accuracy", "exit_1_accuracy", "exit_0_share",
                            "exit_1_share", "exit_2_share"}
    assert len(ckpts) == 1 and ckpts[0].endswith(
        "EElayoutlmv3_synthetic_rvl_cdip_tiny_joint_weighted_avg_text_avg-1/checkpoint-0")
    state, config, _, step = load_checkpoint(ckpts[0])
    assert config["model"] == "EElayoutlmv3" and config["device"] == "cpu" and step == 0
    assert any(k.startswith("backbone.encoder.layers.") for k in state)


def test_evaluate_and_research_write_the_jax_artifacts(trained):
    _, ckpts = trained
    ck = ckpts[-1]
    out = evaluate.main(["-c", ck, "-d", "synthetic_rvl_cdip_tiny", "with", "device=cpu"])
    assert out == {"mode": "dump", "n": 8}
    root = "results/checkpoint-0-synthetic_rvl_cdip_tiny"
    store = np.load(os.path.join(root, "exit_logits-test.npz"))["arr_0"]
    assert store.shape == (3, 8, 4) and store.dtype == np.float64
    out = evaluate.main(["-c", ck, "-d", "synthetic_rvl_cdip_tiny", "--exit_threshold", "0.5",
                         "--calibrate", "true", "--full_test", "true", "--step", "0.25",
                         "with", "device=cpu"])
    assert out == {"mode": "full_test", "n_thresholds": 2}
    assert os.path.exists(os.path.join(root, "exit_logits-calibrated.npz"))
    with open(os.path.join(root, "max_confidence_global_thresholding_policy",
                           "calibrated-metrics.json")) as f:
        results = json.load(f)
    assert len(results) == 2
    assert all({"accuracy", "GFLOPs reduction", "exit_distribution"} <= set(r) for r in results)
    saved = json.load(open(os.path.join(root, "config.json")))
    assert saved["device"] == "cpu" and "calibration_metrics" in saved
    out = research.main(["--checkpoint-dir", root, "--num-mixtures", "2000",
                         "--backend", "numpy"])
    accs = [p["accuracy"] for p in out["pareto"]]
    assert accs == sorted(accs) and all(p["efficiency"] for p in out["pareto"])
    assert os.path.exists(os.path.join(root, "mixture_search.json"))


def test_evaluate_takes_the_device_from_the_command_line(trained, tmp_path):
    """A saved config.json that names another device (the JAX package
    writes "tpu") is not read for it; a device torch does not know raises."""
    _, ckpts = trained
    ck = ckpts[-1]
    cfg_file = os.path.join(ck, "config.json")
    saved = json.load(open(cfg_file))
    try:
        json.dump(dict(saved, device="tpu"), open(cfg_file, "w"))
        cfg, _, model = evaluate.load_assets(evaluate.parse_cli(
            ["-c", ck, "-d", "synthetic_rvl_cdip_tiny", "with", "device=cpu"]))
        assert cfg.device == "cpu" and next(model.parameters()).device.type == "cpu"
        with pytest.raises(RuntimeError):
            evaluate.load_assets(evaluate.parse_cli(
                ["-c", ck, "-d", "synthetic_rvl_cdip_tiny", "with", "device=nonsense"]))
    finally:
        json.dump(saved, open(cfg_file, "w"))


def _front(out):
    return [(p["accuracy"], p["average_exit"], p["thresholds"]) for p in out["pareto"]]


def _store(seed, e=3, n=64, k=4):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, n)
    store = rng.standard_normal((e, n, k))
    for i in range(e):
        store[i, np.arange(n), labels] += (i + 1) * rng.random(n)
    return store, labels


def test_each_package_reads_the_other_s_store(workdir):
    """A store dumped by the JAX package feeds the port's research, and
    the reverse; on the same store both fronts are equal (numpy backends)."""
    config = {"checkpoint": "xck", "test_dataset": "synthetic_rvl_cdip_tiny", "model": "EElayoutlmv3",
              "model_size": "tiny", "exits": ["text_avg", 1], "model_weights": ""}
    store, labels = _store(0)
    j_dir = JA.dump_logits(store, labels, dict(config, checkpoint="from_jax"), root="cross")
    t_dir = TA.dump_logits(store, labels, dict(config, checkpoint="from_port"), root="cross")
    args = ["--num-mixtures", "3000", "--backend", "numpy"]
    fronts = {}
    for name, d in (("jax", j_dir), ("port", t_dir)):
        fronts[f"port reads {name}"] = _front(research.main(["--checkpoint-dir", d] + args))
        fronts[f"jax reads {name}"] = _front(j_research.main(["--checkpoint-dir", d] + args))
    assert len(set(json.dumps(f) for f in fronts.values())) == 1, fronts
    assert fronts["port reads jax"]


@pytest.mark.slow
def test_the_jax_cli_store_and_the_port_cli_store_cross(workdir, trained):
    """The JAX CLIs' own train -> evaluate dump feeds the port's research,
    the port's evaluate dump feeds the JAX research; each front equals the
    other package's on the same store."""
    from multi_modal_early_exit_tpu.cli import evaluate as j_evaluate
    from multi_modal_early_exit_tpu.cli import train as j_train

    j_train.main([t for t in TRAIN if t != "device=cpu"] + ["output_dir=jsave"])
    j_ck = sorted(glob.glob("jsave/*/checkpoint-*"))[-1]
    j_evaluate.main(["-c", j_ck, "-d", "synthetic_rvl_cdip_tiny"])
    _, ckpts = trained
    evaluate.main(["-c", ckpts[-1], "-d", "synthetic_rvl_cdip_tiny", "with", "device=cpu"])
    args = ["--num-mixtures", "3000", "--backend", "numpy"]
    for d in ("results/checkpoint-0-synthetic_rvl_cdip_tiny",):
        assert os.path.exists(os.path.join(d, "exit_logits-test.npz"))
    dirs = sorted(glob.glob("results/*"))
    for d in dirs:
        if not os.path.exists(os.path.join(d, "exit_logits-test.npz")):
            continue
        port = _front(research.main(["--checkpoint-dir", d] + args))
        jax_ = _front(j_research.main(["--checkpoint-dir", d] + args))
        assert port == jax_ and port
