"""PyTorch port, the experiment config and its command line
(``config/experiment.py``) against the JAX package's: the same
``to_dict()`` for the same argv, and a ``config.json`` written by either
package loads in the other. The one difference is ``device``: the port
defaults to ``"cuda"`` (the JAX package to ``"tpu"``, a field it reads
nowhere), and its CLIs read it."""

import json

import pytest

from multi_modal_early_exit_tpu.config import experiment as JE
from multi_modal_early_exit_tpu_torch.config import experiment as TE

ARGVS = [
    [],
    ["debugEE"],
    ["with", "debugEE", "epochs=3", "batch_size=4"],
    ["layoutlmv3", "with", "model=LTElayoutlmv3", "lr=3e-4", "use_lte=true"],
    ["with", "exits=text_avg,vision_avg,7", "training_strategy=one_stage_subgraphs_weighted"],
    ["with", "eval_start=1", "use_wandb=yes", "apply_ocr=off", "gamma=0.5", "scan_fold=12"],
    ["-c", "save/run/checkpoint-1", "-d", "synthetic_rvl_cdip_tiny", "-l", "validation"],
    ["--exit_threshold", "0.05", "--full_test", "True", "--calibrate", "True",
     "--step", "0.05"],
    ["--plot_exits", "--benchmark_OCR", "--print_freq", "7", "--downsampling", "5",
     "--exit_policy", "patience_policy", "--epsilon", "0.2", "--eval-start"],
    ["debugEE", "with", "global_threshold=0.7", "--calibrate", "false",
     "--inference_strategy", "max_confidence"],
]


def _without_device(d):
    return {k: v for k, v in d.items() if k != "device"}


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) or "defaults" for a in ARGVS])
def test_parse_cli_matches_jax(argv):
    want = JE.parse_cli(list(argv)).to_dict()
    got = TE.parse_cli(list(argv)).to_dict()
    assert _without_device(got) == _without_device(want)
    assert (got["device"], want["device"]) == ("cuda", "tpu")
    assert TE.parse_cli(list(argv) + ["with", "device=cpu"]).device == "cpu"


def test_named_configs_and_exit_config_match_jax():
    assert TE.NAMED_CONFIGS == JE.NAMED_CONFIGS
    for argv in ARGVS:
        want = JE.parse_cli(list(argv)).exit_config().to_dict()
        got = TE.parse_cli(list(argv)).exit_config().to_dict()
        assert json.loads(json.dumps(got)) == json.loads(json.dumps(want)), argv


@pytest.mark.parametrize("value,current,want", [
    ("yes", True, True), ("0", False, False), ("7", 3, 7), ("2e-5", 0.1, 2e-5),
    ("a,b", ("x",), "a,b"), ("name", "old", "name"),
])
def test_coerce_matches_jax(value, current, want):
    assert TE._coerce(value, current) == JE._coerce(value, current) == want


def test_unknown_token_raises_in_both():
    for module in (JE, TE):
        with pytest.raises(ValueError, match="unrecognised"):
            module.parse_cli(["nonsense"])


def test_a_config_json_of_either_package_loads_in_the_other(tmp_path):
    argv = ["debugEE", "with", "exits=text_avg,1", "lr=3e-4", "extra_field=1"]
    jpath, tpath = tmp_path / "jax.json", tmp_path / "port.json"
    JE.parse_cli(list(argv)).save(str(jpath))
    TE.parse_cli(list(argv) + ["with", "device=cpu"]).save(str(tpath))
    from_jax = TE.ExperimentConfig.load(str(jpath))
    from_port = JE.ExperimentConfig.load(str(tpath))
    assert from_jax.device == "tpu" and from_port.device == "cpu"
    assert _without_device(from_jax.to_dict()) == _without_device(
        JE.ExperimentConfig.load(str(jpath)).to_dict())
    assert _without_device(from_port.to_dict()) == _without_device(
        TE.ExperimentConfig.load(str(tpath)).to_dict())
    assert from_jax.extra == {"extra_field": "1"}
