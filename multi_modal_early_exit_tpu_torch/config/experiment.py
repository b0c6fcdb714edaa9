"""Experiment configuration: defaults, named presets, and CLI parsing.

The port's copy of the JAX package's ``config/experiment.py``: one typed
dataclass for the reference's two-layer sacred+argparse system
(reference: EE/configs.py:18-187):

- defaults mirror ``@ex.config default()`` (EE/configs.py:25-59)
- named presets mirror ``@ex.named_config`` (EE/configs.py:62-77)
- ``with key=value`` CLI overrides and the eval argparse flags
  (EE/configs.py:80-187) are merged into one parser.

The ``config.json`` schema is the JAX package's, so a run saved by either
package loads in the other. One field differs: ``device`` defaults to
``"cuda"`` (the card; ``with device=cpu`` asks for the CPU), and the port's
CLIs read it to place the model and batches.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig


@dataclasses.dataclass
class ExperimentConfig:
    # model / dataset ---------------------------------------------------
    model: str = "EElayoutlmv3"
    # backbone size preset: "base" (reference: microsoft/layoutlmv3-base)
    # or "tiny" (2-layer debug backbone — pairs with the debugEE preset for
    # seconds-long smoke runs; no reference equivalent, EE/configs.py only
    # ships base-size models)
    model_size: str = "base"
    dataset: str = "synthetic_rvl_cdip"
    model_weights: str = "microsoft/layoutlmv3-base"
    lowercase: bool = False
    apply_ocr: bool = True
    downsampling: int = 0
    eval_start: bool = False

    # optimisation ------------------------------------------------------
    epochs: int = 20
    batch_size: int = 2
    eval_batch_size: int = 1
    lr: float = 1e-4
    optimizer: str = "AdamW"
    warmup_ratio: float = 0.0
    weight_decay: float = 0.0
    gradient_accumulation_steps: int = 1

    seed: int = 42
    device: str = "cuda"  # where the port's CLIs run: "cuda" or "cpu"

    use_wandb: bool = False

    # early-exit hyperparameters (mirrors EE/configs.py:48-59) ---------
    training_strategy: str = "joint_weighted_avg"
    inference_strategy: str = "max_confidence"
    global_threshold: float = 0.9
    exits: Union[str, Sequence] = ("text_visual_concat", 6)
    encoder_layer_strategy: str = "ramp"
    exit_head_num_layers: int = 2
    use_lte: bool = False
    alpha: float = 0.5
    temperature: float = 1.0
    gamma: float = 0.0

    # eval flags (mirrors EE/configs.py:80-187) ------------------------
    checkpoint: str = ""
    test_dataset: str = "synthetic_rvl_cdip"
    labelset: str = "test"
    exit_threshold: float = -1.0
    benchmark_OCR: bool = False
    print_freq: int = 50
    plot_exits: bool = False
    calibrate: bool = False
    full_test: bool = False
    step: float = 0.1
    exit_policy: str = "max_confidence_global_thresholding_policy"
    epsilon: float = 0.1

    # parallelism and precision (no reference equivalent) -------------
    mesh_shape: Tuple[int, ...] = (1, 1)  # (data, model); the port runs one device
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # encoder layers per step of the layer schedule (must divide the layer
    # count): 1 hands every layer the bias tensor, the layer count chains
    # the bias cotangent (models/layoutlmv3/modeling.py);
    # MMEE_LAYERS_PER_STEP overrides it at run time
    scan_fold: int = 1

    # bookkeeping -------------------------------------------------------
    output_dir: str = "./save"
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def exit_config(self) -> ExitConfig:
        return ExitConfig(
            training_strategy=self.training_strategy,
            inference_strategy=self.inference_strategy,
            global_threshold=self.global_threshold,
            exits=self.exits,
            encoder_layer_strategy=self.encoder_layer_strategy,
            exit_head_num_layers=self.exit_head_num_layers,
            use_lte=self.use_lte,
            gamma=self.gamma,
            alpha=self.alpha,
            temperature=self.temperature,
        )

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["exits"] = list(self.exits) if not isinstance(self.exits, str) else self.exits
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in d.items() if k in fields}
        extra = {k: v for k, v in d.items() if k not in fields}
        cfg = cls(**known)
        cfg.extra.update(extra)
        return cfg

    def replace(self, **kwargs) -> "ExperimentConfig":
        return dataclasses.replace(self, **kwargs)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))


# Named presets (reference: EE/configs.py:62-77).
NAMED_CONFIGS: Dict[str, Dict[str, Any]] = {
    "layoutlmv3": dict(
        epochs=20, lr=2e-5, gradient_accumulation_steps=32, global_threshold=1 + 1e-6
    ),
    "debugEE": dict(
        model="EElayoutlmv3",
        model_size="tiny",  # seconds-long smoke runs (override: model_size=base)
        dataset="synthetic_rvl_cdip_tiny",
        epochs=1,
        lr=2e-5,
        batch_size=1,
        gradient_accumulation_steps=1,
    ),
}


def _coerce(value: str, current: Any) -> Any:
    """Coerce a CLI string to the type of the current config value."""
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, (tuple, list)):
        return value  # exits parsing handles comma strings
    return value


def parse_cli(
    argv: Optional[List[str]] = None, base: Optional[ExperimentConfig] = None
) -> ExperimentConfig:
    """Parse ``[preset] with key=value ...`` plus argparse-style eval flags.

    Mirrors the reference's sacred ``with`` override syntax plus the eval
    argparse channel (EE/configs.py:80-187) in one place.
    """
    cfg = base or ExperimentConfig()
    argv = list(argv or [])

    parser = argparse.ArgumentParser(description="multi-modal early exit")
    parser.add_argument("-c", "--checkpoint", type=str, default=None)
    parser.add_argument("-d", "--test_dataset", type=str, default=None)
    parser.add_argument("-l", "--labelset", type=str, default=None,
                        choices=["train", "validation", "test"])
    parser.add_argument("--exit_threshold", type=float, default=None)
    parser.add_argument("--inference_strategy", type=str, default=None)
    parser.add_argument("--benchmark_OCR", action="store_true", default=None)
    parser.add_argument("--print_freq", type=int, default=None)
    parser.add_argument("--plot_exits", action="store_true", default=None)
    parser.add_argument("--downsampling", type=int, default=None)
    parser.add_argument("--calibrate", type=str, default=None)
    parser.add_argument("--full_test", type=str, default=None)
    parser.add_argument("--step", type=float, default=None)
    parser.add_argument("--exit_policy", type=str, default=None)
    parser.add_argument("--epsilon", type=float, default=None)
    parser.add_argument("--eval-start", action="store_true", default=None)
    args, remaining = parser.parse_known_args(argv)

    overrides: Dict[str, Any] = {}
    # preset / with key=value syntax
    i = 0
    while i < len(remaining):
        tok = remaining[i]
        if tok == "with":
            i += 1
            continue
        if "=" in tok:
            key, value = tok.split("=", 1)
            current = getattr(cfg, key, None)
            overrides[key] = _coerce(value, current) if current is not None else value
        elif tok in NAMED_CONFIGS:
            overrides.update(NAMED_CONFIGS[tok])
        else:
            raise ValueError(f"unrecognised CLI token: {tok!r}")
        i += 1

    for key, value in vars(args).items():
        key = key.replace("-", "_")
        if value is None:
            continue
        if key in ("calibrate", "full_test"):
            value = str(value).lower() in ("1", "true", "yes", "on")
        overrides[key] = value

    merged = cfg.to_dict()
    merged.update(overrides)
    return ExperimentConfig.from_dict(merged)
