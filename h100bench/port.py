"""The program under test, built from a configuration file: the port's
config objects and ``EEModel`` loaded with the harness's weights. Only the
entries import this module, and only they import the port."""

from __future__ import annotations

import dataclasses

import torch


def ee_config(cfg: dict):
    """The port's ``EEModelConfig`` for a configuration file."""
    from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import (
        EEModelConfig,
        LayoutLMv3Config,
    )

    fields = {f.name for f in dataclasses.fields(LayoutLMv3Config)}
    backbone = LayoutLMv3Config(**{k: v for k, v in cfg.items() if k in fields})
    exit_cfg = ExitConfig(
        exits=tuple(cfg["exits"]), inference_strategy=cfg["inference_strategy"],
        training_strategy=cfg["training_strategy"],
        exit_head_num_layers=cfg["exit_head_num_layers"], gamma=cfg["gamma"],
    )
    return EEModelConfig(backbone=backbone, exit=exit_cfg)


def ee_model(cfg: dict, w: dict, device, dtype):
    """An ``EEModel`` in ``dtype`` on ``device`` holding copies of ``w``."""
    from multi_modal_early_exit_tpu_torch.models.ee.model import EEModel

    model = EEModel(ee_config(cfg), device=device).to(dtype)
    model.load_state_dict(w, strict=True)
    return model


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
