"""Kimi-VL-A3B-Instruct (MoonViT, a native-resolution vision tower, in
front of Moonlight's decoder) as the early-exit model's backbone: each
scanned page read at its own resolution."""

from multi_modal_early_exit_tpu_torch.models.kimi_vl.config import (  # noqa: F401
    KimiVLConfig,
    MoonViTConfig,
)
from multi_modal_early_exit_tpu_torch.models.kimi_vl.modeling import (  # noqa: F401
    KimiVLModel,
    KimiVLStages,
    last_token_states,
)
