"""Kimi-Linear-48B-A3B-Instruct as the early-exit model's backbone:
Moonlight's block with Kimi Delta Attention (a gated delta rule) in three
of every four layers and MLA without rotary embeddings in the fourth, its
expert layers holding the card's share of 256 experts."""

from multi_modal_early_exit_tpu_torch.models.kimi_linear.config import (  # noqa: F401
    KimiLinearConfig,
)
from multi_modal_early_exit_tpu_torch.models.kimi_linear.modeling import (  # noqa: F401
    KimiLinearModel,
    KimiLinearStages,
    last_token_states,
)
