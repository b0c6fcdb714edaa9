"""Moonlight-16B-A3B (DeepSeek-V3's block: latent attention, sparse and
shared experts) as the early-exit model's text backbone."""

from multi_modal_early_exit_tpu_torch.models.moonlight.config import (  # noqa: F401
    MoonlightConfig,
    MoonlightExitConfig,
)
from multi_modal_early_exit_tpu_torch.models.moonlight.modeling import (  # noqa: F401
    MoonlightModel,
    last_token_states,
)
