"""Early-exit configuration vocabulary and the experiment config (own copies
of the JAX package's)."""

from multi_modal_early_exit_tpu_torch.config.exit_config import (  # noqa: F401
    EarlyExitHead,
    EarlyExitInference,
    EarlyExitStrategy,
    ExitConfig,
    parse_exits,
)
from multi_modal_early_exit_tpu_torch.config.experiment import (  # noqa: F401
    ExperimentConfig,
    NAMED_CONFIGS,
    parse_cli,
)
