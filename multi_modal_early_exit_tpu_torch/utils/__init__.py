"""Host utilities: logging, running meters and the artifact files (npz logit
stores, JSON results) shared with the JAX package."""

from multi_modal_early_exit_tpu_torch.utils.logging import logger_message  # noqa: F401
from multi_modal_early_exit_tpu_torch.utils.meters import AverageMeter  # noqa: F401
from multi_modal_early_exit_tpu_torch.utils.seeding import seed_everything  # noqa: F401
from multi_modal_early_exit_tpu_torch.utils.artifacts import (  # noqa: F401
    config_to_checkpoint,
    load_json,
    load_npz,
    save_json,
    save_npz,
)
