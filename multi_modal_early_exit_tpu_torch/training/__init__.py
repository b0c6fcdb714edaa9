"""Training: the EE losses, per-exit subgraph accounting and the trainer."""

from multi_modal_early_exit_tpu_torch.training.losses import (  # noqa: F401
    combine_losses,
    ee_loss_fn,
)
from multi_modal_early_exit_tpu_torch.training.subgraphs import (  # noqa: F401
    apply_entropyreg,
    exit_loss_weights,
    exit_named_parameters,
    subgraph_param_counts,
)
from multi_modal_early_exit_tpu_torch.training.trainer import (  # noqa: F401
    EETrainer,
    TrainingArguments,
)
