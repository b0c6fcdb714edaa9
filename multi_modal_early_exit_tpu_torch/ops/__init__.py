"""Exit criteria and the hand-written CUDA kernels with their plain versions.

Only the criteria are imported here; the kernel modules load when imported
by name, and their CUDA libraries on first use."""

from multi_modal_early_exit_tpu_torch.ops.criteria import (  # noqa: F401
    entropy,
    lte,
    max_confidence,
)
