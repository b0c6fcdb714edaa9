"""Model definitions: the LayoutLMv3 backbone, the early-exit model, the
variants, and the registry's ``build_model``."""

from multi_modal_early_exit_tpu_torch.models.registry import build_model  # noqa: F401
