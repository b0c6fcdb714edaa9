"""LayoutLMv2: the ResNeXt-FPN visual tower, the v2 embeddings, the dense classifier."""

from multi_modal_early_exit_tpu_torch.models.layoutlmv2.config import LayoutLMv2Config
from multi_modal_early_exit_tpu_torch.models.layoutlmv2.modeling import (
    LayoutLMv2Output,
    forward_sequence_classification,
    init_params,
    visual_grid_bbox,
)

__all__ = [
    "LayoutLMv2Config",
    "LayoutLMv2Output",
    "forward_sequence_classification",
    "init_params",
    "visual_grid_bbox",
]
