"""LayoutLMv3: config, parameter modules, forward path, weight bridge."""

from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import (  # noqa: F401
    EEModelConfig,
    LayoutLMv3Config,
)
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling import (  # noqa: F401
    backbone_apply,
    classifier_apply,
    encoder_apply,
    forward_sequence_classification,
    init_params,
    make_attention_bias,
)
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.convert import (  # noqa: F401
    convert_torch_state_dict,
    jax_params_to_torch_state_dict,
    load_jax_params,
    to_jax_params,
)
