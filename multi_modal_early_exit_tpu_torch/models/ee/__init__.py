"""Early-exit heads, batched EE forward, and the anytime cascade.

The JAX package's ``init_exit_head`` and ``init_lte_head`` have no
counterpart here, deliberately: a head's parameters are made by its module's
constructor, ``heads.ExitHead`` (an exit head) and
``layoutlmv3.modeling.Linear(hidden, 1)`` (the LTE head, ``EEModel.lte``),
and initialised with the rest of the model by ``init_ee_params``."""

from multi_modal_early_exit_tpu_torch.models.ee.heads import (  # noqa: F401
    exit_head_apply,
    lte_head_apply,
)
from multi_modal_early_exit_tpu_torch.models.ee.model import (  # noqa: F401
    EEOutputs,
    canonical_exit_order,
    ee_forward,
    init_ee_params,
    prune_ee_params,
)
from multi_modal_early_exit_tpu_torch.models.ee.engine import AnytimeEngine  # noqa: F401
from multi_modal_early_exit_tpu_torch.models.ee.cascade import (  # noqa: F401
    CascadeResult,
    capacities_from_distribution,
    make_cascade_forward,
)
