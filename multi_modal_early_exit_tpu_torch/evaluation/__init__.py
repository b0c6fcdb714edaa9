"""Anytime evaluation over per-exit logit stores: metrics, exit policies,
per-exit temperature calibration, threshold sweeps, FLOPs analysis and the
harvest-calibrate-sweep pipeline, serving operating points and exit plots.
The port's copy of the JAX package's ``evaluation`` package, without
scikit-learn."""

from multi_modal_early_exit_tpu_torch.evaluation.metrics import (  # noqa: F401
    METRICS,
    accuracy,
    aurc_logits,
    brier_loss,
    calc_metrics,
    ece_logits,
    f1_macro,
    f1_micro,
    nll,
)
from multi_modal_early_exit_tpu_torch.evaluation.policy import Policy  # noqa: F401
from multi_modal_early_exit_tpu_torch.evaluation.calibration import (  # noqa: F401
    TemperatureScaler,
    get_platt_scaler,
)
from multi_modal_early_exit_tpu_torch.evaluation.analysis import (  # noqa: F401
    Analysis,
    calc_flops,
)
from multi_modal_early_exit_tpu_torch.evaluation.pipeline import (  # noqa: F401
    calibrate,
    eval_model,
    evaluate_checkpoint,
    full_test_iteration,
    get_logits,
)
from multi_modal_early_exit_tpu_torch.evaluation.thresholds import (  # noqa: F401
    incremental_global_sweep,
    mixture_pareto_sweep,
    naive_global_sweep,
    time_global_sweeps,
    vectorized_global_sweep,
)
