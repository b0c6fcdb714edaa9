"""multi_modal_early_exit_tpu_torch — the PyTorch + CUDA port of
``multi_modal_early_exit_tpu`` for NVIDIA Hopper (H100, sm_90a).

The sub-packages mirror the JAX package's (``config``, ``data``, ``ops``,
``models``, ``serving``), so each module's counterpart is found by name. The
port imports neither JAX nor the JAX package; it keeps its own copies of the
framework-free modules it needs.

Entry points (``serving.Pipeline``, the model constructors,
``models.ee.model.init_ee_params``) run on ``cuda`` unless the caller passes
``device="cpu"``, and raise when no CUDA device exists. On CUDA they switch
off TF32 (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), so f32 matmuls stay f32.

Every TPU (Pallas) kernel on the ported path is a hand-written CUDA kernel
under ``csrc/`` (built by ``ops/cuda_build.py`` at first use), with a plain
PyTorch version beside it that CPU tensors run.

The package root exports what the JAX package's root does: ``Pipeline`` and
the exit-config vocabulary. Importing it builds no kernel and imports
neither JAX nor the JAX package.
"""

__version__ = "0.1.0"

from multi_modal_early_exit_tpu_torch.config.exit_config import (  # noqa: F401
    EarlyExitHead,
    EarlyExitInference,
    EarlyExitStrategy,
    ExitConfig,
)

from multi_modal_early_exit_tpu_torch.serving import Pipeline  # noqa: F401,E402
