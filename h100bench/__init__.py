"""The benchmark of the PyTorch and CUDA port (``multi_modal_early_exit_tpu_torch``)
on one NVIDIA H100: see ``run.py``."""
