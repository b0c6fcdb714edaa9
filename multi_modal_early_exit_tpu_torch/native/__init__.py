"""Native (C++/OpenMP) host kernels: the threshold-mixture sweep. Importing
``sweep`` builds nothing: its library is built on first use."""

from multi_modal_early_exit_tpu_torch.native import sweep  # noqa: F401
