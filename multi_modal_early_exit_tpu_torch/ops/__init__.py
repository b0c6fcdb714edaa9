"""Exit criteria and the hand-written CUDA kernels with their plain versions."""
