"""setup_s: seconds from the process's start to the window's: imports, the
CUDA context, the kernels' build when not cached, the pool, the weights,
the calibration and the warm-up (host clock)."""


def read(run):
    return run.setup_s
