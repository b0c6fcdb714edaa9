"""train.elementwise_ms_per_step: device ms per step of every kernel in the
traced slice that is none of the port's own (csrc/), a cuBLAS or CUTLASS
GEMM, or a cuDNN convolution (tracing.kind); the hash dropout lands here."""


def read(run):
    if run.trace is None or not run.units:
        return None
    return 1e3 * run.trace.kernel_s(kinds={"other"}) / run.units
