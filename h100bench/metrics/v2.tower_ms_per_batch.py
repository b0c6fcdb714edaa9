"""v2.tower_ms_per_batch: device ms per batch of the kernels launched under
the convolution operations (aten::cudnn_convolution and kin) of LayoutLMv2's
visual tower (``models/layoutlmv2/modeling.py::visual_backbone_apply``), by
the profiler's link from each kernel to the operation that launched it."""

CONV_OPS = r"^aten::(cudnn_convolution|convolution|_convolution|conv2d)"


def read(run):
    if run.trace is None or not run.units:
        return None
    spent = run.trace.kernel_s_under(CONV_OPS)
    return 1e3 * spent / run.units if spent > 0 else None
