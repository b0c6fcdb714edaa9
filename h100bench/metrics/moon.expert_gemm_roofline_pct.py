"""moon.expert_gemm_roofline_pct: the grouped expert products' bound (each
expert layer's pairs from the ``moe.routed_pairs`` counter,
``h100bench.moonlight.expert_gemm_cost``) over the device time of the GEMM
kernels launched inside ``moe.experts``."""

from h100bench import moonlight


def read(run):
    return moonlight.expert_gemm_roofline_pct(run)
