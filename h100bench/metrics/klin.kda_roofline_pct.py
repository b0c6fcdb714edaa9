"""klin.kda_roofline_pct: the KDA core's bound over the slice's real tokens
(``h100bench.kimi_linear.kda_cost`` of the ``kda.tokens`` the program
counted while the slice ran: q, k, v and o in bf16 and g in f32 once each,
against the chunked form's operations; the larger of bytes over 3.35 TB/s
and operations over 989 TFLOP/s) over the device time of what was launched
inside the program's ``kda.core`` spans. What an implementation pads to
reads the same work."""

from h100bench import kimi_linear


def read(run):
    return kimi_linear.kda_roofline_pct(run)
