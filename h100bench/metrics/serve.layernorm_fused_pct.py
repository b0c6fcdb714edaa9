"""serve.layernorm_fused_pct: the share of LayerNorm rows (residual add
included) that the hand-written kernel normalised, 100 x
``layer_norm.fused_rows`` / (fused + ``layer_norm.composed_rows``), from the
program's counters over the whole run. None without the counters (an older
program) or without a LayerNorm call."""

from h100bench import spans


def read(run):
    counts = spans.counters()
    if not counts:
        return None
    fused = counts.get("layer_norm.fused_rows", 0)
    total = fused + counts.get("layer_norm.composed_rows", 0)
    return 100.0 * fused / total if total else None
