"""klin.mfu_pct: the published model's forward FLOPs for every document the
window served, each on its own tokens up to the exit it took with the heads
it evaluated, the experts at the card's held share (4 of the 8 pairs a
token; ``h100bench.kimi_linear.doc_flops_to_exit``), over the window's
seconds and the bf16 dense peak: the whole step's share of the peak."""

from h100bench import flops


def read(run):
    return 100.0 * run.window["model_flops"] / run.window["seconds"] / flops.PEAK_BF16_FLOPS
