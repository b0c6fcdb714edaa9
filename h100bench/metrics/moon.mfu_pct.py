"""moon.mfu_pct: the published model's forward FLOPs for every document the
window served, each on its own tokens up to the exit it took with the heads
it evaluated (``h100bench.moonlight.doc_flops_to_exit``), over the window's
seconds and the bf16 dense peak."""

from h100bench import flops


def read(run):
    return 100.0 * run.window["model_flops"] / run.window["seconds"] / flops.PEAK_BF16_FLOPS
