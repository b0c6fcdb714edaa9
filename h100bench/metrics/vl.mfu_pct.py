"""vl.mfu_pct: the published model's forward FLOPs for every page the window
served, the vision tower and the projector on its own patches and the
decoder on its row's own tokens up to the exit it took with the heads it
evaluated (``h100bench.kimi_vl.doc_flops_to_exit``), over the window's
seconds and the bf16 dense peak: the whole step's share of the peak."""

from h100bench import flops


def read(run):
    return 100.0 * run.window["model_flops"] / run.window["seconds"] / flops.PEAK_BF16_FLOPS
