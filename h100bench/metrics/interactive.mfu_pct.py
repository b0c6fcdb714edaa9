"""interactive.mfu_pct: the forward FLOPs of the published model for every
document the window served, each counted up to the exit it took with the
heads it evaluated, over the window's seconds and the bf16 dense peak."""

from h100bench import flops


def read(run):
    return 100.0 * run.window["model_flops"] / run.window["seconds"] / flops.PEAK_BF16_FLOPS
