"""train.mfu_pct: 3x the full-depth forward FLOPs with every exit head, per
document of every step in the window, over the window's seconds and the
bf16 dense peak (recomputation not counted)."""

from h100bench import flops


def read(run):
    return 100.0 * run.window["model_flops"] / run.window["seconds"] / flops.PEAK_BF16_FLOPS
