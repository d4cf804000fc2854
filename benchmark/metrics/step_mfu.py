"""% of the card's dense bf16 peak that the window's frames/s reach, with
the forward's operations per frame counted from the model's convolutions
(:mod:`benchmark.flops`)."""

from benchmark.peaks import PEAK_OPS


def read(ctx):
    return 100.0 * ctx.flops_per_frame * ctx.window["frames_per_s"] / PEAK_OPS["bf16"]
