"""% of its roofline (``benchmark/rooflines/maskstats_soft.py``) that the kernel's
traced device time per launch reaches."""

from benchmark.metrics import roofline_share


def read(ctx):
    return roofline_share(ctx, "maskstats_soft")
