"""Whole step (``models/vit``, ``models/cellvit``): the frozen FLOP of every
patch of the window's slides over the window's wall time, as a share of the
card's peak in the configuration's precision."""

from portbench.common import window_s
from portbench.roofline.flops import cellvit_sam_flops


def read(run, ctx):
    rate = cellvit_sam_flops(ctx.config["widths"]) * run["patches"] / window_s(run)
    return 100.0 * rate / ctx.peaks[ctx.config["precision"]]
