"""Whole step (``models/resnet``): the frozen FLOP of the ResNet at its
input size for every patch of the window, over the window's wall time, as a
share of the card's peak in the configuration's precision (float32 outside
the tensor cores for parity, whose TF32 is off)."""

from portbench.common import window_s
from portbench.roofline.flops import resnet_flops


def read(run, ctx):
    w = ctx.config["widths"]
    flops = resnet_flops(w["layers"], w["resize"], w["num_classes"])
    return 100.0 * flops * run["patches"] / window_s(run) / ctx.peaks[ctx.config["precision"]]
