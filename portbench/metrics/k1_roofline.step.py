"""Classifier preprocess, K1 (``ops/fused_preprocess`` ->
``fused_preprocess.cu``): the frozen bound of its launches (one per batch
of uint8 patches resized to the model's input) over their kernel time in
the device trace. Parity runs no K1: nothing to read there."""

from portbench.common import kernel_time
from portbench.roofline.k1 import k1_bound_s


def read(run, ctx):
    if run["trace"] is None:
        return None
    launches, seconds = kernel_time(run["trace"], "fused_preprocess_kernel")
    if not launches:
        return None
    w = ctx.config["widths"]
    out_bytes = 2 if ctx.config["precision"] == "bfloat16" else 4
    px, size = w["patch_size_pixels"], w["resize"]
    bound = k1_bound_s(ctx.config["batch"], px, px, size, size, out_bytes, ctx.peaks)
    return 100.0 * bound * launches / seconds
