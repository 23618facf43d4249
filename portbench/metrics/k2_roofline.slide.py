"""ViT attention, K2 (``ops/flash_attn`` -> ``window_attention.cu``): the
frozen bound of its launches over their kernel time in the device trace.
Every forward launches the encoder's windowed blocks and then its global
ones, so the launches count whole forwards."""

from portbench.common import kernel_time
from portbench.roofline.k2 import k2_bound_s, sam_launches


def read(run, ctx):
    if run["trace"] is None:
        return None
    launches, seconds = kernel_time(run["trace"], "window_attention_kernel")
    w = ctx.config["widths"]
    if not launches or launches % w["depth"]:
        return None
    per_forward = sum(n * k2_bound_s(*args, ctx.config["precision"], ctx.peaks)
                      for n, args in sam_launches(ctx.config["batch"], w["patch_size_pixels"],
                                                  w["patch_size"], w["embed_dim"],
                                                  w["num_heads"], w["window_size"],
                                                  len(w["global_attn_indexes"]), w["depth"]))
    return 100.0 * per_forward * (launches // w["depth"]) / seconds
