"""K1, the fused classifier preprocess (uint8 patch -> PIL bilinear resize
-> normalize, ``ops/csrc/fused_preprocess.cu``): the least time one launch
can take on the card."""

from __future__ import annotations



def pil_taps(in_size: int, out_size: int) -> list[int]:
    """Per output pixel, the taps of PIL's antialiased bilinear filter: the
    span of input pixels with a non-zero triangle weight. PIL centres output
    i at (i + 0.5) * scale, with support max(scale, 1) and the window
    [int(center - support + 0.5), int(center + support + 0.5)) clipped to
    the input."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    taps = []
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - filterscale + 0.5), 0)
        hi = min(int(center + filterscale + 0.5), in_size)
        nz = [x for x in range(lo, hi) if abs((x + 0.5 - center) / filterscale) < 1.0]
        taps.append(nz[-1] - nz[0] + 1 if nz else 0)
    return taps


def k1_counts(b: int, h: int, w: int, oh: int, ow: int, out_bytes: int) -> tuple[float, float]:
    """(FLOP, bytes) of one launch: the uint8 input read once and the output
    written once; 2 FLOP per tap of the horizontal pass (every input row) and
    of the vertical pass (every output column), and 2 per output value for
    the affine normalize."""
    nbytes = b * h * w * 3 + b * oh * ow * 3 * out_bytes
    flops = 2 * b * 3 * (h * sum(pil_taps(w, ow)) + ow * sum(pil_taps(h, oh)))
    flops += 2 * b * oh * ow * 3
    return float(flops), float(nbytes)


def k1_bound_s(b, h, w, oh, ow, out_bytes, peaks) -> float:
    """Least seconds of one launch: its bytes at the HBM rate or its FLOP at
    the float32 rate (K1 computes in float32), whichever is longer."""
    flops, nbytes = k1_counts(b, h, w, oh, ow, out_bytes)
    return max(nbytes / peaks["bytes"], flops / peaks["float32"])

