"""K2, the fused windowed attention with SAM's decomposed rel-pos
(``ops/csrc/window_attention.cu``): the least time one launch can take on
the card, counting the real query rows only (a window's padded rows are
work the kernel may skip)."""

from __future__ import annotations


def k2_counts(b: int, grid: tuple[int, int], dim: int, heads: int, window: int,
              valid: tuple[int, int] | None, rel_pos: bool, elt: int) -> tuple[float, float]:
    """(FLOP, bytes) of one launch over a (b, hp, wp, 3*dim) qkv grid of
    ``elt``-byte values: k and v of every token, q of the real tokens and
    the two expanded rel-pos tables read once, the real rows of the output
    written once; per real query row and head 4*n*hd FLOP for QK^T and PV
    (n keys: the window's, or the whole grid's), plus 2*(ah + aw)*hd for the
    rel-pos terms."""
    hp, wp = grid
    hd = dim // heads
    h, w = valid or grid
    ah, aw = (window, window) if window else (hp, wp)
    nbytes = (b * hp * wp * 2 * dim + 2 * b * h * w * dim) * elt
    if rel_pos:
        nbytes += (ah * ah + aw * aw) * hd * elt
    flops = b * h * w * heads * (4 * ah * aw * hd + (2 * (ah + aw) * hd if rel_pos else 0))
    return float(flops), float(nbytes)


def k2_bound_s(b, grid, dim, heads, window, valid, rel_pos, dtype: str, peaks) -> float:
    """Least seconds of one launch: bytes at the HBM rate or FLOP at the
    tensor cores' rate (bf16; float32 runs three TF32 products each)."""
    elt = 2 if dtype == "bfloat16" else 4
    flops, nbytes = k2_counts(b, grid, dim, heads, window, valid, rel_pos, elt)
    t_ops = flops / peaks["bfloat16"] if dtype == "bfloat16" else 3 * flops / peaks["tf32"]
    return max(nbytes / peaks["bytes"], t_ops)


def sam_launches(b: int, img: int, patch: int, dim: int, heads: int, window: int,
                 global_blocks: int, depth: int) -> list[tuple]:
    """K2's launches of one forward of a SAM encoder over b patches of img
    px: the windowed blocks on the token grid padded to whole windows (their
    real extent as ``valid``) and the global blocks on the grid itself, as
    (count, k2_bound_s arguments without dtype and peaks)."""
    g = img // patch
    gp = -(-g // window) * window
    return [
        (depth - global_blocks, (b, (gp, gp), dim, heads, window, (g, g), True)),
        (global_blocks, (b, (g, g), dim, heads, 0, None, True)),
    ]
