"""K1 and K2, the hand-written CUDA kernels, against their plain torch versions.

The ``cuda`` tests need a card and skip elsewhere. This file imports no JAX,
so on a machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from wsinsight_tpu_torch.ops.fused_preprocess import (  # noqa: E402
    _SMEM_MAX as K1_SMEM_MAX,
    _BAND_ROWS,
    _TAPS,
    _WEIGHT_SUM_MAX,
    _band,
    _band_pass,
    _columns,
    _plan,
    _schedule,
    _smem,
    fused_preprocess,
    fused_preprocess_reference,
)
from wsinsight_tpu_torch.ops.flash_attn import (  # noqa: E402
    _SMEM_MAX,
    shared_memory_bytes,
    window_attention,
    window_attention_reference,
)
from wsinsight_tpu_torch.models.vit import (  # noqa: E402
    HOPTIMUS_VIT_G, SAM_VIT_B, SAM_VIT_H, SAM_VIT_L, VIRCHOW_VIT_H, VIT_256,
)
from wsinsight_tpu_torch.ops.preprocess import _pil_bilinear_weights  # noqa: E402

MEAN = (0.7238, 0.5716, 0.6779)  # breast-tumor-resnet34.tcga-brca
STD = (0.112, 0.1459, 0.1036)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _batch(b, h, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(b, h, h, 3), dtype=np.uint8)


# K1's resizes: the zoo's (350 -> 224, 350 -> 299, 175 -> 224, and the
# identities 224, 100, 96), the fast input's 176 -> 224 (a DCT half-decoded
# 350 px patch, rounded even), an odd downscale, and bands of 10 and 8 taps.
K1_SHAPES = [(350, 224), (350, 299), (175, 224), (176, 224), (224, 224), (100, 100), (96, 96),
             (97, 64), (1024, 224), (350, 96)]


def _bands(plan, oh):
    """The kernel's CTAs along the rows: ceil(oh / band_rows) of them, CTA i
    writing rows [i * band_rows, min((i + 1) * band_rows, oh))."""
    r = plan.band_rows
    return [(i * r, min((i + 1) * r, oh)) for i in range(-(-oh // r))]


def _vertical(h, oh):
    start, ntaps, _ = _band(h, oh)
    return start, start + np.maximum(ntaps, 1)


@pytest.mark.parametrize("in_size,out_size", [(350, 224), (175, 224), (97, 64)])
def test_bands_cover_pil_weights(in_size, out_size):
    """The kernel's (start, ntaps, weights) bands are PIL's matrix, and each
    CTA's band of output rows stages the input rows its taps need."""
    start, ntaps, w = _band(in_size, out_size)
    mat = np.zeros((out_size, in_size), np.float32)
    for o in range(out_size):
        mat[o, start[o] : start[o] + ntaps[o]] = w[o, : ntaps[o]]
    np.testing.assert_array_equal(mat, _pil_bilinear_weights(in_size, out_size))
    plan = _plan(in_size, in_size, out_size, out_size)
    end = start + ntaps
    for r0, r1 in _bands(plan, out_size):
        assert start[r0] == start[r0:r1].min() and end[r1 - 1] == end[r0:r1].max()
    assert plan.smem <= 227 * 1024


@pytest.mark.parametrize("h,oh", K1_SHAPES)
def test_plan_bands_partition_output_rows(h, oh):
    """Every output row belongs to exactly one CTA's band, and no band is
    empty; bands are evened out (none longer than _BAND_ROWS, the last at
    least as long as the others less one per band); the CTA is the output
    width rounded up to a warp."""
    plan = _plan(h, h, oh, oh)
    bands = _bands(plan, oh)
    rows = np.concatenate([np.arange(r0, r1) for r0, r1 in bands])
    np.testing.assert_array_equal(rows, np.arange(oh))
    sizes = [r1 - r0 for r0, r1 in bands]
    assert min(sizes) > 0 and max(sizes) == plan.band_rows <= _BAND_ROWS
    assert sizes[-1] > plan.band_rows - len(bands)
    assert plan.threads == min(-(-oh // 32) * 32, 1024)


@pytest.mark.parametrize("h,oh", K1_SHAPES)
def test_plan_staged_rows_cover_taps(h, oh):
    """A band stages input rows [start of its first row, end of its last):
    every tap of its rows lies in what was staged (the kernel skips padded
    vertical taps; clamped to the row's last real one they would too), a
    padded horizontal tap reads the last column, as the plain version clamps
    it, and the chunks stage each of those rows once."""
    plan = _plan(h, h, oh, oh)
    start, end = _vertical(h, oh)
    taps = plan.taps or _band(h, oh)[2].shape[1]
    for r0, r1 in _bands(plan, oh):
        lo, hi = start[r0], end[r1 - 1]
        rows = np.minimum(start[r0:r1, None] + np.arange(taps), end[r0:r1, None] - 1)
        assert rows.min() >= lo and rows.max() < hi <= h
        steps = _schedule(start, end, r0, r1, plan.chunk_rows)
        staged = np.concatenate([np.arange(first, prod) for first, prod, _, _ in steps])
        np.testing.assert_array_equal(staged, np.arange(lo, hi))
    hstart = _band(h, oh)[0]
    cols = np.minimum(hstart[:, None] + np.arange(plan.taps or 1), h - 1)
    assert cols.min() >= 0 and cols.max() < h


@pytest.mark.parametrize("h,oh", K1_SHAPES)
def test_plan_ring_holds_vertical_taps(h, oh):
    """Walk each band as the kernel does: write each chunk's horizontal rows
    into ring slot row % ring_rows, then read every tap of the output rows
    written after that chunk. Each tap finds its own row in its slot, and
    each output row is written once."""
    plan = _plan(h, h, oh, oh)
    start, end = _vertical(h, oh)
    taps = plan.taps or _band(h, oh)[2].shape[1]
    assert plan.ring_rows & (plan.ring_rows - 1) == 0
    for r0, r1 in _bands(plan, oh):
        ring = np.full(plan.ring_rows, -1)
        written = []
        for first, prod, e0, e1 in _schedule(start, end, r0, r1, plan.chunk_rows):
            for row in range(first, prod):
                ring[row % plan.ring_rows] = row
            for r in range(e0, e1):
                rows = np.minimum(start[r] + np.arange(taps), end[r] - 1)
                np.testing.assert_array_equal(ring[rows % plan.ring_rows], rows)
                assert end[r] <= prod
            written += range(e0, e1)
        assert written == list(range(r0, r1))


@pytest.mark.parametrize("h,oh", K1_SHAPES)
def test_plan_shared_memory_fits(h, oh):
    """Two staged chunks, the ring and the vertical table fit a CTA's share
    of the SM; the zoo's resizes stay under 48 KB (no opt-in)."""
    plan = _plan(h, h, oh, oh)
    taps = plan.taps or _band(h, oh)[2].shape[1]
    assert plan.smem == _smem(h, oh, plan.band_rows, plan.chunk_rows, plan.ring_rows, taps)
    assert plan.smem <= K1_SMEM_MAX
    if h <= 350:
        assert plan.smem <= 48 * 1024
    assert plan.taps == next(t for t in (*_TAPS, 0) if t >= _band(h, oh)[2].shape[1] or t == 0)


@pytest.mark.parametrize("h,oh", K1_SHAPES)
def test_column_order_groups_tap_counts(h, oh):
    """The horizontal pass's threads take every output column once, by tap
    count (most first, stably), so a warp runs as many taps as its columns
    need: at 350 -> 224 one warp of seven runs 4 taps and six run 3."""
    cols = _columns(h, oh)
    np.testing.assert_array_equal(np.sort(cols), np.arange(oh))
    ntaps = _band(h, oh)[1][cols]
    assert (np.diff(ntaps) <= 0).all()
    warps = [int(ntaps[k : k + 32].max()) for k in range(0, oh, 32)]
    if (h, oh) == (350, 224):
        assert warps == [4, 3, 3, 3, 3, 3, 3]


def _copy_blocks(a, n, lo, hi):
    """fused_preprocess.cu's ``stage``: the 16-byte blocks covering bytes
    [a, a + n), and which of them go by cp.async (those inside [lo, hi))."""
    g0 = a // 16 * 16
    blocks = g0 + 16 * np.arange((a + n - g0 + 15) // 16)
    return blocks, (blocks >= lo) & (blocks + 16 <= hi)


@pytest.mark.parametrize("h,oh", K1_SHAPES)
def test_plan_copy_blocks_inside_image(h, oh):
    """Every 16-byte cp.async block lies inside its image's bytes, at any
    start address of the batch (x[1:] of a batch starts 350*350*3 bytes on,
    which is not 16-aligned); the blocks that do not (copied byte by byte,
    only the span's own bytes) are the span's first or last and touch the
    image's edge; the blocks fit the chunk's slot in shared memory."""
    plan = _plan(h, h, oh, oh)
    start, end = _vertical(h, oh)
    row_bytes, img_bytes = h * 3, h * h * 3
    slot = (plan.chunk_rows * row_bytes + 15) // 16 * 16 + 32
    for base in (4096, 4096 + img_bytes, 4097, 4111):
        for b in range(3):
            lo = base + b * img_bytes
            hi = lo + img_bytes
            for r0, r1 in _bands(plan, oh):
                for first, prod, _, _ in _schedule(start, end, r0, r1, plan.chunk_rows):
                    a, n = lo + first * row_bytes, (prod - first) * row_bytes
                    assert lo <= a and a + n <= hi
                    blocks, cp = _copy_blocks(a, n, lo, hi)
                    assert len(blocks) * 16 <= slot
                    assert blocks[0] <= a and blocks[-1] + 16 >= a + n
                    assert (blocks[cp] >= lo).all() and (blocks[cp] + 16 <= hi).all()
                    for i in np.flatnonzero(~cp):
                        assert i in (0, len(blocks) - 1)
                        assert blocks[i] < lo or blocks[i] + 16 > hi


@pytest.mark.parametrize("h,oh", K1_SHAPES)
def test_band_weights_keep_each_pass_in_range(h, oh):
    """The kernel leaves out the contract's clip to [0, 255]: with weights
    >= 0 summing to <= _WEIGHT_SUM_MAX, a pass over uint8 values gives
    0 <= y < 255.5, so floor(y + 0.5) is already in range. The plain pass on
    all-255 and all-0 rows gives exactly 255 and 0."""
    _, _, w = _band(h, oh)
    assert (w >= 0).all() and w.sum(axis=1, dtype=np.float64).max() <= _WEIGHT_SUM_MAX
    assert 255 * _WEIGHT_SUM_MAX + 1e-3 < 255.5
    x = torch.full((1, h, h, 3), 255.0)
    x[..., 1] = 0.0
    band = tuple(torch.from_numpy(a) for a in _band(h, oh))
    for dim in (1, 2):
        y = _band_pass(x, band, dim)
        assert (y[..., 0] == 255).all() and (y[..., 1] == 0).all()


@pytest.mark.parametrize("h,oh", K1_SHAPES)
def test_padded_taps_add_exact_zero(h, oh):
    """The plain pass with each band padded by zero weights to every tap
    template the kernel has (at least its own count) is bit-identical to the
    unpadded pass, in both directions."""
    rng = np.random.default_rng(h + oh)
    x = torch.from_numpy(rng.integers(0, 256, (1, h, h, 3)).astype(np.float32))
    start, ntaps, w = (torch.from_numpy(a) for a in _band(h, oh))
    for dim in (1, 2):
        want = _band_pass(x, (start, ntaps, w), dim)
        for taps in (t for t in _TAPS if t >= w.shape[1]):
            padded = torch.zeros((oh, taps), dtype=torch.float32)
            padded[:, : w.shape[1]] = w
            got = _band_pass(x, (start, ntaps, padded), dim)
            assert torch.equal(got, want), (dim, taps)


@pytest.mark.cuda
@pytest.mark.parametrize("in_size,out_size", [(350, 224), (175, 224), (176, 224), (350, 299),
                                              (224, 224), (96, 96), (97, 64), (1024, 224),
                                              (1024, 40)])
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version(cuda_device, in_size, out_size, b, dtype):
    """K1 on the card is bit-identical to its plain version (same operations
    in the same order, no FMA contraction), at every tap template: 1, 2, 4,
    16 and, at 1024 -> 40 (26 taps), the run-time count."""
    dt = getattr(torch, dtype)
    x = torch.from_numpy(_batch(b, in_size)).to(cuda_device)
    scale = 1.0 / (255.0 * np.asarray(STD, np.float32))
    shift = -np.asarray(MEAN, np.float32) / np.asarray(STD, np.float32)
    before = fused_preprocess.launches
    got = fused_preprocess(x, (out_size, out_size), scale, shift, dt)
    torch.cuda.synchronize()
    assert fused_preprocess.launches == before + 1
    want = fused_preprocess_reference(x, (out_size, out_size), scale, shift, dt)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("in_size,out_size", [(350, 224), (350, 299)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_unaligned_batch(cuda_device, in_size, out_size, dtype):
    """x[1:] of a contiguous batch is contiguous, but its first image starts
    350*350*3 bytes on, not on a 16-byte boundary: still bit-identical."""
    dt = getattr(torch, dtype)
    x = torch.from_numpy(_batch(4, in_size)).to(cuda_device)[1:]
    assert x.is_contiguous() and x.data_ptr() % 16
    one, zero = np.full(3, 1 / 255, np.float32), np.zeros(3, np.float32)
    got = fused_preprocess(x, (out_size, out_size), one, zero, dt)
    want = fused_preprocess_reference(x, (out_size, out_size), one, zero, dt)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("in_size,out_size", [(350, 224), (175, 224), (350, 299), (97, 64)])
def test_kernel_saturated_images(cuda_device, in_size, out_size):
    """Images of 0 and 255 with sharp edges, where a pass's sum comes
    closest to the ends of [0, 255]: still bit-identical."""
    x = np.zeros((3, in_size, in_size, 3), np.uint8)
    x[:, ::2] = 255
    x[:, :, ::3] = 255
    x[0] = 255
    x = torch.from_numpy(x).to(cuda_device)
    scale = 1.0 / (255.0 * np.asarray(STD, np.float32))
    shift = -np.asarray(MEAN, np.float32) / np.asarray(STD, np.float32)
    for dt in (torch.float32, torch.bfloat16):
        got = fused_preprocess(x, (out_size, out_size), scale, shift, dt)
        want = fused_preprocess_reference(x, (out_size, out_size), scale, shift, dt)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_rejects_bad_input(cuda_device):
    x = torch.zeros((2, 96, 96, 3), dtype=torch.uint8, device=cuda_device)
    one, zero = np.ones(3, np.float32), np.zeros(3, np.float32)
    with pytest.raises(TypeError):
        fused_preprocess(x.float(), (64, 64), one, zero)
    with pytest.raises(ValueError):
        fused_preprocess(x[:, :, ::2], (64, 64), one, zero)
    with pytest.raises(ValueError):
        fused_preprocess(x[..., :2].contiguous(), (64, 64), one, zero)


# K2 at the main path's shapes, small B: (name, grid HP x WP, dim, heads,
# window, with rel-pos). CellViT-SAM-H windowed (16x16 padded to 28x28, 14x14
# windows) and global blocks, CellViT-256 (cls + 16x16 tokens as one row),
# CellViT-Virchow at 256 px (cls + 18x18 tokens, hd 80) and H-Optimus-0 at
# 224 px (cls + 4 registers + 16x16 tokens, hd 64).
K2_SHAPES = [
    ("sam_h_windowed", (28, 28), 1280, 16, 14, True),
    ("sam_h_global", (16, 16), 1280, 16, 0, True),
    ("vit_256", (1, 257), 384, 6, 0, False),
    ("virchow", (1, 325), 1280, 16, 0, False),
    ("hoptimus", (1, 261), 1536, 24, 0, False),
]
# f32: the same sums in another order. bf16: JAX's bar for its bf16 kernel
# (tests/test_flash_attn.py, 5e-2): the rel values are rounded to bf16 after
# sums in another order, so a pair can land one bf16 ulp apart (2**-5 at
# |rel| >= 4 with these tables), which moves a score by as much; the output
# is bf16 (one ulp is 2**-7 relative) and K2 rounds P before normalising it.
K2_TOL = {"float32": (2e-5, 1e-5), "bfloat16": (5e-2, 5e-2)}


def _k2_inputs(shape, dim, heads, window, rel, dtype, device, b=2, seed=0):
    """Seeded qkv and expanded rel-pos tables, as the model hands them over."""
    rng = np.random.default_rng(seed)
    (hp, wp), hd = shape, dim // heads
    qkv = torch.from_numpy(rng.standard_normal((b, hp, wp, 3 * dim), dtype=np.float32))
    qkv = qkv.to(device=device, dtype=dtype)
    if not rel:
        return qkv, None, None
    tables = []
    for a in (window or hp, window or wp):
        table = rng.standard_normal((2 * a - 1, hd), dtype=np.float32) * 0.5
        idx = np.add.outer(np.arange(a), -np.arange(a)) + a - 1
        tables.append(torch.from_numpy(table[idx]).to(device=device, dtype=dtype))
    return qkv, tables[0], tables[1]


def _check_k2(qkv, heads, window, rh, rw, valid=None):
    """One launch of K2 against its plain version at K2_TOL, on the real
    rows of ``valid`` (every row without it)."""
    dim = qkv.shape[-1] // 3
    scale = (dim // heads) ** -0.5
    before = window_attention.launches
    got = window_attention(qkv, heads, window, scale, rh, rw, valid)
    torch.cuda.synchronize()
    assert window_attention.launches == before + 1
    want = window_attention_reference(qkv, heads, window, scale, rh, rw, valid)
    assert got.shape == (*qkv.shape[:3], dim) and got.dtype == qkv.dtype
    h, w = valid or qkv.shape[1:3]
    atol, rtol = K2_TOL[str(qkv.dtype)[6:]]
    torch.testing.assert_close(got[:, :h, :w].float(), want[:, :h, :w].float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,dim,heads,window,rel", K2_SHAPES, ids=[s[0] for s in K2_SHAPES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_attention_matches_plain_version(cuda_device, name, shape, dim, heads, window,
                                                rel, dtype):
    qkv, rh, rw = _k2_inputs(shape, dim, heads, window, rel, getattr(torch, dtype), cuda_device)
    _check_k2(qkv, heads, window, rh, rw)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 80, 128])
@pytest.mark.parametrize("rel", [True, False], ids=["rel", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_attention_each_instantiation(cuda_device, hd, rel, dtype):
    """Every (head dim, rel-pos) instantiation of both kernels, on SAM-H's
    windowed grid with 4 heads."""
    qkv, rh, rw = _k2_inputs((28, 28), 4 * hd, 4, 14, rel, getattr(torch, dtype), cuda_device)
    _check_k2(qkv, 4, 14, rh, rw)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 80, 128])
@pytest.mark.parametrize("rel", [True, False], ids=["rel", "plain"])
def test_window_attention_real_rows_each_instantiation(cuda_device, hd, rel):
    """The f32 kernel with SAM-H's valid=(16, 16) on its 28x28 grid: windows
    of 196, 28, 28 and 4 real rows, every other row unwritten."""
    qkv, rh, rw = _k2_inputs((28, 28), 4 * hd, 4, 14, rel, torch.float32, cuda_device)
    _check_k2(qkv, 4, 14, rh, rw, valid=(16, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_attention_real_rows_main_shape(cuda_device, dtype):
    """SAM-H's windowed launch as the model makes it (16 heads of 80,
    valid=(16, 16)): the f32 kernel computes the real rows only, the bf16
    one every row; both hold on the real rows."""
    qkv, rh, rw = _k2_inputs((28, 28), 1280, 16, 14, True, getattr(torch, dtype), cuda_device)
    _check_k2(qkv, 16, 14, rh, rw, valid=(16, 16))


# Shapes beyond the main path's: ragged n (a 7-window, n=49) and a long
# global row (SAM-B at 1024 px: 64x64 tokens, n=4096, 64 key tiles of online
# softmax) at B=1, in both dtypes; and, for the bf16 kernel, qkv scaled by 8
# so the running max moves a lot (scores 64x larger; the rel-pos tables
# scaled by 1/8, so the rel values keep the magnitude, and the one-ulp
# argument, of K2_TOL). f32's bar is for unit-scale scores: two f32 sums in
# another order differ by about |S| * 2**-24, which exp carries into the
# output, so at |S| ~ 64 they differ by more than 2e-5 whoever is right.
K2_EDGES = [
    ("window_7", (14, 14), 384, 6, 7, True, 1.0, 2, "float32"),
    ("window_7", (14, 14), 384, 6, 7, True, 1.0, 2, "bfloat16"),
    ("sam_b_1024_global", (64, 64), 768, 12, 0, True, 1.0, 1, "float32"),
    ("sam_b_1024_global", (64, 64), 768, 12, 0, True, 1.0, 1, "bfloat16"),
    ("sam_h_windowed_x8", (28, 28), 1280, 16, 14, True, 8.0, 2, "bfloat16"),
    ("vit_256_x8", (1, 257), 384, 6, 0, False, 8.0, 2, "bfloat16"),
]
# Real rows with ragged key tiles (n=49: windows of 49, 28, 21 and 12 real
# rows) and with whole windows past the real extent (no real rows).
K2_VALID_EDGES = [
    ("window_7_valid", (14, 14), 384, 6, 7, True, (10, 11)),
    ("empty_windows", (28, 28), 1280, 16, 14, True, (10, 12)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,dim,heads,window,rel,mult,b,dtype", K2_EDGES,
                         ids=[f"{s[-1]}-{s[0]}" for s in K2_EDGES])
def test_window_attention_edges(cuda_device, name, shape, dim, heads, window, rel, mult, b,
                                dtype):
    qkv, rh, rw = _k2_inputs(shape, dim, heads, window, rel, getattr(torch, dtype), cuda_device,
                             b=b)
    if mult != 1.0:
        qkv = (qkv.float() * mult).to(qkv.dtype)
        if rel:
            rh, rw = ((t.float() / mult).to(t.dtype) for t in (rh, rw))
    _check_k2(qkv, heads, window, rh, rw)


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,dim,heads,window,rel,valid", K2_VALID_EDGES,
                         ids=[s[0] for s in K2_VALID_EDGES])
def test_window_attention_real_rows_edges(cuda_device, name, shape, dim, heads, window, rel,
                                          valid):
    qkv, rh, rw = _k2_inputs(shape, dim, heads, window, rel, torch.float32, cuda_device)
    _check_k2(qkv, heads, window, rh, rw, valid)


def _zoo_k2_shapes():
    """(hd, ah, aw, rel) of every K2 launch the zoo's SAM-B/L/H (256 and
    1024 px inputs), ViT-256 and Virchow (256 px) encoders and H-Optimus-0
    (224 px) make."""
    shapes = []
    for cfg in (SAM_VIT_B, SAM_VIT_L, SAM_VIT_H):
        hd = cfg.embed_dim // cfg.num_heads
        shapes.append((hd, cfg.window_size, cfg.window_size, True))
        shapes += [(hd, g, g, True) for g in (16, 64)]
    shapes.append((VIT_256.embed_dim // VIT_256.num_heads, 1, 257, False))
    for cfg, side in ((VIRCHOW_VIT_H, 256), (HOPTIMUS_VIT_G, 224)):
        n = 1 + cfg.reg_tokens + (side // cfg.patch_size) ** 2
        shapes.append((cfg.embed_dim // cfg.num_heads, 1, n, False))
    return shapes


@pytest.mark.parametrize("hd,ah,aw,rel", _zoo_k2_shapes())
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_memory_fits(hd, ah, aw, rel, dtype):
    """K2's dynamic shared memory is the documented formula and fits a
    Hopper CTA's 227 KB at every shape the zoo gives it."""
    dt = getattr(torch, dtype)
    stride = -(-(ah + aw - 8) // 32) * 32 + 8  # rel rows of 8 mod 32
    if dt == torch.bfloat16:  # 2 stages of 64 K and V rows of hd + 8 (q in one); 128 rows
        row, rows, tiles = (hd + 8) * 2, 128, 2 * 2 * 64 * (hd + 8) * 2
    else:  # 2 stages of 32 K and V rows of hd + 4, and 64 q rows; 64 rows
        row, rows, tiles = (hd + 4) * 4, 64, (2 * 2 * 32 + 64) * (hd + 4) * 4
    assert stride >= ah + aw and row % 16 == 0
    assert shared_memory_bytes(hd, ah, aw, rel, dt) == tiles + (rows * stride * 4 if rel else 0)
    assert shared_memory_bytes(hd, ah, aw, rel, dt) <= _SMEM_MAX == 227 * 1024


@pytest.mark.cuda
def test_window_attention_rejects_bad_input(cuda_device):
    qkv, rh, rw = _k2_inputs((28, 28), 1280, 16, 14, True, torch.float32, cuda_device, b=1)
    before = window_attention.launches
    with pytest.raises(TypeError):
        window_attention(qkv.half(), 16, 14, 0.1, rh.half(), rw.half())
    with pytest.raises(ValueError):  # not contiguous
        window_attention(qkv.transpose(1, 2), 16, 14, 0.1, rh, rw)
    with pytest.raises(ValueError):  # 28 is not a multiple of 13
        window_attention(qkv, 16, 13, 0.1)
    with pytest.raises(ValueError):  # rel-pos table of another dtype
        window_attention(qkv, 16, 14, 0.1, rh.bfloat16(), rw.bfloat16())
    with pytest.raises(ValueError):  # real extent past the grid
        window_attention(qkv, 16, 14, 0.1, rh, rw, valid=(16, 29))
    assert window_attention.launches == before


# ---------------------------------------------------------------------------
# K1 and K2 per replica: engines over a device list naming the card twice
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_k1_per_replica_on_a_device_list(cuda_device, tmp_path):
    """A bf16 ClassifierEngine on ["cuda:0", "cuda:0"]: one K1 launch per
    replica, and each replica's rows bit for bit one replica's run of the
    same block."""
    from wsinsight_tpu_torch.engine import ClassifierEngine
    from wsinsight_tpu_torch.zoo import load_local_model, make_random_local_model

    handle = load_local_model(*make_random_local_model("resnet34", 2, tmp_path, seed=1,
                                                       patch_size_pixels=350))
    x = _batch(16, 350, seed=4)
    two = ClassifierEngine(handle, mixed_precision=True, devices=["cuda:0", "cuda:0"])
    one = ClassifierEngine(handle, mixed_precision=True, device=cuda_device)
    assert two.n_devices == 2 and two.device == cuda_device
    before = fused_preprocess.launches
    got = two.run_batch(x, 15)
    assert fused_preprocess.launches - before == 2
    want = np.concatenate([one.run_batch(x[:8], 8), one.run_batch(x[8:], 8)])[:15]
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_k2_per_replica_on_a_device_list(cuda_device, tmp_path):
    """A CellViT-256 CellEngine on ["cuda:0", "cuda:0"]: twice one replica's
    K2 launches per batch, the maps within 1e-4 of one replica's, gathered
    on the first device."""
    from wsinsight_tpu_torch.engine import CellEngine
    from wsinsight_tpu_torch.zoo import load_local_model, make_random_local_model

    handle = load_local_model(*make_random_local_model("cellvit-256", 6, tmp_path, seed=2,
                                                       patch_size_pixels=128))
    x = _batch(4, 128, seed=5)
    one = CellEngine(handle, device=cuda_device)
    two = CellEngine(handle, devices=["cuda:0", "cuda:0"])
    before = window_attention.launches
    want = one.run_batch(x)
    per_batch = window_attention.launches - before
    got = two.run_batch(x)
    assert per_batch > 0 and window_attention.launches - before == 3 * per_batch
    for key, value in got.items():
        assert value.device == cuda_device, key
        torch.testing.assert_close(value, want[key], rtol=0, atol=1e-4, msg=key)
