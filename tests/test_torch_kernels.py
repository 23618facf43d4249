"""K1 and K2, the hand-written CUDA kernels, against their plain torch versions.

The ``cuda`` tests need a card and skip elsewhere. This file imports no JAX,
so on a machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from wsinsight_tpu_torch.ops.fused_preprocess import (  # noqa: E402
    _band,
    _tile_plan,
    fused_preprocess,
    fused_preprocess_reference,
)
from wsinsight_tpu_torch.ops.flash_attn import (  # noqa: E402
    _SMEM_MAX,
    shared_memory_bytes,
    window_attention,
    window_attention_reference,
)
from wsinsight_tpu_torch.models.vit import SAM_VIT_B, SAM_VIT_H, SAM_VIT_L, VIT_256  # noqa: E402
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


@pytest.mark.parametrize("in_size,out_size", [(350, 224), (175, 224), (97, 64)])
def test_bands_cover_pil_weights(in_size, out_size):
    """The kernel's (start, ntaps, weights) bands are PIL's matrix, and each
    tile's staged rows fit the rows the launcher sized shared memory for."""
    start, ntaps, w = _band(in_size, out_size)
    mat = np.zeros((out_size, in_size), np.float32)
    for o in range(out_size):
        mat[o, start[o] : start[o] + ntaps[o]] = w[o, : ntaps[o]]
    np.testing.assert_array_equal(mat, _pil_bilinear_weights(in_size, out_size))
    tile, rows = _tile_plan(in_size, in_size, out_size, out_size)
    for r in range(0, out_size, tile):
        assert (start + ntaps)[r : r + tile].max() - start[r : r + tile].min() <= rows
    assert 16 + rows * 3 * (in_size + out_size) <= 227 * 1024


@pytest.mark.cuda
@pytest.mark.parametrize("in_size,out_size,b", [(350, 224, 8), (175, 224, 8), (97, 64, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version(cuda_device, in_size, out_size, b, dtype):
    """K1 on the card is bit-identical to its plain version (same operations
    in the same order, no FMA contraction)."""
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
# windows) and global blocks, and CellViT-256 (cls + 16x16 tokens as one row).
K2_SHAPES = [
    ("sam_h_windowed", (28, 28), 1280, 16, 14, True),
    ("sam_h_global", (16, 16), 1280, 16, 0, True),
    ("vit_256", (1, 257), 384, 6, 0, False),
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
    1024 px inputs) and ViT-256 encoders make."""
    shapes = []
    for cfg in (SAM_VIT_B, SAM_VIT_L, SAM_VIT_H):
        hd = cfg.embed_dim // cfg.num_heads
        shapes.append((hd, cfg.window_size, cfg.window_size, True))
        shapes += [(hd, g, g, True) for g in (16, 64)]
    shapes.append((VIT_256.embed_dim // VIT_256.num_heads, 1, 257, False))
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
