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
    window_attention,
    window_attention_reference,
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


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,dim,heads,window,rel", K2_SHAPES, ids=[s[0] for s in K2_SHAPES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_attention_matches_plain_version(cuda_device, name, shape, dim, heads, window,
                                                rel, dtype):
    qkv, rh, rw = _k2_inputs(shape, dim, heads, window, rel, getattr(torch, dtype), cuda_device)
    scale = (dim // heads) ** -0.5
    before = window_attention.launches
    got = window_attention(qkv, heads, window, scale, rh, rw)
    torch.cuda.synchronize()
    assert window_attention.launches == before + 1
    want = window_attention_reference(qkv, heads, window, scale, rh, rw)
    assert got.shape == (qkv.shape[0], *shape, dim) and got.dtype == qkv.dtype
    atol, rtol = K2_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


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
    assert window_attention.launches == before
