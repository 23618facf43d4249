"""K1, the hand-written CUDA kernel, against its plain torch version.

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
