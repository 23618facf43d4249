"""K1: fused uint8 -> PIL resize -> normalize, one pass over device memory.

Counterpart of wsinsight_tpu/ops/pallas_preprocess.py. The CUDA kernel is
``csrc/fused_preprocess.cu`` (its header states its bound and design);
``fused_preprocess_reference`` is the plain torch version of the same
contract and the same arithmetic. ``fused_preprocess`` dispatches on where
the batch lies: a CUDA tensor goes to the kernel (or raises), a CPU tensor to
the plain version. Nothing else.

Contract (same as the TPU kernel's): f32-weight resize with PIL's per-pass
uint8 rounding, at most one uint8 level from PIL on rounding ties, then
``x * scale[c] + shift[c]``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .cuda_build import load_library
from .preprocess import _pil_bilinear_weights

_SOURCE = "fused_preprocess.cu"
# Shared memory a CTA may take for its staged input rows + horizontal result.
# Above 48 KB the launcher opts in; H100 allows 227 KB per block, of which
# the kernel's static shared memory takes a few bytes.
_SMEM_BUDGET = 64 * 1024
_SMEM_MAX = 227 * 1024 - 64
_TILE_ROWS = (32, 16, 8, 4, 2, 1)


@functools.lru_cache(maxsize=64)
def _band(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PIL's (out, in) weight matrix as bands: per output, the first input
    index, the tap count and the zero-padded f32 weights (out, max_taps)."""
    mat = _pil_bilinear_weights(in_size, out_size)
    start = np.zeros(out_size, np.int32)
    ntaps = np.zeros(out_size, np.int32)
    for o in range(out_size):
        nz = np.flatnonzero(mat[o])
        if nz.size:
            start[o] = nz[0]
            ntaps[o] = nz[-1] - nz[0] + 1
    w = np.zeros((out_size, max(int(ntaps.max()), 1)), np.float32)
    for o in range(out_size):
        w[o, : ntaps[o]] = mat[o, start[o] : start[o] + ntaps[o]]
    return start, ntaps, w


@functools.lru_cache(maxsize=64)
def _device_band(in_size: int, out_size: int, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in _band(in_size, out_size))


def _band_pass(x: torch.Tensor, band, dim: int) -> torch.Tensor:
    """One separable pass along ``dim``: per output, the taps' products
    summed in tap order (the kernel's order), then PIL's uint8 rounding."""
    start, _, w = band
    shape = [1] * x.dim()
    shape[dim] = -1
    last = x.shape[dim] - 1
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for t in range(w.shape[1]):
        # Padded taps have weight 0 and add an exact 0 to the sum.
        taps = x.index_select(dim, torch.clamp(start + t, max=last))
        acc = acc + w[:, t].reshape(shape) * taps
    return torch.clamp(torch.floor(acc + 0.5), 0.0, 255.0)


def fused_preprocess_reference(
    batch_u8: torch.Tensor,
    out_hw: tuple[int, int],
    scale: np.ndarray,
    shift: np.ndarray,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain torch K1: (B, H, W, 3) uint8 -> (B, oh, ow, 3) ``out_dtype``."""
    _, h, w, _ = batch_u8.shape
    oh, ow = out_hw
    dev = batch_u8.device
    x = batch_u8.to(torch.float32)
    y = _band_pass(x, _device_band(w, ow, dev), 2)
    z = _band_pass(y, _device_band(h, oh, dev), 1)
    scale_t = torch.as_tensor(np.asarray(scale, np.float32), device=dev)
    shift_t = torch.as_tensor(np.asarray(shift, np.float32), device=dev)
    return (z * scale_t + shift_t).to(out_dtype)


@functools.lru_cache(maxsize=64)
def _tile_plan(h: int, w: int, oh: int, ow: int) -> tuple[int, int]:
    """(output rows per CTA, most input rows a CTA stages) for the largest
    tile whose shared memory fits the budget."""
    start, ntaps, _ = _band(h, oh)
    end = start + ntaps
    for tile in _TILE_ROWS:
        rows = max(
            int(end[r : r + tile].max() - start[r : r + tile].min())
            for r in range(0, oh, tile)
        )
        smem = 16 + rows * (w * 3 + ow * 3)
        if smem <= _SMEM_BUDGET or (tile == 1 and smem <= _SMEM_MAX):
            return tile, rows
    raise ValueError(f"fused_preprocess: a {h}x{w} -> {oh}x{ow} resize does not fit shared memory")


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = load_library(_SOURCE)
    fn = lib.wsi_fused_preprocess
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [
        ptr, ptr, i32, i32, i32, i32, i32, i32,  # x, out, bf16, B, H, W, OH, OW
        ptr, ptr, ptr, i32,  # horizontal band
        ptr, ptr, ptr, i32,  # vertical band
        ctypes.POINTER(ctypes.c_float), i32, i32, ptr,  # affine, tile, rows, stream
    ]
    fn.restype = i32
    lib.wsi_cuda_error_string.argtypes = [i32]
    lib.wsi_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_preprocess(
    batch_u8: torch.Tensor,
    out_hw: tuple[int, int],
    scale: np.ndarray,
    shift: np.ndarray,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, oh, ow, 3) ``out_dtype``: resize, then
    ``x * scale + shift``. A CUDA batch runs the kernel; a CPU batch runs
    ``fused_preprocess_reference``. ``fused_preprocess.launches`` counts the
    kernel's launches."""
    if batch_u8.device.type == "cpu":
        return fused_preprocess_reference(batch_u8, out_hw, scale, shift, out_dtype)
    if batch_u8.device.type != "cuda":
        raise ValueError(f"fused_preprocess: unsupported device {batch_u8.device}")
    if batch_u8.dtype != torch.uint8:
        raise TypeError(f"fused_preprocess: expected uint8, got {batch_u8.dtype}")
    if batch_u8.dim() != 4 or batch_u8.shape[-1] != 3:
        raise ValueError(f"fused_preprocess: expected (B, H, W, 3), got {tuple(batch_u8.shape)}")
    if not batch_u8.is_contiguous():
        raise ValueError("fused_preprocess: the batch must be contiguous NHWC")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_preprocess: output dtype {out_dtype} not supported")
    b, h, w, c = batch_u8.shape
    oh, ow = out_hw
    if b > 65535:
        raise ValueError(f"fused_preprocess: batch {b} exceeds the grid's 65535")
    out = torch.empty((b, oh, ow, c), dtype=out_dtype, device=batch_u8.device)
    if b == 0:
        return out
    tile, rows = _tile_plan(h, w, oh, ow)
    hs, hn, hw_ = _device_band(w, ow, batch_u8.device)
    vs, vn, vw = _device_band(h, oh, batch_u8.device)
    affine = (ctypes.c_float * 6)(
        *np.broadcast_to(np.asarray(scale, np.float32), (3,)),
        *np.broadcast_to(np.asarray(shift, np.float32), (3,)),
    )
    lib = _kernel()
    with torch.cuda.device(batch_u8.device):
        err = lib.wsi_fused_preprocess(
            batch_u8.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16),
            b, h, w, oh, ow,
            hs.data_ptr(), hn.data_ptr(), hw_.data_ptr(), hw_.shape[1],
            vs.data_ptr(), vn.data_ptr(), vw.data_ptr(), vw.shape[1],
            affine, tile, rows, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_preprocess launch failed: {lib.wsi_cuda_error_string(err).decode()}"
        )
    fused_preprocess.launches += 1
    return out


fused_preprocess.launches = 0


def make_fused_preprocess_fn(spec, out_dtype: torch.dtype = torch.float32):
    """Build a TransformSpec-compatible preprocess on K1.

    Supports the Resize + ToTensor + Normalize combination (the zoo default);
    returns None for configs the kernel does not cover (Scale, no resize),
    exactly where the JAX package's does.
    """
    if spec.size is None or spec.scale is not None:
        return None
    # Fold ToTensor (1/255) and Normalize into one affine on the 0..255 values.
    if spec.mean is not None:
        mean = np.asarray(spec.mean, np.float32)
        std = np.asarray(spec.std, np.float32)
    else:
        mean = np.zeros(3, np.float32)
        std = np.ones(3, np.float32)
    if spec.to_tensor:
        scale = 1.0 / (255.0 * std)
    else:
        scale = 1.0 / std
    shift = -mean / std
    out_hw = tuple(spec.size)

    def fn(batch_u8: torch.Tensor) -> torch.Tensor:
        return fused_preprocess(batch_u8, out_hw, scale, shift, out_dtype)

    return fn
