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
from typing import NamedTuple

import numpy as np
import torch

from .cuda_build import load_library
from .preprocess import _pil_bilinear_weights

_SOURCE = "fused_preprocess.cu"
# The kernel's tap counts: a band of up to 16 taps is padded to the next of
# these (zero weights add an exact +0) and unrolled from registers; 0 is the
# run-time-tap instantiation for wider bands or outputs wider than 1024.
_TAPS = (1, 2, 4, 8, 16)
_BAND_ROWS = 32  # output rows a CTA walks down (bands are evened out)
_CHUNK_ROWS = 8  # input rows per staged chunk (two in flight)
# PIL's triangle weights are >= 0 and sum to 1 (to f32 rounding), so after a
# pass y <= 255 * _WEIGHT_SUM_MAX < 255.5 and the clip to [0, 255] never acts.
_WEIGHT_SUM_MAX = 1.001
# H100: 227 KB of shared memory per block, less the kernel's static 96 bytes.
_SMEM_MAX = 227 * 1024 - 96


class Plan(NamedTuple):
    """K1's launch plan (see csrc/fused_preprocess.cu)."""

    taps: int  # tap template: 1, 2, 4, 8, 16, or 0 (run-time count)
    threads: int  # per CTA: the output width rounded up to a warp
    band_rows: int  # output rows per CTA
    chunk_rows: int  # input rows per staged chunk
    ring_rows: int  # horizontal-pass rows kept in shared memory
    smem: int  # dynamic shared memory per CTA, bytes


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


def _columns(in_size: int, out_size: int) -> np.ndarray:
    """The output columns in the order K1's threads take them: by tap count,
    most first, stably, so that most warps hold columns of one count."""
    return np.argsort(-_band(in_size, out_size)[1], kind="stable").astype(np.int32)


@functools.lru_cache(maxsize=64)
def _device_columns(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_columns(in_size, out_size)).to(device)


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


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def _smem(w: int, ow: int, band_rows: int, chunk_rows: int, ring_rows: int, vtaps: int) -> int:
    """The kernel's dynamic shared memory (``smem_bytes`` in the .cu): two
    input chunks, the ring of horizontal rows, the vertical table."""
    slot = _align16(chunk_rows * w * 3) + 32
    return 2 * slot + ring_rows * _align16(ow * 3) + band_rows * (2 + vtaps) * 4


def _schedule(start: np.ndarray, end: np.ndarray, r0: int, r1: int, chunk_rows: int):
    """The kernel's walk down band [r0, r1): per staged chunk, (its input
    rows [first, prod), the band's output rows [e0, e1) written after it).
    ``start``/``end`` are the vertical taps' first and one-past-last rows."""
    lo, hi = int(start[r0]), int(end[r1 - 1])
    steps, e = [], r0
    for first in range(lo, hi, chunk_rows):
        prod = min(first + chunk_rows, hi)
        e1 = e
        while e1 < r1 and end[e1] <= prod:
            e1 += 1
        steps.append((first, prod, e, e1))
        e = e1
    return steps


@functools.lru_cache(maxsize=64)
def _plan(
    h: int, w: int, oh: int, ow: int, band_rows: int = _BAND_ROWS, chunk_rows: int = _CHUNK_ROWS
) -> Plan:
    """K1's launch plan: bands of output rows, staged chunks, and the ring of
    horizontal rows sized so that every vertical tap is still in it when its
    output row is written. The largest chunk up to ``chunk_rows`` that fits
    shared memory."""
    hmax, vmax = _band(w, ow)[2].shape[1], _band(h, oh)[2].shape[1]
    start, ntaps, _ = _band(h, oh)
    end = start + np.maximum(ntaps, 1)
    if (np.diff(start) < 0).any() or (np.diff(end) < 0).any():
        raise ValueError(f"fused_preprocess: {h} -> {oh} gives a non-monotonic band")
    for _, _, wts in (_band(w, ow), _band(h, oh)):
        # The kernel leaves out the clip to [0, 255]: it cannot act on such weights.
        if (wts < 0).any() or wts.sum(axis=1, dtype=np.float64).max() > _WEIGHT_SUM_MAX:
            raise ValueError("fused_preprocess: band weights must be >= 0 and sum to <= 1.001")
    taps = next((t for t in _TAPS if t >= max(hmax, vmax)), 0) if ow <= 1024 else 0
    threads = min((ow + 31) // 32 * 32, 1024)
    n_bands = -(-oh // band_rows)
    band_rows = -(-oh // n_bands)
    for chunk in range(chunk_rows, 0, -1):
        need = 1
        for r0 in range(0, oh, band_rows):
            for _, prod, e0, e1 in _schedule(start, end, r0, min(r0 + band_rows, oh), chunk):
                if e1 > e0:
                    need = max(need, prod - int(start[e0:e1].min()))
        ring = 1 << (need - 1).bit_length()
        smem = _smem(w, ow, band_rows, chunk, ring, taps or vmax)
        if smem <= _SMEM_MAX:
            return Plan(taps, threads, band_rows, chunk, ring, smem)
    raise ValueError(f"fused_preprocess: a {h}x{w} -> {oh}x{ow} resize does not fit shared memory")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a loaded build of ``_SOURCE``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wsi_fused_preprocess_bands.argtypes = [
        ptr, ptr, i32, i32, i32, i32, i32, i32,  # x, out, bf16, B, H, W, OH, OW
        ptr, ptr, ptr, i32,  # horizontal band: start, column order, weights, max taps
        ptr, ptr, ptr, i32,  # vertical band: start, taps, weights, max taps
        ctypes.POINTER(ctypes.c_float),  # affine
        i32, i32, i32, i32, i32, ptr,  # taps, threads, band, chunk, ring rows, stream
    ]
    lib.wsi_fused_preprocess_bands.restype = i32
    lib.wsi_cuda_error_string.argtypes = [i32]
    lib.wsi_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _kernel():
    return bind(load_library(_SOURCE))


def _affine(scale, shift):
    return (ctypes.c_float * 6)(
        *np.broadcast_to(np.asarray(scale, np.float32), (3,)),
        *np.broadcast_to(np.asarray(shift, np.float32), (3,)),
    )


def launch(lib, batch_u8, out, scale, shift, plan: Plan) -> None:
    """One launch of ``lib``'s ``wsi_fused_preprocess_bands`` (``bind``
    declared it) with ``plan`` on inputs that ``fused_preprocess`` has
    checked. Counts nothing."""
    b, h, w, _ = batch_u8.shape
    _, oh, ow, _ = out.shape
    hs, _, hw_ = _device_band(w, ow, batch_u8.device)
    cols = _device_columns(w, ow, batch_u8.device)
    vs, vn, vw = _device_band(h, oh, batch_u8.device)
    with torch.cuda.device(batch_u8.device):
        err = lib.wsi_fused_preprocess_bands(
            batch_u8.data_ptr(), out.data_ptr(), int(out.dtype == torch.bfloat16),
            b, h, w, oh, ow,
            hs.data_ptr(), cols.data_ptr(), hw_.data_ptr(), hw_.shape[1],
            vs.data_ptr(), vn.data_ptr(), vw.data_ptr(), vw.shape[1],
            _affine(scale, shift), plan.taps, plan.threads, plan.band_rows, plan.chunk_rows,
            plan.ring_rows, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_preprocess launch failed: {lib.wsi_cuda_error_string(err).decode()}"
        )


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
    launch(_kernel(), batch_u8, out, scale, shift, _plan(h, w, oh, ow))
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
