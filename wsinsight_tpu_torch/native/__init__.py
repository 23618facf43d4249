"""The port's host library (C++, loaded with ctypes): tile decode, LZW, the
PIL-exact uint8 resize, the YUV 4:2:0 packer and the watershed.

Counterpart of wsinsight_tpu/native/__init__.py for ``tiledec.cpp``,
``lzw.cpp``, ``resize.cpp``, ``yuv.cpp`` and ``watershed.cpp`` (copies of the
JAX package's sources). ``ops.native_build`` compiles them at first use into
``build/wsinsight_tpu_torch/``. Unlike the JAX package, a library that does
not build or load raises (with the compiler's or loader's message): nothing
here returns None for a missing library. Functions still return None for an
input they decline (odd YUV geometry, more than 8 channels, a page layout the
reader does not handle), as the JAX ones do, so callers pick another path for
that input.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32, i64, u8p = ctypes.c_int32, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
    i32p, i64p, u64p = (ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
                        ctypes.POINTER(ctypes.c_uint64))
    lib.lzw_decode.argtypes = [u8p, i64, u8p, i64]
    lib.lzw_decode.restype = i64
    lib.wsi_has_jpeg.argtypes = []
    lib.wsi_has_jpeg.restype = i32
    lib.wsi_open.argtypes = [
        ctypes.c_char_p, i64, u64p, u64p,  # path, segments, offsets, bytecounts
        i32, i32, i32, i32,  # compression, predictor, samples, tiled
        i32, i32, i64, i64,  # tile w, tile h, page w, page h
        u8p, i64, i64, i32,  # jpeg tables, their length, cache MiB, scale denominator
    ]
    lib.wsi_open.restype = i64
    lib.wsi_read_region.argtypes = [i64, i64, i64, i32, i32, u8p]
    lib.wsi_read_region.restype = i32
    lib.wsi_read_patches.argtypes = [i64, i64, i64p, i32, i32, u8p]
    lib.wsi_read_patches.restype = i32
    lib.wsi_close.argtypes = [i64]
    lib.wsi_close.restype = None
    lib.pil_resize_u8_batch.argtypes = [u8p, i64, i32, i32, i32, i32p, i32, i32p, i32, u8p]
    lib.pil_resize_u8_batch.restype = i32
    lib.rgb_to_yuv420_batch.argtypes = [u8p, i64, i32, i32, u8p]
    lib.rgb_to_yuv420_batch.restype = i32
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.watershed_f32.argtypes = [f32p, i32p, u8p, i32, i32, i32p]
    lib.watershed_f32.restype = None
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library (built at first use). Raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            from ..ops import native_build

            _lib = _bind(native_build.load())
        return _lib


def has_jpeg() -> bool:
    """Whether the library was built with its JPEG codec (libjpeg found)."""
    return bool(get_lib().wsi_has_jpeg())


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def lzw_decode_native(data: bytes, expected_size: int) -> bytes | None:
    """Decode TIFF LZW; None when the stream is corrupt."""
    lib = get_lib()
    src = np.frombuffer(data, np.uint8)
    out = np.empty(expected_size, np.uint8)
    n = lib.lzw_decode(
        _ptr(src, ctypes.c_uint8), len(src), _ptr(out, ctypes.c_uint8), expected_size
    )
    if n < 0:
        return None
    return out[:n].tobytes()


def watershed_native(
    image: np.ndarray, markers: np.ndarray, mask: np.ndarray | None
) -> np.ndarray:
    """The priority-flood watershed of ``watershed.cpp`` (skimage semantics,
    connectivity 1, ties broken by age): (H, W) float32 image, int32 markers
    (> 0 seeds), uint8 mask (0 excluded; None for everything) -> (H, W) int32
    labels."""
    lib = get_lib()
    h, w = image.shape
    image = np.ascontiguousarray(image, np.float32)
    markers = np.ascontiguousarray(markers, np.int32)
    if markers.shape != (h, w) or (mask is not None and np.shape(mask) != (h, w)):
        raise ValueError(f"watershed_native: markers and mask must be {(h, w)}")
    if mask is None:
        mask_arr = np.ones((h, w), np.uint8)
    else:
        mask_arr = np.ascontiguousarray(mask, np.uint8)
    out = np.zeros((h, w), np.int32)
    lib.watershed_f32(
        _ptr(image, ctypes.c_float),
        _ptr(markers, ctypes.c_int32),
        _ptr(mask_arr, ctypes.c_uint8),
        h,
        w,
        _ptr(out, ctypes.c_int32),
    )
    return out


@functools.lru_cache(maxsize=64)
def _resize_coeffs_i32(in_size: int, out_size: int) -> np.ndarray:
    """PIL fixed-point (out, in) int32 coefficient matrix (2^22 scale).

    Derived from the same float table the device path uses
    (ops/preprocess._pil_bilinear_weights), so the native, device and PIL
    resizes are bit-identical by construction.
    """
    from ..ops.preprocess import _pil_bilinear_weights

    w = _pil_bilinear_weights(in_size, out_size)
    return np.ascontiguousarray(
        np.round(w.astype(np.float64) * (1 << 22)).astype(np.int32)
    )


def pil_resize_native(
    src: np.ndarray, out_hw: tuple[int, int], out: np.ndarray | None = None
) -> np.ndarray | None:
    """PIL-bit-exact bilinear resize of a uint8 batch.

    src: (n, h, w, c) or (h, w, c) uint8, c <= 8. Returns the resized batch
    in the input's rank (into ``out`` when given), or None for an input it
    declines (other dtype or rank, c > 8). The C call releases the GIL, so
    decode threads scale across a batch.
    """
    squeeze = src.ndim == 3
    batch = src[None] if squeeze else src
    if batch.ndim != 4 or batch.dtype != np.uint8:
        return None
    n, h, w, c = batch.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if c > 8:
        return None
    lib = get_lib()
    kh = _resize_coeffs_i32(h, oh)
    kw = _resize_coeffs_i32(w, ow)
    batch = np.ascontiguousarray(batch)
    if out is None:
        out = np.empty((n, oh, ow, c), np.uint8)
    elif out.shape != (n, oh, ow, c) or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"pil_resize_native: out must be contiguous uint8 {(n, oh, ow, c)}")
    rc = lib.pil_resize_u8_batch(
        _ptr(batch, ctypes.c_uint8), n, h, w, c,
        _ptr(kw, ctypes.c_int32), ow, _ptr(kh, ctypes.c_int32), oh,
        _ptr(out, ctypes.c_uint8),
    )
    if rc != 0:
        return None
    return out[0] if squeeze else out


def _yuv_geometry(src: np.ndarray):
    squeeze = src.ndim == 3
    batch = src[None] if squeeze else src
    if batch.ndim != 4 or batch.dtype != np.uint8 or batch.shape[-1] != 3:
        return None
    n, h, w, _ = batch.shape
    if h % 2 or w % 2:
        return None
    return batch, squeeze


def rgb_to_yuv420(src: np.ndarray, out: np.ndarray | None = None) -> np.ndarray | None:
    """Pack a uint8 RGB batch as planar YUV 4:2:0 (the thin-link wire format).

    src: (n, h, w, 3) or (h, w, 3) uint8 with h, w even. Returns
    (n, h*3/2, w) / (h*3/2, w) uint8: Y plane rows [0, h), then chroma rows
    holding Cb | Cr side by side at (h/2, w/2) each. BT.601 full range.
    Device inverse: ops/preprocess.yuv420_to_rgb. Returns None for invalid
    geometry (odd h or w, wrong dtype or rank). ``rgb_to_yuv420_numpy`` is
    the same arithmetic in numpy.
    """
    geometry = _yuv_geometry(src)
    if geometry is None:
        return None
    batch, squeeze = geometry
    n, h, w, _ = batch.shape
    if out is None:
        out = np.empty((n, h * 3 // 2, w), np.uint8)
    elif out.shape != (n, h * 3 // 2, w) or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"rgb_to_yuv420: out must be contiguous uint8 {(n, h * 3 // 2, w)}")
    batch = np.ascontiguousarray(batch)
    rc = get_lib().rgb_to_yuv420_batch(_ptr(batch, ctypes.c_uint8), n, h, w,
                                       _ptr(out, ctypes.c_uint8))
    if rc != 0:
        return None
    return out[0] if squeeze else out


def rgb_to_yuv420_numpy(src: np.ndarray) -> np.ndarray | None:
    """``rgb_to_yuv420`` in numpy: the same fixed-point rounding as yuv.cpp."""
    geometry = _yuv_geometry(src)
    if geometry is None:
        return None
    batch, squeeze = geometry
    n, h, w, _ = batch.shape
    out = np.empty((n, h * 3 // 2, w), np.uint8)
    r = batch[..., 0].astype(np.int64)
    g = batch[..., 1].astype(np.int64)
    b = batch[..., 2].astype(np.int64)
    half = 1 << 15
    out[:, :h, :] = ((19595 * r + 38470 * g + 7471 * b + half) >> 16).astype(np.uint8)
    cb = -11056 * r - 21712 * g + 32768 * b
    cr = 32768 * r - 27440 * g - 5328 * b
    for plane, col0 in ((cb, 0), (cr, w // 2)):
        s = (
            plane[:, 0::2, 0::2]
            + plane[:, 0::2, 1::2]
            + plane[:, 1::2, 0::2]
            + plane[:, 1::2, 1::2]
        )
        q = s + 2  # C++ /4 truncates toward zero; emulate for bit-parity
        vals = (np.sign(q) * (np.abs(q) // 4) + (128 << 16) + half) >> 16
        out[:, h:, col0 : col0 + w // 2] = np.clip(vals, 0, 255).astype(np.uint8)
    return out[0] if squeeze else out


class NativeRegionReader:
    """GIL-free tile decode and patch assembly over one TIFF page.

    Owns its own file descriptor (pread), the JPEG (libjpeg) / Deflate / LZW /
    PackBits decode, an in-C++ decoded-tile LRU and the patch blitting, so one
    ctypes call decodes a whole batch with the GIL released.
    ``NativeRegionReader.open`` returns None for a page layout it declines;
    the caller decodes that page through its Python path.
    """

    def __init__(self, handle: int, lib: ctypes.CDLL):
        self._handle = handle
        self._lib = lib

    @classmethod
    def open(
        cls, path: str, page, cache_mb: int = 256, scale_denom: int = 1
    ) -> "NativeRegionReader | None":
        """A reader for a TiffPage, or None when the page's layout is not
        one it decodes: not 8-bit, no segment offsets, a codec it lacks (JPEG
        in a build without libjpeg), or ``scale_denom=2`` on a page that is
        not JPEG. Raises when the library cannot be built or loaded.

        ``scale_denom=2`` opens a JPEG page in DCT-scaled half-resolution
        mode: every read addresses the page in halved pixel coordinates and
        decode runs a 4x4 IDCT on a quarter of the pixels (the fast input,
        WSINSIGHT_DECODE_SCALE).
        """
        lib = get_lib()
        if getattr(page, "bits", 8) != 8 or page.offsets is None:
            return None
        offsets = np.ascontiguousarray(np.asarray(page.offsets, np.uint64))
        counts = np.ascontiguousarray(np.asarray(page.bytecounts, np.uint64))
        tables = page.jpeg_tables or b""
        tables_arr = np.frombuffer(tables, np.uint8) if tables else np.zeros(1, np.uint8)
        if page.is_tiled:
            tile_w, tile_h = int(page.tile_width), int(page.tile_height)
        else:
            tile_w, tile_h = int(page.width), int(page.rows_per_strip)
        handle = lib.wsi_open(
            str(path).encode(),
            len(offsets),
            _ptr(offsets, ctypes.c_uint64),
            _ptr(counts, ctypes.c_uint64),
            int(page.compression),
            int(getattr(page, "predictor", 1)),
            int(getattr(page, "samples", 3)),
            1 if page.is_tiled else 0,
            tile_w,
            tile_h,
            int(page.width),
            int(page.height),
            _ptr(tables_arr, ctypes.c_uint8),
            len(tables),
            int(cache_mb),
            int(scale_denom),
        )
        if handle < 0:
            return None
        return cls(handle, lib)

    def read_region(self, location: tuple[int, int], size: tuple[int, int]) -> np.ndarray | None:
        """(h, w, 3) uint8 region at page-level coords; None on a decode error."""
        w, h = int(size[0]), int(size[1])
        out = np.empty((h, w, 3), np.uint8)
        rc = self._lib.wsi_read_region(
            self._handle, int(location[0]), int(location[1]), w, h,
            _ptr(out, ctypes.c_uint8),
        )
        return out if rc == 0 else None

    def read_patches(
        self, coords: np.ndarray, size: tuple[int, int], out: np.ndarray | None = None
    ) -> np.ndarray | None:
        """Batch decode: (n, 2) [x, y] coords -> (n, h, w, 3) uint8; None on
        a decode error.

        ``out`` (contiguous uint8 of that shape) lets callers decode into a
        slice of a larger buffer, which is how one batch fans out over threads.
        """
        w, h = int(size[0]), int(size[1])
        xy = np.ascontiguousarray(np.asarray(coords, np.int64).reshape(-1, 2))
        if out is None:
            out = np.empty((len(xy), h, w, 3), np.uint8)
        elif out.shape != (len(xy), h, w, 3) or out.dtype != np.uint8 or not out.flags.c_contiguous:
            raise ValueError(f"read_patches: out must be contiguous uint8 {(len(xy), h, w, 3)}")
        rc = self._lib.wsi_read_patches(
            self._handle, len(xy), _ptr(xy, ctypes.c_int64), w, h,
            _ptr(out, ctypes.c_uint8),
        )
        return out if rc == 0 else None

    def close(self) -> None:
        if self._handle >= 0:
            self._lib.wsi_close(self._handle)
            self._handle = -1

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass
