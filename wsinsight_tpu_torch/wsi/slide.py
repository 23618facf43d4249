"""Whole-slide reader built on the in-house TIFF parser.

Provides the same reader surface the reference consumes from tiffslide/openslide
(reference: wsinsight/wsi.py:75-105): ``dimensions``, ``level_count``,
``level_dimensions``, ``properties``, ``read_region(location, level, size)`` (level-0
coordinates, zero-padded out-of-bounds — matching the backends' padding behavior
exercised by the reference tests, reference: tests/test_all.py:747-765), and
``get_thumbnail(size)``.

Patch decode is the CPU hot loop that feeds the card (reference call stack:
modellib/data.py:270-281); `read_region_array` returns numpy directly to avoid a
PIL round-trip, and a per-slide tile LRU amortizes decode across overlapping reads.

Each level decodes through the native (C++) region reader of ``native/`` where
it takes the page's layout (8-bit, with segment offsets, a codec it has), and
through the Python tile path otherwise. ``read_patches_array`` decodes a
whole batch in one native call. ``reads`` counts the patches (regions) each
path served, so callers and tests see which one ran.
"""

from __future__ import annotations

import logging
import os
import threading
from collections import OrderedDict

import numpy as np
from PIL import Image

from .tiff import TiffFile, TiffPage

logger = logging.getLogger(__name__)

PROPERTY_NAME_MPP_X = "wsinsight.mpp-x"
PROPERTY_NAME_MPP_Y = "wsinsight.mpp-y"


class TpuSlide:
    """Pyramidal TIFF whole-slide reader (openslide-compatible surface)."""

    def __init__(self, path: str | os.PathLike, tile_cache_mb: int = 256):
        self.path = str(path)
        self._tf = TiffFile(path)
        # Pyramid levels: the baseline plus every TILED page strictly smaller
        # than the previous kept level. Aperio SVS interleaves non-pyramid
        # pages — IFD1 is a STRIPPED thumbnail, and label/macro pages are
        # stripped too (Aperio format spec) — so requiring tiling keeps the
        # real 4x/16x levels that follow the thumbnail instead of stopping at
        # it. Purely stripped single-level TIFFs still work: page 0 is always
        # level 0 regardless of layout.
        pages = self._tf.pages
        levels: list[TiffPage] = [pages[0]]
        for p in pages[1:]:
            prev = levels[-1]
            if (
                p.is_tiled
                and 0 < p.width < prev.width
                and 0 < p.height < prev.height
            ):
                levels.append(p)
        self._levels = levels
        self._lock = threading.Lock()
        self._cache: OrderedDict[tuple[int, int], np.ndarray] = OrderedDict()
        self._cache_budget = tile_cache_mb * (1 << 20)
        self._cache_bytes = 0
        # Native (C++) region readers per level (and per (level, 2) for the
        # DCT half-scale decode), created at first use. None means "not yet
        # tried"; False means "declined, or failed mid-read: Python path".
        self._native: dict = {}
        self._native_lock = threading.Lock()
        self._native_cache_mb = tile_cache_mb
        # Patches (regions) served by each decode path.
        self.reads = {"native": 0, "python": 0}

        self.properties: dict[str, object] = {}
        mpp = self._tf.mpp()
        if mpp is not None:
            self.properties[PROPERTY_NAME_MPP_X] = mpp[0]
            self.properties[PROPERTY_NAME_MPP_Y] = mpp[1]
        p0 = levels[0]
        if p0.description:
            self.properties["wsinsight.comment"] = p0.description

    # -- openslide-like surface -------------------------------------------------
    @property
    def dimensions(self) -> tuple[int, int]:
        p = self._levels[0]
        return (p.width, p.height)

    @property
    def level_count(self) -> int:
        return len(self._levels)

    @property
    def level_dimensions(self) -> tuple[tuple[int, int], ...]:
        return tuple((p.width, p.height) for p in self._levels)

    @property
    def level_downsamples(self) -> tuple[float, ...]:
        w0, h0 = self.dimensions
        return tuple(((w0 / p.width) + (h0 / p.height)) / 2 for p in self._levels)

    def get_best_level_for_downsample(self, downsample: float) -> int:
        best = 0
        for i, ds in enumerate(self.level_downsamples):
            if ds <= downsample + 1e-9:
                best = i
        return best

    def close(self) -> None:
        with self._native_lock:
            for r in self._native.values():
                if r:
                    r.close()
            self._native.clear()
        self._tf.close()

    def __enter__(self) -> "TpuSlide":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- tile access --------------------------------------------------------------
    def _get_segment(self, level: int, index: int) -> np.ndarray:
        key = (level, index)
        with self._lock:
            arr = self._cache.get(key)
            if arr is not None:
                self._cache.move_to_end(key)
                return arr
        page = self._levels[level]
        arr = page.decode_segment(index)
        if arr.shape[2] > 3:
            arr = arr[:, :, :3]
        elif arr.shape[2] == 1:  # grayscale pages -> RGB
            arr = np.repeat(arr, 3, axis=2)
        with self._lock:
            if key not in self._cache:
                self._cache[key] = arr
                self._cache_bytes += arr.nbytes
                while self._cache_bytes > self._cache_budget and self._cache:
                    _, old = self._cache.popitem(last=False)
                    self._cache_bytes -= old.nbytes
        return arr

    def _count(self, path: str, n: int) -> None:
        with self._lock:
            self.reads[path] += n

    def _native_reader(self, level: int, scale_denom: int = 1):
        """The native region reader of a level, created at first use, or
        False where ``NativeRegionReader.open`` declined the page.

        scale_denom=2 keys a separate reader that decodes JPEG tiles at DCT
        half resolution (its coordinates are the halved level grid); other
        pages decline it. A library that cannot be built or loaded raises.
        """
        key = level if scale_denom == 1 else (level, scale_denom)
        with self._native_lock:
            r = self._native.get(key)
            if r is None:
                from ..native import NativeRegionReader

                r = NativeRegionReader.open(self.path, self._levels[level],
                                            cache_mb=self._native_cache_mb,
                                            scale_denom=scale_denom) or False
                self._native[key] = r
            return r

    def has_native(self, level: int = 0, scale_denom: int = 1) -> bool:
        """Whether ``read_patches_array`` decodes this level natively."""
        if level < 0 or level >= len(self._levels):
            raise ValueError(f"invalid level {level}")
        return self._native_reader(level, scale_denom) is not False

    def _native_failed(self, level: int, scale_denom: int, what: str) -> None:
        """A decode error inside the native reader: the level (at this
        scale) sticks to the Python path from here on."""
        key = level if scale_denom == 1 else (level, scale_denom)
        with self._native_lock:
            self._native[key] = False
        logger.warning(f"{self.path}: native decode failed on {what} at level {level}"
                       f" (scale 1/{scale_denom}); that level decodes in Python from here on")

    def read_patches_array(
        self,
        locations: np.ndarray,
        level: int,
        size: tuple[int, int],
        out: np.ndarray | None = None,
        scale_denom: int = 1,
    ) -> np.ndarray | None:
        """Batch-decode (n, 2) level-0 [x, y] locations to (n, h, w, 3) uint8.

        One GIL-free native call for the whole batch (decode, tile LRU and
        assembly in C++). Returns None where the level has no native reader
        (``has_native``) or a decode error stopped it (logged; the level then
        stays on the Python path); the caller then decodes per patch with
        ``read_region_array``. ``out`` optionally receives the pixels (lets
        callers shard a batch across threads).

        With scale_denom=2 (JPEG pages only), pixels come from the DCT
        half-resolution decode: ``size`` is the halved patch size and each
        location maps to floor(loc / 2) on the halved grid (the fast-input
        decode; lossy against decode-then-downsample, so opt-in).
        """
        if level < 0 or level >= len(self._levels):
            raise ValueError(f"invalid level {level}")
        reader = self._native_reader(level, scale_denom)
        if reader is False:
            return None
        locs = np.asarray(locations, np.int64).reshape(-1, 2)
        if level:
            ds = self.level_downsamples[level]
            locs = (locs / ds).astype(np.int64)
        if scale_denom != 1:
            locs = locs // scale_denom
        got = reader.read_patches(locs, size, out=out)
        if got is None:
            self._native_failed(level, scale_denom, f"a batch of {len(locs)} patches")
            return None
        self._count("native", len(locs))
        return got

    def read_region_array(
        self, location: tuple[int, int], level: int, size: tuple[int, int]
    ) -> np.ndarray:
        """Read a region as (h, w, 3) uint8. `location` is in level-0 coordinates."""
        if level < 0 or level >= len(self._levels):
            raise ValueError(f"invalid level {level}")
        page = self._levels[level]
        ds = self.level_downsamples[level]
        x0 = int(location[0] / ds) if level else int(location[0])
        y0 = int(location[1] / ds) if level else int(location[1])
        w, h = int(size[0]), int(size[1])
        out = np.zeros((h, w, 3), np.uint8)

        # Clip the request against the level bounds.
        lx0, ly0 = max(x0, 0), max(y0, 0)
        lx1, ly1 = min(x0 + w, page.width), min(y0 + h, page.height)
        if lx1 <= lx0 or ly1 <= ly0:
            return out

        reader = self._native_reader(level)
        if reader is not False:
            arr = reader.read_region((x0, y0), (w, h))
            if arr is not None:
                self._count("native", 1)
                return arr
            self._native_failed(level, 1, f"the region at {(x0, y0)}")

        self._count("python", 1)
        if page.is_tiled:
            tw, thh = page.tile_width, page.tile_height
            ta = page.tiles_across
            ty0, ty1 = ly0 // thh, (ly1 - 1) // thh
            tx0, tx1 = lx0 // tw, (lx1 - 1) // tw
            for ty in range(ty0, ty1 + 1):
                for tx in range(tx0, tx1 + 1):
                    seg = self._get_segment(level, ty * ta + tx)
                    gx0, gy0 = tx * tw, ty * thh
                    sx0 = max(lx0, gx0)
                    sy0 = max(ly0, gy0)
                    sx1 = min(lx1, gx0 + tw)
                    sy1 = min(ly1, gy0 + thh)
                    out[sy0 - y0 : sy1 - y0, sx0 - x0 : sx1 - x0] = seg[
                        sy0 - gy0 : sy1 - gy0, sx0 - gx0 : sx1 - gx0
                    ]
        else:
            rps = page.rows_per_strip
            sy0, sy1 = ly0 // rps, (ly1 - 1) // rps
            for s in range(sy0, sy1 + 1):
                seg = self._get_segment(level, s)
                gy0 = s * rps
                a0 = max(ly0, gy0)
                a1 = min(ly1, gy0 + seg.shape[0])
                out[a0 - y0 : a1 - y0, lx0 - x0 : lx1 - x0] = seg[
                    a0 - gy0 : a1 - gy0, lx0:lx1
                ]
        return out

    def read_region(
        self, location: tuple[int, int], level: int, size: tuple[int, int]
    ) -> Image.Image:
        return Image.fromarray(self.read_region_array(location, level, size), "RGB")

    def get_thumbnail(self, size: tuple[int, int]) -> Image.Image:
        """Return an RGB thumbnail no larger than `size`, preserving aspect."""
        w0, h0 = self.dimensions
        downsample = max(w0 / size[0], h0 / size[1])
        level = self.get_best_level_for_downsample(downsample)
        page = self._levels[level]
        # Memory guard: a pyramid-less gigapixel slide would otherwise decode
        # fully into RAM here. Above ~256 Mpx, stream tiles and reduce each
        # directly into the thumbnail-scale buffer instead.
        if page.width * page.height > 256_000_000 and page.is_tiled:
            arr = self._streamed_thumbnail(page, size)
        else:
            arr = page.asarray()
            if arr.ndim == 2:
                arr = arr[:, :, None]
            if arr.shape[2] == 1:  # grayscale -> RGB, like _get_segment
                arr = np.repeat(arr, 3, axis=2)
            arr = arr[:, :, :3]
        img = Image.fromarray(np.ascontiguousarray(arr), "RGB")
        img.thumbnail(size, Image.Resampling.LANCZOS)
        return img

    def _streamed_thumbnail(self, page, size: tuple[int, int]) -> np.ndarray:
        import cv2

        scale = max(page.width / size[0], page.height / size[1])
        # Render at 2x the target for a decent final LANCZOS pass.
        out_w = max(1, int(page.width / scale * 2))
        out_h = max(1, int(page.height / scale * 2))
        out = np.zeros((out_h, out_w, 3), np.uint8)
        tw, th = page.tile_width, page.tile_height
        ta = page.tiles_across
        for ty in range(page.tiles_down):
            for tx in range(ta):
                seg = self._get_segment(self._levels.index(page), ty * ta + tx)
                x0 = int(tx * tw / page.width * out_w)
                y0 = int(ty * th / page.height * out_h)
                x1 = min(out_w, int((tx + 1) * tw / page.width * out_w))
                y1 = min(out_h, int((ty + 1) * th / page.height * out_h))
                if x1 <= x0 or y1 <= y0:
                    continue
                out[y0:y1, x0:x1] = cv2.resize(
                    seg[:, :, :3], (x1 - x0, y1 - y0), interpolation=cv2.INTER_AREA
                )
        return out
