"""Level 0 of a tiled, JPEG-compressed classic TIFF, read tile by tile with
cv2: the reference's own decode of the benchmark's slides."""

from __future__ import annotations

import struct

import cv2
import numpy as np

_TYPES = {3: ("H", 2), 4: ("I", 4), 16: ("Q", 8)}


class TiledTiff:
    """Tile offsets and byte counts of the first page (level 0)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            head = fh.read(8)
            if head[:4] != b"II*\x00":
                raise ValueError(f"{path}: not a little-endian classic TIFF")
            (ifd,) = struct.unpack("<I", head[4:8])
            fh.seek(ifd)
            (n,) = struct.unpack("<H", fh.read(2))
            tags = {}
            for _ in range(n):
                tag, typ, count, value = struct.unpack("<HHI4s", fh.read(12))
                tags[tag] = (typ, count, value)
            self.width = self._scalar(tags[256])
            self.height = self._scalar(tags[257])
            self.tile_w = self._scalar(tags[322])
            self.tile_h = self._scalar(tags[323])
            if self._scalar(tags[259]) != 7:
                raise ValueError(f"{path}: level 0 is not JPEG-compressed")
            self.offsets = self._array(fh, tags[324])
            self.counts = self._array(fh, tags[325])
        self.tiles_across = -(-self.width // self.tile_w)

    @staticmethod
    def _scalar(entry) -> int:
        typ, _, value = entry
        fmt, size = _TYPES[typ]
        return struct.unpack("<" + fmt, value[:size])[0]

    @staticmethod
    def _array(fh, entry) -> np.ndarray:
        typ, count, value = entry
        fmt, size = _TYPES[typ]
        if count * size <= 4:
            return np.array(struct.unpack(f"<{count}{fmt}", value[:count * size]), np.int64)
        fh.seek(struct.unpack("<I", value)[0])
        return np.array(struct.unpack(f"<{count}{fmt}", fh.read(count * size)), np.int64)

    def read_region(self, x: int, y: int, w: int, h: int) -> np.ndarray:
        """(h, w, 3) uint8 RGB of level 0 at (x, y), zero outside the slide."""
        out = np.zeros((h, w, 3), np.uint8)
        tw, th = self.tile_w, self.tile_h
        with open(self.path, "rb") as fh:
            for ty in range(max(0, y // th), min(-(-self.height // th), -(-(y + h) // th))):
                for tx in range(max(0, x // tw), min(self.tiles_across, -(-(x + w) // tw))):
                    i = ty * self.tiles_across + tx
                    fh.seek(int(self.offsets[i]))
                    data = np.frombuffer(fh.read(int(self.counts[i])), np.uint8)
                    tile = cv2.imdecode(data, cv2.IMREAD_COLOR)[:, :, ::-1]
                    x0, y0 = tx * tw, ty * th
                    ax, ay = max(x, x0), max(y, y0)
                    bx, by = min(x + w, x0 + tw, self.width), min(y + h, y0 + th, self.height)
                    out[ay - y:by - y, ax - x:bx - x] = tile[ay - y0:by - y0, ax - x0:bx - x0]
        return out

    def read_patches(self, coords, size: int) -> np.ndarray:
        """(N, size, size, 3) uint8 patches at the (N, 2) top-left ``coords``."""
        return np.stack([self.read_region(int(x), int(y), size, size) for x, y in coords])
