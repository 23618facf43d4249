"""A from-scratch (Big)TIFF parser, tile decoder, and pyramidal writer.

The reference stack reads slides through tiffslide/openslide/tifffile (reference:
wsinsight/wsi.py:21-50, wsinsight/patchlib/pipeline.py:23,306). None of those are
dependencies here: wsinsight-tpu owns the container format end to end so the input
pipeline can be tuned for feeding the accelerator (tile-granular reads, zero-copy numpy
assembly, and a native C++ fast path for the hot decode loop: ``native/``, built
at first use, decodes LZW here and whole batches of tiles in ``wsi/slide.py``).

Supported on read:
  * Classic TIFF and BigTIFF, little- and big-endian.
  * Tiled and stripped pages, PlanarConfig=1 (contiguous), 8-bit samples.
  * Compression: none (1), LZW (5), old/new JPEG (6/7, via cv2), Deflate
    (8 / 32946), PackBits (32773).
  * Predictor 2 (horizontal differencing) for LZW/Deflate.
  * JPEGTables (tag 347) splicing for abbreviated per-tile JPEG streams.
  * Pyramid levels as successive reduced-resolution pages of the main IFD chain
    (generic pyramidal TIFF) including SVS-style files.

Supported on write:
  * Tiled RGB pages (classic TIFF or BigTIFF), compression none/deflate/JPEG,
    resolution tags, ImageDescription, multi-level pyramids.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from dataclasses import dataclass, field
from fractions import Fraction
from typing import BinaryIO, Sequence

import numpy as np

try:  # cv2 is used for JPEG codec; the rest of the module is dependency-free.
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

# --- TIFF tag ids we care about -------------------------------------------------
TAG_IMAGE_WIDTH = 256
TAG_IMAGE_LENGTH = 257
TAG_BITS_PER_SAMPLE = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_IMAGE_DESCRIPTION = 270
TAG_STRIP_OFFSETS = 273
TAG_SAMPLES_PER_PIXEL = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_BYTE_COUNTS = 279
TAG_X_RESOLUTION = 282
TAG_Y_RESOLUTION = 283
TAG_PLANAR_CONFIG = 284
TAG_RESOLUTION_UNIT = 296
TAG_PREDICTOR = 317
TAG_TILE_WIDTH = 322
TAG_TILE_LENGTH = 323
TAG_TILE_OFFSETS = 324
TAG_TILE_BYTE_COUNTS = 325
TAG_SAMPLE_FORMAT = 339
TAG_JPEG_TABLES = 347
TAG_YCBCR_SUBSAMPLING = 530

COMPRESSION_NONE = 1
COMPRESSION_LZW = 5
COMPRESSION_JPEG_OLD = 6
COMPRESSION_JPEG = 7
COMPRESSION_DEFLATE_ADOBE = 8
COMPRESSION_PACKBITS = 32773
COMPRESSION_DEFLATE = 32946

RESUNIT_NONE = 1
RESUNIT_INCH = 2
RESUNIT_CENTIMETER = 3

# TIFF data types: id -> (struct fmt char, size in bytes)
_TYPE_FMT = {
    1: ("B", 1),  # BYTE
    2: ("s", 1),  # ASCII
    3: ("H", 2),  # SHORT
    4: ("I", 4),  # LONG
    5: ("II", 8),  # RATIONAL
    6: ("b", 1),  # SBYTE
    7: ("B", 1),  # UNDEFINED
    8: ("h", 2),  # SSHORT
    9: ("i", 4),  # SLONG
    10: ("ii", 8),  # SRATIONAL
    11: ("f", 4),  # FLOAT
    12: ("d", 8),  # DOUBLE
    16: ("Q", 8),  # LONG8 (BigTIFF)
    17: ("q", 8),  # SLONG8
    18: ("Q", 8),  # IFD8
}


class TiffError(Exception):
    pass


# =================================================================================
# LZW / PackBits codecs (pure numpy/python; C++ fast path optional at runtime)
# =================================================================================


def lzw_decode(data: bytes, expected_size: int | None = None) -> bytes:
    """Decode TIFF-flavor LZW (MSB-first bit packing, early code change)."""
    if not data:
        return b""
    if data[0] == 0 and len(data) > 1 and data[1] & 0x1:
        raise TiffError("old-style LZW (LSB) not supported")

    CLEAR, EOI = 256, 257
    # dictionary as list of bytes
    out = bytearray()
    table: list[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    prev: bytes | None = None
    bitlen = 9
    buf = 0
    nbits = 0
    pos = 0
    n = len(data)
    maxcode = (1 << bitlen) - 2  # early change: switch at 2**b - 1 entries
    while True:
        while nbits < bitlen:
            if pos >= n:
                return bytes(out)
            buf = (buf << 8) | data[pos]
            pos += 1
            nbits += 8
        code = (buf >> (nbits - bitlen)) & ((1 << bitlen) - 1)
        nbits -= bitlen
        if code == EOI:
            break
        if code == CLEAR:
            table = table[:258]
            bitlen = 9
            maxcode = (1 << bitlen) - 2
            prev = None
            continue
        if prev is None:
            entry = table[code]
            out += entry
            prev = entry
            continue
        if code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise TiffError(f"corrupt LZW stream: code {code} > table {len(table)}")
        out += entry
        prev = entry
        # Early change: the decoder's table lags the encoder by one entry, so
        # widen one entry sooner than the encoder does.
        if len(table) >= maxcode and bitlen < 12:
            bitlen += 1
            maxcode = (1 << bitlen) - 2
    return bytes(out)


def lzw_encode(data: bytes) -> bytes:
    """Encode TIFF-flavor LZW (MSB-first, early code change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    buf = 0
    nbits = 0
    bitlen = 9

    def emit(code: int) -> None:
        nonlocal buf, nbits
        buf = (buf << bitlen) | code
        nbits += bitlen
        while nbits >= 8:
            out.append((buf >> (nbits - 8)) & 0xFF)
            nbits -= 8

    table: dict[bytes, int] = {bytes([i]): i for i in range(256)}
    nextcode = 258
    emit(CLEAR)
    w = b""
    for ch in data:
        wc = w + bytes([ch])
        if wc in table:
            w = wc
        else:
            emit(table[w])
            table[wc] = nextcode
            nextcode += 1
            if nextcode == (1 << bitlen) - 1:
                if bitlen == 12:
                    emit(CLEAR)
                    table = {bytes([i]): i for i in range(256)}
                    nextcode = 258
                    bitlen = 9
                else:
                    bitlen += 1
            w = bytes([ch])
    if w:
        emit(table[w])
    emit(EOI)
    if nbits:
        out.append((buf << (8 - nbits)) & 0xFF)
    return bytes(out)


def packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i : i + h + 1]
            i += h + 1
        elif h > 128:
            if i < n:
                out += bytes([data[i]]) * (257 - h)
                i += 1
        # h == 128: no-op
    return bytes(out)


# =================================================================================
# Reader
# =================================================================================


@dataclass
class TiffPage:
    """One IFD with decoded tag values and segment (tile/strip) geometry."""

    fh: BinaryIO
    byteorder: str
    offset: int
    tags: dict[int, object] = field(default_factory=dict)

    width: int = 0
    height: int = 0
    tile_width: int = 0
    tile_height: int = 0
    is_tiled: bool = False
    rows_per_strip: int = 0
    compression: int = COMPRESSION_NONE
    photometric: int = 2
    predictor: int = 1
    samples: int = 3
    bits: int = 8
    offsets: np.ndarray | None = None
    bytecounts: np.ndarray | None = None
    jpeg_tables: bytes | None = None
    description: str = ""
    next_ifd: int = 0

    # -- geometry helpers -----------------------------------------------------
    @property
    def tiles_across(self) -> int:
        return -(-self.width // self.tile_width) if self.is_tiled else 1

    @property
    def tiles_down(self) -> int:
        if self.is_tiled:
            return -(-self.height // self.tile_height)
        return -(-self.height // self.rows_per_strip)

    # -- decoding ---------------------------------------------------------------
    def _decompress(self, raw: bytes, out_size: int) -> bytes:
        c = self.compression
        if c == COMPRESSION_NONE:
            return raw
        if c in (COMPRESSION_DEFLATE, COMPRESSION_DEFLATE_ADOBE):
            return zlib.decompress(raw)
        if c == COMPRESSION_LZW:
            # Native codec (releases the GIL; decode threads scale). A stream
            # it finds corrupt goes to the Python codec, which says why.
            from ..native import lzw_decode_native

            out = lzw_decode_native(raw, out_size)
            if out is not None:
                return out
            return lzw_decode(raw, out_size)
        if c == COMPRESSION_PACKBITS:
            return packbits_decode(raw)
        raise TiffError(f"unsupported compression {c}")

    def _jpeg_decode(self, raw: bytes) -> np.ndarray:
        if not _HAS_CV2:  # pragma: no cover
            raise TiffError("cv2 is required for JPEG-compressed TIFFs")
        if self.jpeg_tables and len(self.jpeg_tables) > 4:
            # Abbreviated stream: splice tables (between their SOI/EOI markers)
            # right after the tile's SOI marker.
            tables = self.jpeg_tables
            body = raw
            if tables[:2] == b"\xff\xd8":
                tables = tables[2:]
            if tables[-2:] == b"\xff\xd9":
                tables = tables[:-2]
            if body[:2] == b"\xff\xd8":
                stream = b"\xff\xd8" + tables + body[2:]
            else:
                stream = b"\xff\xd8" + tables + body
        else:
            stream = raw
        if self.samples == 1:
            arr = cv2.imdecode(np.frombuffer(stream, np.uint8), cv2.IMREAD_GRAYSCALE)
            if arr is None:
                raise TiffError("cv2 failed to decode JPEG tile")
            return arr[:, :, None]
        arr = cv2.imdecode(np.frombuffer(stream, np.uint8), cv2.IMREAD_COLOR)
        if arr is None:
            raise TiffError("cv2 failed to decode JPEG tile")
        return arr[:, :, ::-1]  # BGR -> RGB

    def read_segment_raw(self, index: int) -> bytes:
        """Read the compressed bytes of tile/strip `index` (thread-safe)."""
        assert self.offsets is not None and self.bytecounts is not None
        off = int(self.offsets[index])
        cnt = int(self.bytecounts[index])
        lock = getattr(self, "io_lock", None)
        if lock is not None:
            with lock:
                self.fh.seek(off)
                return self.fh.read(cnt)
        self.fh.seek(off)
        return self.fh.read(cnt)

    def decode_segment(self, index: int, raw: bytes | None = None) -> np.ndarray:
        """Decode tile/strip `index` to an (h, w, samples) uint8 array.

        The file read is serialized behind a lock; decompression runs
        unlocked so decode threads scale (the reference gets this from
        per-worker slide handles, reference: modellib/data.py:198-236).
        """
        if raw is None:
            raw = self.read_segment_raw(index)

        if self.is_tiled:
            seg_w, seg_h = self.tile_width, self.tile_height
        else:
            seg_w = self.width
            row0 = index * self.rows_per_strip
            seg_h = min(self.rows_per_strip, self.height - row0)

        if not raw:
            # Sparse/unwritten segment (offset 0, bytecount 0 — produced by
            # libtiff writers for never-touched tiles): blank, like
            # tiffslide/openslide, instead of a decompressor error.
            return np.zeros((seg_h, seg_w, self.samples), np.uint8)

        if self.compression in (COMPRESSION_JPEG, COMPRESSION_JPEG_OLD):
            arr = self._jpeg_decode(raw)
            # JPEG tiles may decode smaller/larger than nominal size at edges.
            if arr.shape[0] != seg_h or arr.shape[1] != seg_w:
                out = np.zeros((seg_h, seg_w, arr.shape[2]), np.uint8)
                h = min(seg_h, arr.shape[0])
                w = min(seg_w, arr.shape[1])
                out[:h, :w] = arr[:h, :w]
                arr = out
            return arr

        out_size = seg_w * seg_h * self.samples
        data = self._decompress(raw, out_size)
        if len(data) < out_size:
            data = data + b"\x00" * (out_size - len(data))
        arr = np.frombuffer(data[:out_size], np.uint8).reshape(
            seg_h, seg_w, self.samples
        )
        if self.predictor == 2:
            arr = np.cumsum(arr.astype(np.uint16), axis=1).astype(np.uint8)
        return arr

    def asarray(self) -> np.ndarray:
        """Decode the full page into an (H, W, samples) uint8 array."""
        out = np.zeros((self.height, self.width, self.samples), np.uint8)
        if self.is_tiled:
            ta, td = self.tiles_across, self.tiles_down
            for ty in range(td):
                for tx in range(ta):
                    seg = self.decode_segment(ty * ta + tx)
                    y0, x0 = ty * self.tile_height, tx * self.tile_width
                    h = min(self.tile_height, self.height - y0)
                    w = min(self.tile_width, self.width - x0)
                    out[y0 : y0 + h, x0 : x0 + w] = seg[:h, :w]
        else:
            for sy in range(self.tiles_down):
                seg = self.decode_segment(sy)
                y0 = sy * self.rows_per_strip
                h = min(self.rows_per_strip, self.height - y0)
                out[y0 : y0 + h] = seg[:h, : self.width]
        return out


class TiffFile:
    """Minimal multi-page TIFF/BigTIFF reader."""

    def __init__(self, path: str | os.PathLike | BinaryIO):
        if hasattr(path, "read"):
            self._fh: BinaryIO = path  # type: ignore[assignment]
            self._own = False
        else:
            self._fh = open(path, "rb")
            self._own = True
        self.path = getattr(path, "name", str(path))
        header = self._fh.read(8)
        if header[:2] == b"II":
            self.byteorder = "<"
        elif header[:2] == b"MM":
            self.byteorder = ">"
        else:
            raise TiffError(f"not a TIFF file: {self.path!r}")
        magic = struct.unpack(self.byteorder + "H", header[2:4])[0]
        if magic == 42:
            self.bigtiff = False
            first_ifd = struct.unpack(self.byteorder + "I", header[4:8])[0]
        elif magic == 43:
            self.bigtiff = True
            rest = self._fh.read(8)
            first_ifd = struct.unpack(self.byteorder + "Q", rest[:8])[0]
        else:
            raise TiffError(f"bad TIFF magic {magic}")
        self._io_lock = threading.Lock()
        self.pages: list[TiffPage] = []
        off = first_ifd
        seen = set()
        while off and off not in seen:
            seen.add(off)
            page = self._read_ifd(off)
            page.io_lock = self._io_lock  # serialize raw reads across threads
            self.pages.append(page)
            off = page.next_ifd

    # ------------------------------------------------------------------
    def close(self) -> None:
        if self._own:
            self._fh.close()

    def __enter__(self) -> "TiffFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    def _read_ifd(self, offset: int) -> TiffPage:
        bo = self.byteorder
        fh = self._fh
        fh.seek(offset)
        if self.bigtiff:
            (count,) = struct.unpack(bo + "Q", fh.read(8))
            entry_size, count_fmt, off_fmt = 20, "Q", "Q"
        else:
            (count,) = struct.unpack(bo + "H", fh.read(2))
            entry_size, count_fmt, off_fmt = 12, "I", "I"
        data = fh.read(entry_size * count)
        if self.bigtiff:
            (next_ifd,) = struct.unpack(bo + "Q", fh.read(8))
        else:
            (next_ifd,) = struct.unpack(bo + "I", fh.read(4))

        tags: dict[int, object] = {}
        for i in range(count):
            entry = data[i * entry_size : (i + 1) * entry_size]
            tag, dtype = struct.unpack(bo + "HH", entry[:4])
            (n,) = struct.unpack(bo + count_fmt, entry[4 : 4 + (8 if self.bigtiff else 4)])
            if dtype not in _TYPE_FMT:
                continue
            fmt, size = _TYPE_FMT[dtype]
            total = n * size
            inline_cap = 8 if self.bigtiff else 4
            value_field = entry[-inline_cap:]
            if total <= inline_cap:
                raw = value_field[:total]
            else:
                (value_off,) = struct.unpack(bo + off_fmt, value_field[: len(value_field)])
                pos = fh.tell()
                fh.seek(value_off)
                raw = fh.read(total)
                fh.seek(pos)
            tags[tag] = self._parse_value(dtype, n, raw)
        page = TiffPage(fh=fh, byteorder=bo, offset=offset, tags=tags, next_ifd=next_ifd)
        self._populate(page)
        return page

    def _parse_value(self, dtype: int, n: int, raw: bytes):
        bo = self.byteorder
        fmt, size = _TYPE_FMT[dtype]
        if dtype == 2:  # ASCII
            return raw.split(b"\x00", 1)[0].decode("utf-8", "replace")
        if dtype == 7:  # UNDEFINED -> raw bytes
            return raw
        if dtype in (5, 10):  # (S)RATIONAL
            c = "i" if dtype == 10 else "I"
            vals = struct.unpack(bo + c * (2 * n), raw[: 8 * n])
            out = [
                Fraction(vals[2 * i], vals[2 * i + 1]) if vals[2 * i + 1] else Fraction(0)
                for i in range(n)
            ]
            return out[0] if n == 1 else out
        vals = struct.unpack(bo + fmt * n, raw[: size * n])
        return vals[0] if n == 1 else list(vals)

    def _populate(self, p: TiffPage) -> None:
        t = p.tags

        def get(tag, default=None):
            return t.get(tag, default)

        p.width = int(get(TAG_IMAGE_WIDTH, 0))
        p.height = int(get(TAG_IMAGE_LENGTH, 0))
        p.compression = int(get(TAG_COMPRESSION, COMPRESSION_NONE))
        p.photometric = int(get(TAG_PHOTOMETRIC, 2))
        p.predictor = int(get(TAG_PREDICTOR, 1))
        # TIFF spec default for SamplesPerPixel is 1; infer 3 only when the
        # photometric interpretation says the page is chromatic (RGB/YCbCr).
        spp = get(TAG_SAMPLES_PER_PIXEL, 3 if p.photometric in (2, 6) else 1)
        p.samples = int(spp if not isinstance(spp, list) else spp[0])
        bits = get(TAG_BITS_PER_SAMPLE, 8)
        p.bits = int(bits[0] if isinstance(bits, list) else bits)
        p.description = str(get(TAG_IMAGE_DESCRIPTION, "") or "")
        jt = get(TAG_JPEG_TABLES)
        p.jpeg_tables = bytes(jt) if isinstance(jt, (bytes, bytearray)) else None
        if TAG_TILE_OFFSETS in t:
            p.is_tiled = True
            p.tile_width = int(get(TAG_TILE_WIDTH, 0))
            p.tile_height = int(get(TAG_TILE_LENGTH, 0))
            offs = get(TAG_TILE_OFFSETS)
            cnts = get(TAG_TILE_BYTE_COUNTS)
        else:
            p.is_tiled = False
            p.rows_per_strip = int(get(TAG_ROWS_PER_STRIP, p.height) or p.height)
            offs = get(TAG_STRIP_OFFSETS)
            cnts = get(TAG_STRIP_BYTE_COUNTS)
        if offs is not None:
            p.offsets = np.atleast_1d(np.asarray(offs, dtype=np.int64))
        if cnts is not None:
            p.bytecounts = np.atleast_1d(np.asarray(cnts, dtype=np.int64))

    # -- physical spacing -----------------------------------------------------
    def mpp(self) -> tuple[float, float] | None:
        """Micrometers-per-pixel of page 0, from resolution tags or SVS text.

        Mirrors the reference's fallback chain (reference: wsinsight/wsi.py:232-262):
        ResolutionUnit scale table inch=25400 / cm=10000 / mm=1000.
        """
        p = self.pages[0]
        # SVS-style description: "...|MPP = 0.25|..."
        desc = p.description
        if "MPP" in desc:
            for part in desc.replace("|", "\n").splitlines():
                if "MPP" in part and "=" in part:
                    try:
                        v = float(part.split("=", 1)[1].strip())
                        return (v, v)
                    except ValueError:
                        pass
        xres = p.tags.get(TAG_X_RESOLUTION)
        yres = p.tags.get(TAG_Y_RESOLUTION)
        unit = int(p.tags.get(TAG_RESOLUTION_UNIT, RESUNIT_NONE) or RESUNIT_NONE)
        scale = {RESUNIT_INCH: 25400.0, RESUNIT_CENTIMETER: 10000.0}.get(unit)
        if xres and yres and scale:
            try:
                return (scale / float(xres), scale / float(yres))
            except ZeroDivisionError:
                return None
        return None


# =================================================================================
# Writer
# =================================================================================


def _encode_tile(tile: np.ndarray, compression: str, jpeg_quality: int) -> bytes:
    if compression == "none":
        return tile.tobytes()
    if compression in ("deflate", "zlib"):
        return zlib.compress(tile.tobytes(), 6)
    if compression == "lzw":
        return lzw_encode(tile.tobytes())
    if compression == "jpeg":
        if not _HAS_CV2:  # pragma: no cover
            raise TiffError("cv2 required for jpeg compression")
        ok, enc = cv2.imencode(
            ".jpg", tile[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, jpeg_quality]
        )
        if not ok:
            raise TiffError("jpeg encode failed")
        return enc.tobytes()
    raise TiffError(f"unknown compression {compression!r}")


class TiffWriter:
    """Write tiled RGB (pyramidal) TIFFs.

    Each call to :meth:`write` appends one page. Pages are written sequentially;
    IFDs are chained in write order, which is how our reader (and tiffslide's
    generic-TIFF path) discovers pyramid levels.
    """

    def __init__(self, path: str | os.PathLike, bigtiff: bool = False):
        self._fh = open(path, "wb")
        self.bigtiff = bigtiff
        if bigtiff:
            self._fh.write(b"II" + struct.pack("<HHHQ", 43, 8, 0, 16))
        else:
            self._fh.write(b"II" + struct.pack("<HI", 42, 8))
        self._prev_ifd_link: int | None = None
        self._closed = False

    def write(
        self,
        image: np.ndarray,
        *,
        tile: tuple[int, int] | None = (256, 256),
        rows_per_strip: int = 64,
        compression: str = "deflate",
        jpeg_quality: int = 85,
        resolution: tuple[float, float] | None = None,  # pixels per resolution unit
        resolution_unit: int = RESUNIT_CENTIMETER,
        description: str | None = None,
    ) -> None:
        """Append a page. tile=None writes a stripped page instead of tiles."""
        image = np.ascontiguousarray(image, dtype=np.uint8)
        if image.ndim == 2:
            image = image[:, :, None].repeat(3, axis=2)
        h, w, c = image.shape
        fh = self._fh

        offsets: list[int] = []
        bytecounts: list[int] = []
        if tile is not None:
            th, tw = tile
            for y0 in range(0, h, th):
                for x0 in range(0, w, tw):
                    block = np.zeros((th, tw, c), np.uint8)
                    sub = image[y0 : y0 + th, x0 : x0 + tw]
                    block[: sub.shape[0], : sub.shape[1]] = sub
                    enc = _encode_tile(block, compression, jpeg_quality)
                    offsets.append(fh.tell())
                    bytecounts.append(len(enc))
                    fh.write(enc)
                    if len(enc) % 2:
                        fh.write(b"\x00")
        else:
            for y0 in range(0, h, rows_per_strip):
                strip = image[y0 : y0 + rows_per_strip]
                enc = _encode_tile(strip, compression, jpeg_quality)
                offsets.append(fh.tell())
                bytecounts.append(len(enc))
                fh.write(enc)
                if len(enc) % 2:
                    fh.write(b"\x00")

        comp_id = {
            "none": COMPRESSION_NONE,
            "deflate": COMPRESSION_DEFLATE_ADOBE,
            "zlib": COMPRESSION_DEFLATE_ADOBE,
            "lzw": COMPRESSION_LZW,
            "jpeg": COMPRESSION_JPEG,
        }[compression]

        entries: list[tuple[int, int, int, object]] = [
            (TAG_IMAGE_WIDTH, 4, 1, w),
            (TAG_IMAGE_LENGTH, 4, 1, h),
            (TAG_BITS_PER_SAMPLE, 3, c, [8] * c),
            (TAG_COMPRESSION, 3, 1, comp_id),
            (TAG_PHOTOMETRIC, 3, 1, 2),
            (TAG_SAMPLES_PER_PIXEL, 3, 1, c),
            (TAG_PLANAR_CONFIG, 3, 1, 1),
        ]
        if tile is not None:
            th, tw = tile
            entries += [
                (TAG_TILE_WIDTH, 3, 1, tw),
                (TAG_TILE_LENGTH, 3, 1, th),
                (TAG_TILE_OFFSETS, 16 if self.bigtiff else 4, len(offsets), offsets),
                (TAG_TILE_BYTE_COUNTS, 4, len(bytecounts), bytecounts),
            ]
        else:
            entries += [
                (TAG_ROWS_PER_STRIP, 3, 1, rows_per_strip),
                (TAG_STRIP_OFFSETS, 16 if self.bigtiff else 4, len(offsets), offsets),
                (TAG_STRIP_BYTE_COUNTS, 4, len(bytecounts), bytecounts),
            ]
        if description is not None:
            entries.append((TAG_IMAGE_DESCRIPTION, 2, len(description) + 1, description))
        if resolution is not None:
            entries.append((TAG_X_RESOLUTION, 5, 1, Fraction(resolution[0]).limit_denominator(10**9)))
            entries.append((TAG_Y_RESOLUTION, 5, 1, Fraction(resolution[1]).limit_denominator(10**9)))
            entries.append((TAG_RESOLUTION_UNIT, 3, 1, resolution_unit))
        entries.sort(key=lambda e: e[0])

        self._write_ifd(entries)

    # ------------------------------------------------------------------
    def _pack_value(self, dtype: int, n: int, value) -> bytes:
        if dtype == 2:  # ASCII
            raw = str(value).encode("utf-8") + b"\x00"
            return raw
        if dtype == 5:  # RATIONAL
            fr: Fraction = value if isinstance(value, Fraction) else Fraction(value)
            return struct.pack("<II", fr.numerator, fr.denominator)
        fmt = {3: "H", 4: "I", 16: "Q"}[dtype]
        vals = value if isinstance(value, (list, tuple)) else [value]
        return struct.pack("<" + fmt * len(vals), *[int(v) for v in vals])

    def _write_ifd(self, entries: Sequence[tuple[int, int, int, object]]) -> None:
        fh = self._fh
        inline_cap = 8 if self.bigtiff else 4
        # First pass: serialize values, write out-of-line data.
        packed: list[tuple[int, int, int, bytes, int | None]] = []
        for tag, dtype, n, value in entries:
            raw = self._pack_value(dtype, n, value)
            if dtype == 2:
                n = len(raw)
            if len(raw) <= inline_cap:
                packed.append((tag, dtype, n, raw.ljust(inline_cap, b"\x00"), None))
            else:
                if fh.tell() % 2:
                    fh.write(b"\x00")
                off = fh.tell()
                fh.write(raw)
                packed.append((tag, dtype, n, b"", off))

        if fh.tell() % 2:
            fh.write(b"\x00")
        ifd_offset = fh.tell()

        if self.bigtiff:
            fh.write(struct.pack("<Q", len(packed)))
            for tag, dtype, n, inline, off in packed:
                fh.write(struct.pack("<HHQ", tag, dtype, n))
                fh.write(inline if off is None else struct.pack("<Q", off))
            next_link_pos = fh.tell()
            fh.write(struct.pack("<Q", 0))
        else:
            fh.write(struct.pack("<H", len(packed)))
            for tag, dtype, n, inline, off in packed:
                fh.write(struct.pack("<HHI", tag, dtype, n))
                fh.write(inline if off is None else struct.pack("<I", off))
            next_link_pos = fh.tell()
            fh.write(struct.pack("<I", 0))

        # Link previous IFD (or header) to this one.
        end = fh.tell()
        link_pos = self._prev_ifd_link
        if link_pos is None:
            link_pos = 8 if self.bigtiff else 4
        fh.seek(link_pos)
        fh.write(struct.pack("<Q" if self.bigtiff else "<I", ifd_offset))
        fh.seek(end)
        self._prev_ifd_link = next_link_pos

    def close(self) -> None:
        if not self._closed:
            self._fh.close()
            self._closed = True

    def __enter__(self) -> "TiffWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_pyramidal_tiff(
    path: str | os.PathLike,
    image: np.ndarray,
    *,
    tile: tuple[int, int] = (256, 256),
    compression: str = "deflate",
    mpp: float | None = None,
    levels: int = 1,
    description: str | None = None,
) -> None:
    """Write `image` as a pyramidal tiled TIFF with `levels` power-of-two levels."""
    resolution = None
    if mpp is not None:
        ppcm = 10000.0 / mpp  # pixels per centimeter
        resolution = (ppcm, ppcm)
    with TiffWriter(path, bigtiff=image.nbytes > 2**31) as tw:
        level_img = image
        for lvl in range(levels):
            res = None
            if resolution is not None:
                res = (resolution[0] / (2**lvl), resolution[1] / (2**lvl))
            tw.write(
                level_img,
                tile=tile,
                compression=compression,
                resolution=res,
                description=description if lvl == 0 else None,
            )
            if lvl + 1 < levels:
                h, w = level_img.shape[:2]
                if _HAS_CV2:
                    level_img = cv2.resize(
                        level_img, (max(1, w // 2), max(1, h // 2)), interpolation=cv2.INTER_AREA
                    )
                else:  # pragma: no cover
                    level_img = level_img[::2, ::2]
