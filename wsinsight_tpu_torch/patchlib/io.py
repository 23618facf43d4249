"""Patch extraction and HDF5 persistence.

The HDF5 *layout* is a resume/compat contract preserved bit-for-bit from the
reference (reference: wsinsight/patchlib/io.py:51-143); the code here is our
own:

* ``/slide`` group attrs: slide_path, slide_mpp, slide_width, slide_height
* ``/coords`` (N,2) int32 gzip; attrs patch_size, patch_level=0,
  patch_spacing_um_px, tile_dim
* optional ``/images`` (N,H,W,C) uint8
* optional ``/polygons`` ragged group: coords (K,2) float32 + offsets (M+1,)
  int64, attrs layout="ragged_offsets".

``h5py`` is imported inside the functions that read or write a patch file, so
the module imports where h5py is not installed.
"""

from __future__ import annotations

import logging
from collections.abc import Sequence

import cv2
import numpy as np
import numpy.typing as npt
from PIL import Image

from ..uri_path import URIPath

logger = logging.getLogger(__name__)


def _as_coords_array(coords) -> npt.NDArray[np.int32]:
    """Validate and coerce patch coordinates to an (N, 2) int32 array."""
    arr = np.asarray(coords, dtype=np.int32)
    if arr.ndim != 2:
        raise ValueError(f"coords must have 2 dimensions but got {arr.ndim}")
    if arr.shape[1] != 2:
        raise ValueError(
            f"length of coords second axis must be 2 but got {arr.shape[1]}"
        )
    return arr


def extract_patches_from_slide(
    slide, coords: npt.NDArray[np.int_], patch_size: int
) -> npt.NDArray[np.uint8]:
    """Extract level-0 RGB patches at the given top-left coordinates.

    Our in-house TIFF reader exposes ``read_region_array`` (numpy out, no PIL
    round-trip); foreign readers fall back to the PIL ``read_region``
    protocol of wsi/__init__.py.
    """
    coords = _as_coords_array(coords)
    shape = (len(coords), patch_size, patch_size, 3)
    out = np.empty(shape, dtype=np.uint8)

    fast = getattr(slide, "read_region_array", None)
    if fast is not None:
        for dst, (x, y) in zip(out, coords):
            dst[...] = fast((int(x), int(y)), 0, (patch_size, patch_size))
        return out

    for dst, (x, y) in zip(out, coords):
        tile = slide.read_region(
            location=(int(x), int(y)), level=0, size=(patch_size, patch_size)
        )
        dst[...] = np.asarray(tile.convert("RGB") if tile.mode != "RGB" else tile)
    return out


def write_polygons_group(
    f: h5py.File, polygons: list[np.ndarray], compression: str | None
) -> None:
    """(Re)write the ragged /polygons group (schema above)."""
    counts = np.fromiter((len(p) for p in polygons), dtype=np.int64, count=len(polygons))
    offsets = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    flat = np.zeros((offsets[-1], 2), np.float32)
    for p, lo, hi in zip(polygons, offsets[:-1], offsets[1:]):
        flat[lo:hi] = np.asarray(p, dtype=np.float32)

    if "/polygons" in f:
        del f["/polygons"]
    group = f.create_group("/polygons")
    group.attrs["layout"] = "ragged_offsets"
    ds = group.create_dataset(
        "coords", data=flat, dtype="float32",
        compression=compression, shuffle=True, chunks=True,
    )
    ds.attrs["columns"] = np.array(["x", "y"], dtype="S1")
    group.create_dataset("offsets", data=offsets, dtype="int64")


def save_hdf5(  # noqa: PLR0913 — kwargs mirror the on-disk schema
    path: str | URIPath,
    coords: npt.NDArray[np.int_], polygons: list[np.ndarray] | None,
    tile_dim: npt.NDArray[np.int_] | None,
    patch_size: int, patch_spacing_um_px: float,
    compression: str | None = "gzip", images: npt.NDArray[np.uint8] | None = None,
    images_compression: str | None = "lzf",
    slide_path: str | None = None, slide_mpp: float | None = None,
    slide_width: float | None = None, slide_height: float | None = None,
) -> None:
    """Write patch coordinates (+ optional polygons and images) to HDF5."""
    import h5py

    logger.info("Writing coordinates to disk: %s", path)
    coords = _as_coords_array(coords)
    if tile_dim is not None and tuple(np.shape(tile_dim)) != (2,):
        raise ValueError(f"tile_dim must be (2,) but got {np.shape(tile_dim)}")
    if images is not None:
        images = np.asarray(images, dtype=np.uint8)
        if len(images) != len(coords):
            raise ValueError(
                f"images/coords length mismatch: {len(images)} vs {len(coords)}"
            )

    # str-valued attrs use the utf-8 vlen dtype; numeric ones write natively.
    slide_attrs = {
        "slide_mpp": slide_mpp,
        "slide_width": slide_width,
        "slide_height": slide_height,
    }

    with URIPath(path).open("w+b") as fh, h5py.File(fh, "w") as f:
        slide_group = f.create_group("slide")
        if slide_path is not None:
            slide_group.attrs.create(
                "slide_path", slide_path, dtype=h5py.string_dtype(encoding="utf-8")
            )
        for key, value in slide_attrs.items():
            if value is not None:
                slide_group.attrs[key] = value

        ds = f.create_dataset("/coords", data=coords, compression=compression)
        ds.attrs.update(
            patch_size=patch_size,
            patch_level=0,
            patch_spacing_um_px=patch_spacing_um_px,
        )
        if tile_dim is not None:
            ds.attrs["tile_dim"] = np.asarray(tile_dim, dtype=np.int32)

        if images is not None:
            # The image cache exists to make inference input decode-free, so
            # it gets h5py's fast lzf codec (decompresses several-hundred
            # MB/s/thread) rather than the coords' gzip — gzip inflate of raw
            # uint8 patches is slower than the JPEG decode the cache is meant
            # to replace. One patch per chunk: h5py's auto-chunking
            # (chunks=True) splits both the patch axis and the spatial axes,
            # so a single-patch read decompresses many multi-patch chunks —
            # measured 13.7 patches/s cache-read ceiling on the bench host
            # vs the several-hundred/s this codec should deliver. Schema is
            # unchanged: /images (N,H,W,C) uint8, same as reference
            # wsinsight/patchlib (any h5py reader sees identical arrays).
            f.create_dataset(
                "/images",
                data=images,
                compression=images_compression,
                chunks=(1,) + tuple(images.shape[1:]),
            )

        if polygons:
            write_polygons_group(f, list(polygons), compression)


def draw_contours_on_thumbnail(
    thumb: Image.Image,
    contours: Sequence[npt.NDArray[np.int_]],
    hierarchy: npt.NDArray[np.int_],
) -> "Image.Image":
    """Paint tissue outlines on the thumbnail: external contours cyan, holes
    yellow, 7-px stroke (the mask-jpg convention of reference io.py:146-166).

    ``hierarchy`` is cv2.findContours RETR_CCOMP output, shape (1, N, 4);
    column 3 is the parent index (-1 marks an outer contour).
    """
    if hierarchy.shape[:1] + hierarchy.shape[2:] != (1, 4) or len(contours) != hierarchy.shape[1]:
        raise ValueError(
            f"expected (1, {len(contours)}, 4) RETR_CCOMP hierarchy, got {hierarchy.shape}"
        )

    is_outer = hierarchy[0, :, 3] < 0
    canvas = np.array(thumb)
    for color, keep in (((0, 255, 255), is_outer), ((255, 255, 0), ~is_outer)):
        subset = [c for c, k in zip(contours, keep) if k]
        cv2.drawContours(canvas, subset, -1, color, 7)
    return Image.fromarray(canvas).convert("RGB")
