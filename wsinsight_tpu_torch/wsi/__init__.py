"""Slide I/O: backend selection, MPP resolution, directory validation.

Same public surface as the reference (reference: wsinsight/wsi.py:53-314):
``set_backend``, ``get_wsi_cls``, ``get_avg_mpp``, ``_validate_wsi_directory``,
``CanReadRegion``. The default backend is the in-house ``tpu`` reader
(:class:`wsinsight_tpu_torch.wsi.slide.TpuSlide`); ``tiffslide``/``openslide`` are
accepted and used when installed.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Protocol

from PIL import Image

from ..errors import (
    BackendNotAvailable,
    CannotReadSpacing,
    DuplicateFilePrefixesFound,
)
from .slide import PROPERTY_NAME_MPP_X, PROPERTY_NAME_MPP_Y, TpuSlide
from .tiff import TiffFile

logger = logging.getLogger(__name__)

_BACKEND = "tpu"
_allowed_backends = {"tpu", "tiffslide", "openslide"}

try:  # optional third-party backends
    import tiffslide  # type: ignore

    HAS_TIFFSLIDE = True
except Exception:
    HAS_TIFFSLIDE = False

try:
    import openslide  # type: ignore

    openslide.OpenSlide  # noqa: B018
    HAS_OPENSLIDE = True
except Exception:
    HAS_OPENSLIDE = False


def set_backend(name: str) -> None:
    """Select the active slide backend ('tpu', 'tiffslide', or 'openslide')."""
    global _BACKEND
    if name not in _allowed_backends:
        raise ValueError(f"Unknown backend: '{name}'")
    if name == "tiffslide" and not HAS_TIFFSLIDE:
        raise BackendNotAvailable("TiffSlide is not available. Please install 'tiffslide'.")
    if name == "openslide" and not HAS_OPENSLIDE:
        raise BackendNotAvailable(
            "OpenSlide is not available. Please install the OpenSlide library and"
            " the 'openslide-python' package."
        )
    logger.debug(f"Set backend to {name}")
    _BACKEND = name


def get_backend() -> str:
    return _BACKEND


def get_wsi_cls() -> type:
    """Return the reader class for the active backend."""
    if _BACKEND == "tpu":
        return TpuSlide
    if _BACKEND == "tiffslide":
        return tiffslide.TiffSlide  # type: ignore[name-defined]
    if _BACKEND == "openslide":
        return openslide.OpenSlide  # type: ignore[name-defined]
    raise ValueError(f"Unknown backend: '{_BACKEND}'")


class CanReadRegion(Protocol):
    """Anything exposing openslide-style ``read_region`` returning PIL."""

    def read_region(
        self, location: tuple[int, int], level: int, size: tuple[int, int]
    ) -> Image.Image: ...


def _get_mpp_tpu(slide_path) -> tuple[float, float]:
    slide = TpuSlide(slide_path)
    try:
        if PROPERTY_NAME_MPP_X in slide.properties:
            return (
                float(slide.properties[PROPERTY_NAME_MPP_X]),  # type: ignore[arg-type]
                float(slide.properties[PROPERTY_NAME_MPP_Y]),  # type: ignore[arg-type]
            )
    finally:
        slide.close()
    raise CannotReadSpacing(str(slide_path))


def _get_mpp_tiffslide(slide_path) -> tuple[float, float]:
    slide = tiffslide.TiffSlide(slide_path)  # type: ignore[name-defined]
    try:
        mppx = slide.properties.get(tiffslide.PROPERTY_NAME_MPP_X)  # type: ignore[name-defined]
        mppy = slide.properties.get(tiffslide.PROPERTY_NAME_MPP_Y)  # type: ignore[name-defined]
    finally:
        slide.close()
    if mppx is None or mppy is None:
        raise CannotReadSpacing(str(slide_path))
    return float(mppx), float(mppy)


def _get_mpp_openslide(slide_path) -> tuple[float, float]:
    slide = openslide.OpenSlide(slide_path)  # type: ignore[name-defined]
    try:
        props = slide.properties
        mppx = props.get(openslide.PROPERTY_NAME_MPP_X)  # type: ignore[name-defined]
        mppy = props.get(openslide.PROPERTY_NAME_MPP_Y)  # type: ignore[name-defined]
    finally:
        slide.close()
    if mppx is not None and mppy is not None:
        return float(mppx), float(mppy)
    raise CannotReadSpacing(str(slide_path))


def get_avg_mpp(slide_path) -> float:
    """Average of X/Y microns-per-pixel (reference: wsinsight/wsi.py:265-302).

    Tries the active backend first, then falls back to raw TIFF tag parsing
    (the reference's tifffile fallback, wsinsight/wsi.py:232-262).
    """
    local = getattr(slide_path, "materialize", None)
    path = local() if callable(local) else slide_path
    readers = {
        "tpu": _get_mpp_tpu,
        "tiffslide": _get_mpp_tiffslide if HAS_TIFFSLIDE else None,
        "openslide": _get_mpp_openslide if HAS_OPENSLIDE else None,
    }
    fn = readers.get(_BACKEND)
    if fn is not None:
        try:
            mppx, mppy = fn(path)
            return (mppx + mppy) / 2
        except CannotReadSpacing:
            pass
    # Last resort: raw tag parse.
    try:
        with TiffFile(path) as tf:
            mpp = tf.mpp()
            if mpp is not None:
                return (mpp[0] + mpp[1]) / 2
    except Exception:
        pass
    raise CannotReadSpacing(str(slide_path))


def _validate_wsi_directory(wsi_dir) -> None:
    """Slide stems must be unique (reference: wsinsight/wsi.py:305-314)."""
    from ..uri_path import URIPath

    wsi_dir = URIPath(wsi_dir)
    maybe_slides = [p for p in wsi_dir.iterdir() if p.is_file()]
    uniq_stems = set(p.stem for p in maybe_slides)
    if len(uniq_stems) != len(maybe_slides):
        raise DuplicateFilePrefixesFound(
            "A slide with the same prefix but different extensions has been found"
            " (like slide.svs and slide.tif). Slides must have unique prefixes."
        )
