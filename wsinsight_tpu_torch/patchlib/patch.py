"""Patch-grid planning from binary tissue masks.

Re-creation of the reference geometry stage (reference:
wsinsight/patchlib/patch.py:35-242) on the in-house geometry engine
(:mod:`wsinsight_tpu_torch.geometry`) instead of shapely. Contracts preserved:

* ``step_size = round((1 - overlap) * patch_size)``,
* centroids at ``half_patch_size + k*step`` over [0, slide_dim),
* keep a patch iff its centroid is STRICTLY inside the tissue multipolygon,
* output rows sorted with x ascending and y changing most rapidly,
* returned coordinates are top-left corners (centroid - half_patch_size).
"""

from __future__ import annotations

import logging
from typing import Sequence

import cv2 as cv
import numpy as np
import numpy.typing as npt

from ..geometry import MultiPolygon, rings_from_contours

logger = logging.getLogger(__name__)


def get_multipolygon_from_binary_arr(
    arr: npt.NDArray[np.uint8], scale: tuple[float, float] | None = None
) -> tuple[MultiPolygon, Sequence[npt.NDArray[np.int_]], npt.NDArray[np.int_]] | None:
    """Build a tissue MultiPolygon from a binary array via cv2 contours.

    Returns (multipolygon, unscaled contours, hierarchy) like the reference
    (reference: patch.py:35-130). The union/difference recursion over the
    RETR_CCOMP hierarchy is replaced by an equivalent even-odd ring set.
    """
    contours, hierarchy = cv.findContours(arr, cv.RETR_CCOMP, cv.CHAIN_APPROX_SIMPLE)
    if hierarchy is None:
        return None
    logger.info(f"Detected {len(contours)} contours")

    rings = rings_from_contours(contours, scale=scale)
    polygon = MultiPolygon(rings)
    return polygon, contours, hierarchy


def get_patch_coordinates_within_polygon(
    slide_width: int,
    slide_height: int,
    patch_size: int,
    half_patch_size: int,
    polygon: MultiPolygon,
    overlap: float = 0.0,
) -> npt.NDArray[np.int_]:
    """Top-left coordinates of grid patches whose centroids fall in tissue.

    Matches the reference grid math exactly (reference: patch.py:174-242).
    """
    if overlap >= 1:
        raise ValueError(f"overlap must be in (-inf, 1) but got {overlap}")

    step_size = round((1 - overlap) * patch_size)
    if step_size < 1:
        # overlap ~1 (e.g. a sub-pixel --patch-size-px) would make np.arange
        # raise ZeroDivisionError per slide, swallowed by the per-slide guard
        # into a misleading "no patches created" message
        raise ValueError(
            f"patch step rounds to {step_size} px (patch_size={patch_size},"
            f" overlap={overlap:.6f}); increase the patch size or reduce overlap"
        )
    logger.info(f"Patches are {patch_size} px, with step size of {step_size} px.")

    xs = np.arange(half_patch_size, slide_width, step_size, dtype=np.int64)
    ys = np.arange(half_patch_size, slide_height, step_size, dtype=np.int64)

    inside = polygon.contains_grid(xs.astype(np.float64), ys.astype(np.float64))

    # Reference ordering: centroids produced by product(x-range, y-range) then
    # index-sorted -> x ascending, y most-rapidly-changing.
    gx, gy = np.meshgrid(xs, ys, indexing="ij")  # (len(xs), len(ys))
    keep = inside.T  # transpose to (x, y)
    centroids = np.stack([gx[keep], gy[keep]], axis=1)
    return (centroids - half_patch_size).astype(np.int64)


def get_object_coordinates_within_polygon(
    object_centroids_arr: npt.NDArray[np.int_],
    half_patch_size: int,
    polygon: MultiPolygon,
) -> npt.NDArray[np.int_]:
    """Top-left coordinates for arbitrary object centroids inside tissue.

    Matches reference: patch.py:133-171 (order of appearance preserved, which is
    what the index-sort yields for an already-ordered centroid list).
    """
    object_centroids_arr = np.asarray(object_centroids_arr)
    inside = polygon.contains_points(object_centroids_arr.astype(np.float64))
    kept = object_centroids_arr[inside]
    return kept - half_patch_size
