"""Marker-based watershed on the host library, with its plain Python version.

Counterpart of wsinsight_tpu/ops/watershed.py. Semantics match
skimage.segmentation.watershed(image, markers, mask=...) with connectivity=1
(the call the reference's stitcher makes, reference:
wsinsight/modellib/tilefuse.py:102). ``watershed`` runs ``native/watershed.cpp``
and raises where the host library cannot be built or loaded; unlike the JAX
package it never falls back to ``_watershed_python``, which stays as the
plain version the tests hold the native one to.
"""

from __future__ import annotations

import heapq
import itertools

import numpy as np

from ..native import watershed_native


def watershed(
    image: np.ndarray, markers: np.ndarray, mask: np.ndarray | None = None
) -> np.ndarray:
    """Priority-flood watershed. image float, markers int labels, bool mask."""
    image = np.asarray(image, np.float32)
    markers = np.asarray(markers, np.int32)
    mask_u8 = None if mask is None else np.asarray(mask, bool).astype(np.uint8)
    return watershed_native(image, markers, mask_u8)


def _watershed_python(
    image: np.ndarray, markers: np.ndarray, mask: np.ndarray | None
) -> np.ndarray:
    h, w = image.shape
    out = np.where(markers > 0, markers, 0).astype(np.int32)
    if mask is not None:
        out[mask == 0] = 0
    counter = itertools.count()
    heap: list[tuple[float, int, int, int]] = []
    seeds = np.argwhere(out > 0)
    for r, c in seeds:
        heapq.heappush(heap, (float(image[r, c]), next(counter), r * w + c, int(out[r, c])))
    while heap:
        _, _, idx, label = heapq.heappop(heap)
        r, c = divmod(idx, w)
        for rr, cc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
            if rr < 0 or rr >= h or cc < 0 or cc >= w:
                continue
            if mask is not None and mask[rr, cc] == 0:
                continue
            if out[rr, cc] != 0:
                continue
            out[rr, cc] = label
            heapq.heappush(heap, (float(image[rr, cc]), next(counter), rr * w + cc, label))
    return out


def remove_small_labels(labels: np.ndarray, min_size: int) -> np.ndarray:
    """Zero out labels with pixel count < min_size (skimage remove_small_objects
    on a label image)."""
    if min_size <= 1:
        return labels
    counts = np.bincount(labels.ravel())
    small = counts < min_size
    small[0] = False
    out = labels.copy()
    out[small[labels]] = 0
    return out
