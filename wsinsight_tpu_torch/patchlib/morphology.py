"""Binary morphology helpers (scikit-image-free).

Implements the three skimage operations the reference's tissue segmentation uses
(reference: wsinsight/patchlib/segment.py:87-95) on top of scipy.ndimage, with
matching semantics:

* ``binary_closing`` — dilation (border_value=0) then erosion (border_value=1),
  skimage's border convention.
* ``remove_small_objects`` — drop 4-connected components with area < min_size
  (strict, like skimage).
* ``remove_small_holes`` — fill 4-connected background components with
  area <= area_threshold.
"""

from __future__ import annotations

import numpy as np
import numpy.typing as npt
from scipy import ndimage as ndi

_STRUCT4 = ndi.generate_binary_structure(2, 1)  # 4-connectivity


def binary_closing(image: npt.NDArray[np.bool_], footprint: np.ndarray) -> npt.NDArray[np.bool_]:
    dilated = ndi.binary_dilation(image, structure=footprint, border_value=0)
    return ndi.binary_erosion(dilated, structure=footprint, border_value=1)


def remove_small_objects(
    image: npt.NDArray[np.bool_], min_size: int
) -> npt.NDArray[np.bool_]:
    if min_size <= 1:
        return image.copy()
    labels, n = ndi.label(image, structure=_STRUCT4)
    if n == 0:
        return image.copy()
    sizes = np.bincount(labels.ravel())
    keep = sizes >= min_size
    keep[0] = False
    return keep[labels]


def remove_small_holes(
    image: npt.NDArray[np.bool_], area_threshold: int
) -> npt.NDArray[np.bool_]:
    inverted = ~image
    labels, n = ndi.label(inverted, structure=_STRUCT4)
    if n == 0:
        return image.copy()
    sizes = np.bincount(labels.ravel())
    # Holes with area <= area_threshold get filled (skimage: min_size = thr + 1).
    small = sizes <= area_threshold
    small[0] = False
    return image | small[labels]
