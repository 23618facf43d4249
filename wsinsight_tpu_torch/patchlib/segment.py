"""Tissue segmentation on slide thumbnails.

Behavioral re-creation of the reference segmentation (reference:
wsinsight/patchlib/segment.py:13-97): RGB -> HSV, keep the saturation channel,
median blur, fixed binary threshold, morphological closing, small-object removal,
small-hole filling. Runs on the 2048^2 thumbnail on host CPU — this stage is not
a device bottleneck; the device work starts at the patch forward pass.
"""

from __future__ import annotations

import cv2 as cv
import numpy as np
import numpy.typing as npt

from .morphology import binary_closing, remove_small_holes, remove_small_objects


def segment_tissue(
    im_arr: npt.NDArray,
    median_filter_size: int = 7,
    binary_threshold: int = 7,
    closing_kernel_size: int = 6,
    min_object_size_px: int = 512,
    min_hole_size_px: int = 1024,
) -> npt.NDArray[np.bool_]:
    """Create a boolean tissue mask from an RGB thumbnail array."""
    rgb = np.asarray(im_arr)
    if rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"expected an (H, W, 3) RGB array, got shape {rgb.shape}")
    if median_filter_size % 2 == 0 or median_filter_size <= 1:
        raise ValueError(
            f"median_filter_size must be odd and > 1 (got {median_filter_size})"
        )

    # Saturation separates stained tissue from the near-grey glass background.
    saturation = cv.cvtColor(rgb, cv.COLOR_RGB2HSV)[..., 1]
    denoised = cv.medianBlur(saturation, median_filter_size)
    mask = denoised > binary_threshold

    footprint = np.ones((closing_kernel_size,) * 2, bool)
    mask = binary_closing(mask, footprint)
    mask = remove_small_objects(mask, min_size=min_object_size_px)
    return remove_small_holes(mask, area_threshold=min_hole_size_px)
