"""Patch planning: tissue segmentation, grid geometry, HDF5 persistence.

Public surface mirrors the reference (reference: wsinsight/patchlib/__init__.py:5-21).
"""

from .io import draw_contours_on_thumbnail, extract_patches_from_slide, save_hdf5
from .patch import (
    get_multipolygon_from_binary_arr,
    get_object_coordinates_within_polygon,
    get_patch_coordinates_within_polygon,
)
from .pipeline import (
    PatchPlan,
    plan_slide,
    segment_and_patch_directory_of_slides,
    segment_and_patch_one_slide,
)
from .segment import segment_tissue

__all__ = [
    "draw_contours_on_thumbnail",
    "extract_patches_from_slide",
    "save_hdf5",
    "get_multipolygon_from_binary_arr",
    "get_object_coordinates_within_polygon",
    "get_patch_coordinates_within_polygon",
    "PatchPlan",
    "plan_slide",
    "segment_and_patch_directory_of_slides",
    "segment_and_patch_one_slide",
    "segment_tissue",
]
