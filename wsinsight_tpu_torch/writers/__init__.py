"""Artifact writers: GeoJSON, OME-CSV, QuPath projects, WKT helpers.

A copy of wsinsight_tpu/writers/__init__.py: the port imports nothing of that package.
"""

from .geojson import write_geojsons
from .omecsv import write_omecsvs
from .qupath import make_qupath_project

__all__ = ["write_geojsons", "write_omecsvs", "make_qupath_project"]
