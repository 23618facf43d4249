"""Geometry and traversal helpers shared by the exporters.

A copy of wsinsight_tpu/writers/common.py: the port imports nothing of that package.

The shrink-box formula is an output-compatibility contract (reference:
wsinsight/write_geojson.py:85-106 and write_omecsv.py:128-142 use the same
math): GeoJSON and OME-CSV must describe IDENTICAL box geometry for the same
CSV row, so the formula lives in exactly one place.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd

from ..uri_path import URIPath


def shrunk_boxes(
    df: pd.DataFrame, overlap: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Patch boxes shrunk by `overlap`, centered: (minx, miny, maxx, maxy).

    The kept extent is rint(size * (1 - overlap)) and the leftover margin is
    split evenly (rint again), so a 0-overlap grid round-trips exactly.
    """
    cols = df[["minx", "miny", "width", "height"]].to_numpy(np.int64, copy=False)
    origin, size = cols[:, :2], cols[:, 2:]

    kept = np.rint(size * (1.0 - overlap)).astype(np.int64)
    lo = origin + np.rint((size - kept) * 0.5).astype(np.int64)
    hi = lo + kept
    return lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1]


def iter_files(path, *, suffix: Optional[str] = None):
    """Yield the files directly inside `path` (URIPath- and Path-compatible),
    optionally filtered by suffix."""
    children = (
        path.iterdir(files_only=True)
        if isinstance(path, URIPath)
        else filter(lambda c: c.is_file(), path.iterdir())
    )
    yield from (c for c in children if suffix in (None, c.suffix))
