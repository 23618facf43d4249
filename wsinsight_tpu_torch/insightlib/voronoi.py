"""Capped-Voronoi CME region merging (annotation-level outputs).

A copy of wsinsight_tpu/insightlib/voronoi.py (host numpy/cv2), its WKT
from the port's ``writers.wkt``.

Re-creation of the reference's region builder (reference:
wsinsight/insightlib/vorononi_cme_region_helper.py:89-650): per-cell Voronoi
regions capped by a disk of max_radius_um, same-label neighbors merged via
Delaunay edges, serialized as WKT rows with one-hot cme_* columns and area.

Shapely/GEOS is not a dependency. The default path is the EXACT polygon
construction in voronoi_exact.py (finite-ified scipy Voronoi cells clipped
by a 64-gon disk, union by split-and-cancel of shared edges — matching the
reference's shapely buffer/union semantics). A raster fallback remains for
degenerate diagrams (and via WSINSIGHT_VORONOI_METHOD=raster): per merged
component, nearest-cell assignment via a distance transform over a working
grid, capped at max_radius, contour-traced back to slide coordinates.
Output schema matches the reference (vorononi_cme_region_helper.py:602-650):
cme_0..cme_{K-1}, polygon_wkt, area.
"""

from __future__ import annotations

import logging
import os
from typing import List, Tuple

import cv2
import numpy as np
import pandas as pd

from ..writers.wkt import polygon_wkt
from .helpers import compute_cell_center_points

logger = logging.getLogger(__name__)


def remap_edges_to_valid_indices(edges_df: pd.DataFrame, valid_mask: np.ndarray) -> pd.DataFrame:
    """Keep edges whose endpoints are both valid; remap to compacted indices
    (reference: vorononi_cme_region_helper.py:221-233)."""
    remap = -np.ones(len(valid_mask), np.int64)
    remap[valid_mask] = np.arange(valid_mask.sum())
    src = edges_df["source"].to_numpy(np.int64)
    dst = edges_df["target"].to_numpy(np.int64)
    keep = valid_mask[src] & valid_mask[dst]
    return pd.DataFrame(
        {
            "source": remap[src[keep]],
            "target": remap[dst[keep]],
            "length": edges_df["length"].to_numpy()[keep],
        }
    )


def _union_find_components(n: int, edges: List[Tuple[int, int]]) -> List[List[int]]:
    parent = np.arange(n)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in edges:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra
    groups: dict[int, list[int]] = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    return list(groups.values())


def merge_same_label_by_shared_edges_iterative(
    cme_detection_df: pd.DataFrame,
    edges_df: pd.DataFrame,
    cme_clustering_k: int,
    mpp: float,
    max_radius_um: float,
    raster_um_per_px: float = 2.0,
    method: str | None = None,
    kept_idx: np.ndarray | None = None,
) -> pd.DataFrame:
    """Merge same-label capped-Voronoi cells into region polygons.

    method: "exact" (default; polygon construction, voronoi_exact.py) or
    "raster"; also settable via WSINSIGHT_VORONOI_METHOD. Exact falls back
    to raster when the construction fails (logged).

    kept_idx: when given, the caller's kept-cell positions — the SAME index
    space its edges_df uses. Deriving it from the cme_ columns only works
    when the cell CSV was written by the same run; a stale/resumed CSV would
    silently misalign labels with edges.
    Returns DataFrame[cme_0..cme_{K-1}, polygon_wkt, area] (area in slide px^2).
    """
    cme_cols = [c for c in cme_detection_df.columns if c.startswith("cme_")]
    if not cme_cols:
        raise ValueError("No columns start with 'cme_'.")
    df = compute_cell_center_points(cme_detection_df.copy())
    cme_mat = df[cme_cols].to_numpy(float)
    cme_mat = np.nan_to_num(cme_mat, nan=0.0)
    labels_full = cme_mat.argmax(axis=1)

    centers = df[["center_x", "center_y"]].to_numpy(np.float64)
    if kept_idx is not None:
        valid_idx = np.asarray(kept_idx, np.int64)
    else:
        valid_idx = np.flatnonzero(cme_mat.sum(axis=1) > 0)
    if valid_idx.size == 0:
        return pd.DataFrame(columns=[f"cme_{i}" for i in range(cme_clustering_k)] + ["polygon_wkt", "area"])

    # Union-find over Delaunay edges between same-label valid cells. The edges
    # frame is in kept-index space == positions within valid_idx.
    kept_centers = centers[valid_idx]
    kept_labels = labels_full[valid_idx]
    n_kept = len(valid_idx)
    merge_edges = []
    if len(edges_df):
        src = edges_df["source"].to_numpy(np.int64)
        dst = edges_df["target"].to_numpy(np.int64)
        same = kept_labels[src] == kept_labels[dst]
        merge_edges = list(zip(src[same].tolist(), dst[same].tolist()))
    components = _union_find_components(n_kept, merge_edges)

    scale = raster_um_per_px / mpp  # slide px per raster px
    max_radius_px = max_radius_um / mpp
    pad = max_radius_px + 2 * scale

    out_cme_cols = [f"cme_{i}" for i in range(cme_clustering_k)]

    method = (method or os.getenv("WSINSIGHT_VORONOI_METHOD", "exact")).lower()
    if method not in ("exact", "raster"):
        raise ValueError(f"unknown Voronoi method {method!r} (use 'exact' or 'raster')")
    capped_cells = None
    if method == "exact":
        try:
            from .voronoi_exact import capped_voronoi_cells

            capped_cells = capped_voronoi_cells(kept_centers, max_radius_px)
        except Exception as err:
            # The half-plane construction has no degenerate-geometry failure
            # modes, so anything here is unexpected — degrade to raster but
            # say so (outputs change resolution).
            logger.warning(f"exact Voronoi failed ({err!r}); using the raster fallback")
            capped_cells = None

    if capped_cells is not None:
        from .voronoi_exact import ring_area, union_cells

        rows = []
        for comp in components:
            comp = np.asarray(comp)
            label = int(kept_labels[comp[0]])
            polys = [capped_cells[i] for i in comp if capped_cells[i] is not None]
            if not polys:
                continue
            one_hot = np.zeros(cme_clustering_k, np.float32)
            if 0 <= label < cme_clustering_k:
                one_hot[label] = 1.0
            for ring in union_cells(polys):
                area = ring_area(ring)
                if area <= 0:  # CW = hole; exterior rings only (see module doc)
                    continue
                row = {name: float(v) for name, v in zip(out_cme_cols, one_hot)}
                row["polygon_wkt"] = polygon_wkt([ring])
                row["area"] = float(area)
                rows.append(row)
        return pd.DataFrame(rows, columns=out_cme_cols + ["polygon_wkt", "area"])

    rows = []
    for comp in components:
        comp = np.asarray(comp)
        label = int(kept_labels[comp[0]])
        pts = kept_centers[comp]
        x0 = pts[:, 0].min() - pad
        y0 = pts[:, 1].min() - pad
        x1 = pts[:, 0].max() + pad
        y1 = pts[:, 1].max() + pad
        comp_scale = scale
        w = int(np.ceil((x1 - x0) / comp_scale)) + 1
        h = int(np.ceil((y1 - y0) / comp_scale)) + 1
        if w <= 1 or h <= 1:
            continue
        # A giant component must not silently vanish: coarsen its raster
        # until the working grid fits, and say so.
        while w * h > 64_000_000:
            comp_scale *= 2.0
            w = int(np.ceil((x1 - x0) / comp_scale)) + 1
            h = int(np.ceil((y1 - y0) / comp_scale)) + 1
        if comp_scale != scale:
            logger.warning(
                f"raster Voronoi component of {len(comp)} cells exceeds the"
                f" 64 Mpx grid; coarsened to {comp_scale * mpp:.2f} um/px"
            )
        scale_local = comp_scale

        # Seeds: ALL valid cells inside the bbox (the Voronoi partition is
        # against every cell, not only the component's).
        in_bbox = (
            (kept_centers[:, 0] >= x0)
            & (kept_centers[:, 0] <= x1)
            & (kept_centers[:, 1] >= y0)
            & (kept_centers[:, 1] <= y1)
        )
        bbox_idx = np.flatnonzero(in_bbox)
        seed_img = np.full((h, w), 255, np.uint8)
        sx = np.clip(((kept_centers[bbox_idx, 0] - x0) / scale_local).astype(int), 0, w - 1)
        sy = np.clip(((kept_centers[bbox_idx, 1] - y0) / scale_local).astype(int), 0, h - 1)
        seed_img[sy, sx] = 0
        dist, lab = cv2.distanceTransformWithLabels(
            seed_img, cv2.DIST_L2, 5, labelType=cv2.DIST_LABEL_PIXEL
        )
        # Map distance-transform pixel labels back to cell ids.
        seed_label_at = lab[sy, sx]
        label_to_cell = np.zeros(int(lab.max()) + 1, np.int64)
        label_to_cell[seed_label_at] = bbox_idx
        nearest_cell = label_to_cell[lab]

        comp_set = np.zeros(n_kept, bool)
        comp_set[comp] = True
        mask = comp_set[nearest_cell] & (dist * scale_local <= max_radius_px)
        mask_u8 = mask.astype(np.uint8)
        if mask_u8.sum() == 0:
            continue
        contours, _ = cv2.findContours(mask_u8, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        one_hot = np.zeros(cme_clustering_k, np.float32)
        if 0 <= label < cme_clustering_k:
            one_hot[label] = 1.0
        for cnt in contours:
            poly = cnt.squeeze(1).astype(np.float64)
            if poly.ndim != 2 or poly.shape[0] < 3:
                continue
            poly_slide = poly * scale_local + np.array([x0, y0])
            area = float(cv2.contourArea(cnt)) * scale_local * scale_local
            row = {name: float(v) for name, v in zip(out_cme_cols, one_hot)}
            row["polygon_wkt"] = polygon_wkt([poly_slide])
            row["area"] = area
            rows.append(row)

    return pd.DataFrame(rows, columns=out_cme_cols + ["polygon_wkt", "area"])
