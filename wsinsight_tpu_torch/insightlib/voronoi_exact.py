"""Exact capped-Voronoi construction and same-label region union.

A copy of wsinsight_tpu/insightlib/voronoi_exact.py (host numpy/scipy).

Geometry core for the CME region outputs (reference:
wsinsight/insightlib/vorononi_cme_region_helper.py:89-192,530-596). The
reference builds per-cell Voronoi polygons with shapely, caps each with
``Point.buffer(radius)`` (a polygonal disk), and merges same-label neighbours
with unary_union plus iterative snapped-edge repair. This module does the
same construction without GEOS, exactly:

* ``capped_voronoi_cells`` — each point's 64-gon disk clipped against the
  bisector half-plane of every neighbour within 2r (Sutherland–Hodgman per
  half-plane; the capped Voronoi cell by definition, robust for collinear
  and near-degenerate point sets).
* ``union_cells`` — union of an edge-sharing cell collection by split-and-
  cancel: every polygon edge is split at every vertex that lies on it, then
  interior edges (traversed once in each direction by the two adjacent CCW
  cells) cancel pairwise; the surviving edges chain into boundary rings.
  For Voronoi tilings this is exact — neighbouring cells share ridge
  segments with bit-identical endpoints — and the splitting step resolves
  the partial overlaps introduced by per-cell disk caps.

Holes in a union (a ring of same-label cells around an island) come out as
clockwise rings and are dropped from the serialized output, matching the
raster path's external-contour behaviour.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

_SNAP = 1e-6  # vertex snapping grid (slide pixels)


def disk_polygon(center: np.ndarray, radius: float, n_segments: int = 64) -> np.ndarray:
    """CCW regular polygon approximating a disk (shapely buffer default=64)."""
    theta = np.linspace(0.0, 2.0 * np.pi, n_segments, endpoint=False)
    return np.stack(
        [center[0] + radius * np.cos(theta), center[1] + radius * np.sin(theta)], axis=1
    )


def clip_halfplane(subject: np.ndarray, origin: np.ndarray, normal: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman clip against one half-plane: keep (v-origin).n >= 0."""
    if len(subject) == 0:
        return subject
    out: list[np.ndarray] = []
    prev = subject[-1]
    fprev = float((prev - origin) @ normal)
    for cur in subject:
        fcur = float((cur - origin) @ normal)
        if fcur >= 0.0:
            if fprev < 0.0:
                t = fprev / (fprev - fcur)
                out.append(prev + t * (cur - prev))
            out.append(cur)
        elif fprev >= 0.0:
            t = fprev / (fprev - fcur)
            out.append(prev + t * (cur - prev))
        prev, fprev = cur, fcur
    return np.asarray(out) if out else np.zeros((0, 2))


def capped_voronoi_cells(
    points: np.ndarray, radius: float, n_segments: int = 64
) -> List[np.ndarray | None]:
    """Each point's Voronoi cell intersected with its disk of `radius`.

    Built by clipping the point's disk polygon against the bisector
    half-plane of every neighbour within 2*radius (a point farther away
    cannot influence the disk region). This is the capped Voronoi cell by
    definition and involves NO Voronoi vertex geometry, so collinear and
    near-degenerate point sets — where finite-ifying scipy's open ridges
    puts vertices astronomically far away and silently loses cells — are
    handled exactly like any other configuration. Bisector lines are
    computed canonically per unordered pair, so the two adjacent cells clip
    against the identical line and union_cells' snapped edges cancel.
    """
    points = np.asarray(points, np.float64)
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    out: List[np.ndarray | None] = []
    for i, p in enumerate(points):
        cell = disk_polygon(p, radius, n_segments)
        for j in tree.query_ball_point(p, 2.0 * radius):
            if j == i:
                continue
            lo, hi = (i, j) if i < j else (j, i)
            a, b = points[lo], points[hi]
            d = b - a
            nrm = float(np.linalg.norm(d))
            if nrm == 0.0:
                # Coincident points (duplicate detection rows) would get two
                # identical cells, whose union double-traces the boundary —
                # keep only the lowest-index duplicate's cell.
                if i == hi:
                    cell = np.zeros((0, 2))
                    break
                continue
            d = d / nrm
            mid = (a + b) / 2.0
            inward = -d if i == lo else d  # toward p's side of the bisector
            cell = clip_halfplane(cell, mid, inward)
            if len(cell) < 3:
                break
        out.append(cell if len(cell) >= 3 else None)
    return out


def ring_area(ring: np.ndarray) -> float:
    """Signed shoelace area (CCW positive)."""
    x, y = ring[:, 0], ring[:, 1]
    return 0.5 * float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _snap_key(pt: np.ndarray) -> tuple[int, int]:
    return (int(round(pt[0] / _SNAP)), int(round(pt[1] / _SNAP)))


def union_cells(polys: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Union of edge-sharing CCW polygons -> boundary rings (CCW = exterior).

    Exact for collections whose interiors are disjoint and whose shared
    boundary pieces are collinear (capped Voronoi cells of one component).
    """
    # ---- gather snapped vertices and directed edges --------------------------
    vert_xy: dict[tuple[int, int], np.ndarray] = {}
    raw_edges: list[tuple[tuple[int, int], tuple[int, int]]] = []
    for poly in polys:
        m = len(poly)
        keys = []
        for v in poly:
            k = _snap_key(v)
            vert_xy.setdefault(k, np.asarray(v, np.float64))
            keys.append(k)
        for i in range(m):
            a, b = keys[i], keys[(i + 1) % m]
            if a != b:
                raw_edges.append((a, b))

    if not raw_edges:
        return []

    # ---- split every edge at any vertex lying on it --------------------------
    # (resolves the partial-overlap segments created by per-cell disk caps)
    all_keys = list(vert_xy.keys())
    all_pts = np.array([vert_xy[k] for k in all_keys])
    # coarse spatial buckets to keep the split test near-linear; bucket size
    # tracks the median edge length so a typical edge's bbox touches O(1)
    # buckets (a fixed 1 px bucket makes the sweep quadratic in the cap
    # radius: a 400 px diagonal edge would scan ~160k buckets)
    sample = raw_edges[:: max(1, len(raw_edges) // 256)]
    med_len = float(
        np.median([np.linalg.norm(vert_xy[b] - vert_xy[a]) for a, b in sample])
    )
    cell = max(1.0, med_len)
    buckets: dict[tuple[int, int], list[int]] = {}
    for i, pt in enumerate(all_pts):
        buckets.setdefault((int(pt[0] // cell), int(pt[1] // cell)), []).append(i)

    def vertices_near(lo: np.ndarray, hi: np.ndarray) -> list[int]:
        out = []
        for bx in range(int(lo[0] // cell), int(hi[0] // cell) + 1):
            for by in range(int(lo[1] // cell), int(hi[1] // cell) + 1):
                out.extend(buckets.get((bx, by), ()))
        return out

    tol = _SNAP * 8
    split_edges: list[tuple[tuple[int, int], tuple[int, int]]] = []
    for a, b in raw_edges:
        pa, pb = vert_xy[a], vert_xy[b]
        d = pb - pa
        length2 = float(d @ d)
        lo = np.minimum(pa, pb) - tol
        hi = np.maximum(pa, pb) + tol
        on_seg: list[tuple[float, tuple[int, int]]] = []
        for vi in vertices_near(lo, hi):
            k = all_keys[vi]
            if k == a or k == b:
                continue
            pv = all_pts[vi]
            t = float((pv - pa) @ d) / length2
            if t <= 0.0 or t >= 1.0:
                continue
            # perpendicular distance
            perp = pv - (pa + t * d)
            if float(perp @ perp) <= tol * tol:
                on_seg.append((t, k))
        if on_seg:
            on_seg.sort()
            chain = [a] + [k for _, k in on_seg] + [b]
            for i in range(len(chain) - 1):
                if chain[i] != chain[i + 1]:
                    split_edges.append((chain[i], chain[i + 1]))
        else:
            split_edges.append((a, b))

    # ---- cancel interior edges (present in both directions) -----------------
    from collections import Counter

    counts = Counter(split_edges)
    boundary: list[tuple[tuple[int, int], tuple[int, int]]] = []
    for (a, b), c in counts.items():
        c_rev = counts.get((b, a), 0)
        keep = c - c_rev
        for _ in range(max(0, keep)):
            boundary.append((a, b))

    if not boundary:
        return []

    # ---- chain boundary edges into rings -------------------------------------
    outgoing: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for a, b in boundary:
        outgoing.setdefault(a, []).append(b)

    rings: List[np.ndarray] = []
    while any(outgoing.values()):
        start = next(k for k, v in outgoing.items() if v)
        ring_keys = [start]
        prev = None
        cur = start
        while True:
            nexts = outgoing.get(cur, [])
            if not nexts:
                break  # dangling chain (numerical leftover); drop it
            if prev is None or len(nexts) == 1:
                nxt = nexts.pop()
            else:
                # at a junction, take the sharpest clockwise turn so rings
                # stay simple
                pin = vert_xy[cur] - vert_xy[prev]
                ang_in = np.arctan2(pin[1], pin[0])

                def turn(kb):
                    pout = vert_xy[kb] - vert_xy[cur]
                    return (np.arctan2(pout[1], pout[0]) - ang_in + np.pi) % (2 * np.pi)

                nxt = min(nexts, key=turn)
                nexts.remove(nxt)
            if nxt == start:
                ring = np.array([vert_xy[k] for k in ring_keys])
                if len(ring) >= 3:
                    rings.append(ring)
                break
            ring_keys.append(nxt)
            prev, cur = cur, nxt
    return rings
