"""Minimal WKT serialization for POLYGON / MULTIPOLYGON geometries.

A copy of wsinsight_tpu/writers/wkt.py: the port imports nothing of that package.

Replaces shapely's ``from_wkt`` / ``wkt`` for the writer paths (reference:
wsinsight/write_geojson.py:160, write_omecsv.py:84). Coordinates are (x, y)
pairs; rings are numpy arrays.
"""

from __future__ import annotations

import re

import numpy as np


def _fmt(v: float) -> str:
    """Format like Python's str(float) (shapely's default float repr)."""
    f = float(v)
    if f.is_integer():
        return str(int(f))
    return repr(f)


def polygon_wkt(rings: list[np.ndarray]) -> str:
    """POLYGON ((exterior), (hole), ...) — rings closed automatically."""
    if not rings:
        return "POLYGON EMPTY"
    parts = []
    for ring in rings:
        ring = np.asarray(ring, dtype=np.float64)
        if len(ring) and not np.array_equal(ring[0], ring[-1]):
            ring = np.vstack([ring, ring[:1]])
        parts.append("(" + ", ".join(f"{_fmt(x)} {_fmt(y)}" for x, y in ring) + ")")
    return "POLYGON (" + ", ".join(parts) + ")"


def multipolygon_wkt(polys: list[list[np.ndarray]]) -> str:
    if not polys:
        return "MULTIPOLYGON EMPTY"
    parts = []
    for rings in polys:
        inner = []
        for ring in rings:
            ring = np.asarray(ring, dtype=np.float64)
            if len(ring) and not np.array_equal(ring[0], ring[-1]):
                ring = np.vstack([ring, ring[:1]])
            inner.append("(" + ", ".join(f"{_fmt(x)} {_fmt(y)}" for x, y in ring) + ")")
        parts.append("(" + ", ".join(inner) + ")")
    return "MULTIPOLYGON (" + ", ".join(parts) + ")"




def _parse_ring(text: str) -> np.ndarray:
    pts = []
    for pair in text.split(","):
        xy = pair.strip().split()
        pts.append((float(xy[0]), float(xy[1])))
    return np.asarray(pts, dtype=np.float64)


def _split_rings(body: str) -> list[str]:
    """Split '(...), (...)' into ring bodies at depth-0 commas."""
    rings, depth, start = [], 0, None
    for i, ch in enumerate(body):
        if ch == "(":
            if depth == 0:
                start = i + 1
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                rings.append(body[start:i])
    return rings


def parse_wkt(text: str) -> tuple[str, list[list[np.ndarray]]]:
    """Parse POLYGON/MULTIPOLYGON WKT -> (type, [polygons][rings](N,2))."""
    text = text.strip()
    m = re.match(r"^(POLYGON|MULTIPOLYGON)\s*(EMPTY|\(.*\))$", text, re.S | re.I)
    if not m:
        raise ValueError(f"unsupported WKT: {text[:60]}...")
    gtype = m.group(1).upper()
    body = m.group(2)
    if body.upper() == "EMPTY":
        return gtype, []
    body = body.strip()[1:-1]  # strip outermost parens
    if gtype == "POLYGON":
        return gtype, [[_parse_ring(r) for r in _split_rings(body)]]
    # MULTIPOLYGON: split top-level polygons, then rings within each.
    polys = []
    depth, start = 0, None
    for i, ch in enumerate(body):
        if ch == "(":
            if depth == 0:
                start = i
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                inner = body[start + 1 : i]
                polys.append([_parse_ring(r) for r in _split_rings(inner)])
    return gtype, polys


def wkt_to_geojson_geometry(text: str) -> dict:
    gtype, polys = parse_wkt(text)
    def ring_coords(r: np.ndarray) -> list:
        if len(r) and not np.array_equal(r[0], r[-1]):
            r = np.vstack([r, r[:1]])
        return [[float(x), float(y)] for x, y in r]

    if gtype == "POLYGON":
        coords = [ring_coords(r) for r in (polys[0] if polys else [])]
        return {"type": "Polygon", "coordinates": coords}
    return {
        "type": "MultiPolygon",
        "coordinates": [[ring_coords(r) for r in rings] for rings in polys],
    }
