"""Model-output CSV -> GeoJSON FeatureCollection overlays.

A copy of wsinsight_tpu/writers/geojson.py: the port imports nothing of that package.

Same output contract as the reference exporter (reference:
wsinsight/write_geojson.py:38-482) with the geopandas/shapely/orjson
dependencies replaced by our own WKT parser and the stdlib json encoder.
What is contractual (QuPath and downstream viewers consume these bytes):

* the shrink-box math and the closed 5-vertex ring order
  (via :func:`..writers.common.shrunk_boxes`),
* feature key order and the property trio isLocked / measurements /
  objectType plus the optional classification {name, color},
* interleaved-HSV class colors,
* resume semantics (stems already exported are skipped) and atomic
  ``.PART``-rename local writes with URIPath sync for remotes.
"""

from __future__ import annotations

import json
import multiprocessing
import uuid
from colorsys import hsv_to_rgb
from concurrent.futures import ProcessPoolExecutor, as_completed
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import pandas as pd
from tqdm.auto import tqdm

from ..uri_path import URIPath
from .common import iter_files, shrunk_boxes
from .wkt import wkt_to_geojson_geometry

PathLike = Union[Path, URIPath]


def _dumps(payload: dict) -> bytes:
    """Compact UTF-8 JSON bytes (the wire format orjson produced upstream)."""
    return json.dumps(payload, separators=(",", ":"), ensure_ascii=False).encode()


def _interleave(n: int) -> list[int]:
    """0, n-1, 1, n-2, ... — alternate ends toward the middle."""
    half = (n + 1) // 2
    order: list[int] = []
    for i in range(half):
        order.append(i)
        if i != n - 1 - i:
            order.append(n - 1 - i)
    return order


def _make_distinct_colors(
    n: int, s: float = 0.70, v: float = 0.90, shuffle: bool = True,
    seed: Optional[int] = None,  # accepted for API compat; hue walk is deterministic
):
    """`n` well-spaced colors: evenly spaced hues, visited end-in so adjacent
    class indices land far apart on the wheel (reference convention,
    write_geojson.py:38-65)."""
    del seed
    if n < 1:
        raise ValueError("n must be > 0")
    hue_order = _interleave(n) if (shuffle and n > 2) else range(n)
    palette = []
    for idx in hue_order:
        hue = idx / n
        rgb255 = tuple(int(round(c * 255)) for c in hsv_to_rgb(hue, s, v))
        palette.append(
            {
                "hex": "#{:02X}{:02X}{:02X}".format(*rgb255),
                "rgb": rgb255,
                "hsv": (hue, s, v),
            }
        )
    return palette


def _prob_matrix(df: pd.DataFrame, prob_cols: List[str]):
    """(N,C) float32 prob matrix and its per-row argmax."""
    probs = df[prob_cols].to_numpy(dtype=np.float32, copy=False)
    return probs, probs.argmax(axis=1)


def _classifications(
    prob_cols: List[str], prefix: str, color_list: Optional[List[dict]]
) -> list[dict]:
    """One ready-to-embed classification dict per class column."""
    palette = color_list or _make_distinct_colors(len(prob_cols))
    labels = [
        c if c.startswith(f"{prefix}_") else f"{prefix}_{c}" for c in prob_cols
    ]
    return [
        {"name": label, "color": list(entry["rgb"])}
        for label, entry in zip(labels, palette)
    ]


def _dataframe_to_geojson_box_fast(
    df: pd.DataFrame, prob_cols: List[str], overlap: float, *,
    prefix: str = "prob", object_type: str = "tile",
    set_classification: bool = False, color_list: Optional[List[dict]] = None,
) -> dict:
    """Tile boxes -> FeatureCollection, geometry math fully vectorized."""
    valid_cols = [c for c in prob_cols if c.startswith(prefix)]
    df = df.dropna(subset=valid_cols)
    x0, y0, x1, y1 = shrunk_boxes(df, overlap)

    # Closed rings as (N, 5, 2): x and y vertex sequences stacked pairwise.
    # Vertex order is contractual: (maxx,miny),(maxx,maxy),(minx,maxy),
    # (minx,miny), close.
    ring_x = np.stack([x1, x1, x0, x0, x1], axis=1)
    ring_y = np.stack([y0, y1, y1, y0, y0], axis=1)
    rings = np.stack([ring_x, ring_y], axis=2)

    probs, winners = _prob_matrix(df, prob_cols)
    classes = _classifications(prob_cols, prefix, color_list)

    features: list[dict] = []
    for ring, row, win in zip(rings, probs, winners):
        properties = {
            "isLocked": True,
            "measurements": dict(zip(prob_cols, row.tolist())),
            "objectType": object_type,
        }  # key order is part of the byte contract
        if set_classification:  # QuPath colors tiles by this block
            properties["classification"] = classes[win]
        features.append({
            "type": "Feature",
            "id": str(uuid.uuid4()),
            "geometry": {"type": "Polygon", "coordinates": [ring.tolist()]},
            "properties": properties,
        })
    return {"type": "FeatureCollection", "features": features}


def _dataframe_to_geojson_polygon_fast(
    df: pd.DataFrame, prob_cols: List[str], *,
    prefix: str = "prob", object_type: str = "tile",
    set_classification: bool = False, color_list: Optional[List[dict]] = None,
    crs: Optional[str] = None,
) -> dict:
    """WKT-polygon annotations -> FeatureCollection (reference: :148-190).

    Every non-WKT CSV column rides along as a feature property, like the
    geopandas path upstream did.
    """
    del crs
    probs, winners = _prob_matrix(df, prob_cols)
    classes = _classifications(prob_cols, prefix, color_list)

    carry_cols = [c for c in df.columns if c != "polygon_wkt"]
    carried = {c: df[c].tolist() for c in carry_cols}

    features: list[dict] = []
    for i, wkt in enumerate(df["polygon_wkt"].tolist()):
        properties: dict = {}
        for col in carry_cols:
            value = carried[col][i]
            properties[col] = value.item() if hasattr(value, "item") else value
        properties["objectType"] = object_type
        if set_classification:  # QuPath colors detections by this block
            properties["classification"] = classes[winners[i]]
        properties["measurements"] = dict(zip(prob_cols, probs[i].tolist()))
        properties["isLocked"] = True
        features.append({
            "type": "Feature",
            "geometry": wkt_to_geojson_geometry(wkt),
            "properties": properties,
        })
    return {"type": "FeatureCollection", "features": features}


def _build_geojson_dict_from_csv(
    csv: PathLike, *,
    overlap: float, results_dir: PathLike, output_dir: PathLike,
    prefix: str = "prob", object_type: str = "tile",
    set_classification: bool = False, annotation_shape: str = "box",
    usecols: Optional[List[str]] = None, dtype: Optional[Dict] = None,
) -> Tuple[PathLike, dict]:
    """Load one model-output CSV and return (destination, FeatureCollection)."""
    local = csv.materialize() if isinstance(csv, URIPath) else csv
    df = pd.read_csv(local, usecols=usecols, dtype=dtype, engine="c", low_memory=False)

    wanted = f"{prefix}_"
    prob_cols = [c for c in df.columns if c.startswith(wanted)]
    if not prob_cols:
        raise KeyError(f"No {wanted}* columns in {csv}")

    shared = dict(
        prefix=prefix, object_type=object_type,
        set_classification=set_classification,
        color_list=_make_distinct_colors(len(prob_cols)),
    )
    if annotation_shape == "box":
        geojson = _dataframe_to_geojson_box_fast(df, prob_cols, overlap, **shared)
    elif "polygon_wkt" in df.columns:
        geojson = _dataframe_to_geojson_polygon_fast(df, prob_cols, **shared)
    else:
        raise KeyError("polygon_wkt column is required for annotation_shape='polygon'")

    return results_dir / output_dir / f"{csv.stem}.geojson", geojson


_iter_files = iter_files


def _write_geojson_bytes(out_path: PathLike, payload: bytes, atomic: bool = True) -> None:
    """Persist GeoJSON bytes; local writes go through a .PART rename."""
    out_path.parent.mkdir(parents=True, exist_ok=True)

    if isinstance(out_path, URIPath) and out_path.scheme is not None:
        # URIPath syncs its local cache back to the remote on close.
        with out_path.open("wb") as sink:
            sink.write(payload)
        return

    target = Path(str(out_path))
    staging = target.with_suffix(target.suffix + ".PART") if atomic else target
    with open(staging, "wb", buffering=1 << 20) as sink:
        sink.write(payload)
    if atomic:
        staging.replace(target)


def _worker(
    csv, overlap, results_dir, output_dir, prefix, object_type,
    set_classification, annotation_shape, usecols, dtype, atomic_writes,
):
    """Convert one CSV and persist its GeoJSON (runs in a pool process)."""
    out_path, geojson = _build_geojson_dict_from_csv(
        csv, overlap=overlap, results_dir=results_dir, output_dir=output_dir,
        prefix=prefix, object_type=object_type,
        set_classification=set_classification,
        annotation_shape=annotation_shape, usecols=usecols, dtype=dtype,
    )
    _write_geojson_bytes(out_path, _dumps(geojson), atomic=atomic_writes)


def _validate_inputs(csvs: List[PathLike], results_dir: PathLike) -> None:
    if not results_dir.exists():
        raise FileExistsError(f"results_dir does not exist: {results_dir!s}")
    missing = sorted({p.parent for p in csvs if not p.parent.exists()}, key=str)
    if missing:
        joined = ", ".join(map(str, missing))
        raise FileExistsError(f"GeoJSON input CSV directory not found: {joined}")


def write_geojsons(
    csvs: List[PathLike], *,
    results_dir: PathLike, overlap: float, output_dir: Path = Path("."),
    prefix: str = "prob", num_workers=8, object_type: str = "tile",
    set_classification: bool = False, annotation_shape: str = "box",
    atomic_writes: bool = True,
    usecols: Optional[List[str]] = None, dtype: Optional[Dict] = None,
    show_progress: bool = True, print_timings: bool = False,
) -> None:
    """Fan CSV->GeoJSON conversion out over a process pool, skipping stems
    that already have a .geojson (the exporter-level resume contract)."""
    _validate_inputs(csvs, results_dir)
    out_root = results_dir / output_dir
    out_root.mkdir(parents=True, exist_ok=True)  # idempotent across resumes

    exported = {p.stem for p in _iter_files(out_root, suffix=".geojson")}
    pending = [p for p in csvs if p.stem not in exported]
    if not pending:
        if print_timings:
            print("geojson: everything already exported, nothing to do")
        return

    # Clamp the static worker request by host headroom (the reference
    # governs this pool too, write_geojson.py:459); spawn because forking
    # after JAX initialization can deadlock worker processes.
    from ..utils.workers import governed_workers

    job_args = (
        overlap, results_dir, output_dir, prefix, object_type,
        set_classification, annotation_shape, usecols, dtype, atomic_writes,
    )
    progress = (
        tqdm(total=len(pending), desc="Files completed", dynamic_ncols=True)
        if show_progress
        else None
    )
    n_workers = governed_workers(num_workers)
    if n_workers <= 1 or len(pending) == 1:
        # Inline: a spawn worker pays a fresh interpreter + package import
        # (~10 s on a small host) — more than a single slide's export. Same
        # worker function, same artifacts.
        for csv in pending:
            _worker(csv, *job_args)
            if progress:
                progress.update(1)
    else:
        pool = ProcessPoolExecutor(
            max_workers=n_workers,
            mp_context=multiprocessing.get_context("spawn"),
        )
        with pool:
            futures = [pool.submit(_worker, csv, *job_args) for csv in pending]
            for future in as_completed(futures):
                future.result()
                if progress:
                    progress.update(1)
    if progress:
        progress.close()
