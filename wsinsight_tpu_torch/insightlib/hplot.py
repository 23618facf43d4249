"""H-Plot tumor-border analytics: per-slide layers + cohort metrics.

A copy of wsinsight_tpu/insightlib/hplot.py, host only, with its spawn
process pool and resume contract.

Re-creation of the reference pipeline (reference:
wsinsight/insightlib/hplot_generation.py:29-331) with SURVEY.md §2.11 fixes:

* is_base_type / is_target_type OR across the type lists (the reference's loop
  overwrote per iteration, so only the last type counted),
* works with an explicit slide list (the reference required wsi_dir and
  crashed when infer passed None).

Layout: one :class:`_SlideJob` per slide fans out over a spawn-safe process
pool; each worker resolves its artifact paths, short-circuits on resume,
builds the cell graph and writes the three per-slide artifacts; the parent
folds worker results into the two cohort tables with pandas reindex/upsert
(no per-layer Python loops).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, as_completed
from pathlib import Path
from typing import List

import numpy as np
import pandas as pd
from tqdm import tqdm

from .. import errors

logger = logging.getLogger(__name__)
from ..uri_path import URIPath
from ..wsi import _validate_wsi_directory, get_avg_mpp
from .helpers import (
    calculate_distance_to_border,
    compute_cell_center_points,
    compute_enrichment_index,
    compute_hmetrics,
    compute_hplot,
    delaunay_triangulation,
    edges_to_csr,
    identify_border_cells,
    identify_region_by_cell_function_enrichment,
    k_hop_reachability,
)

HMETRIC_COLUMNS = [
    "id",
    "valid",
    "convergence_distance (intra)",
    "abundance_score (intra)",
    "penetration_score (intra)",
    "layerwise_enrichment_index (intra)",
    "global_enrichment_index (intra)",
    "weighted_global_enrichment_index (intra)",
    "convergence_distance (peri)",
    "abundance_score (peri)",
    "proximity_score (peri)",
    "layerwise_enrichment_index (peri)",
    "global_enrichment_index (peri)",
    "weighted_global_enrichment_index (peri)",
    "exclusion_index",
    "desert_index",
    "inflammation_index",
    "layerwise_enrichment_index",
    "global_enrichment_index",
    "weighted_global_enrichment_index",
]


@dataclasses.dataclass(frozen=True)
class _SlideJob:
    """Everything one slide's worker needs, picklable for spawn pools."""

    wsi_path: str
    model_output_csv: str
    insight_dir: str
    max_neighbor_distance_um: float
    base_types: tuple
    target_types: tuple
    k: int
    N: int
    R: float
    range_min: int | None
    range_max: int | None
    valid_range_only: bool

    @property
    def stem(self) -> str:
        return URIPath(self.wsi_path).stem

    def artifact(self, kind: str, suffix: str) -> Path:
        return Path(self.insight_dir) / kind / f"{self.stem}{suffix}"


def _load_typed_cells(job: _SlideJob) -> pd.DataFrame | None:
    """Model-output CSV -> cell table with OR'd base/target flags + centers."""
    try:
        cells = pd.read_csv(job.model_output_csv)
    except Exception:
        return None
    probs = [c for c in cells.columns if c.startswith("prob_")]
    winner = cells[probs].idxmax(axis=1)
    cells["is_base_type"] = winner.isin([f"prob_{t}" for t in job.base_types])
    cells["is_target_type"] = winner.isin([f"prob_{t}" for t in job.target_types])
    cells = compute_cell_center_points(cells)
    return cells if len(cells) >= 4 else None


def _layer_and_annotate(job: _SlideJob, cells: pd.DataFrame, dist_px: float):
    """Delaunay graph -> k-hop enrichment -> regions/border/distance."""
    edges = delaunay_triangulation(cells[["center_x", "center_y"]].values, dist_px)
    if not {"source", "target"} <= set(edges.columns):
        return None, None
    adj = edges_to_csr(edges, len(cells))
    reach = k_hop_reachability(adj, job.k)
    cells = compute_enrichment_index(cells, reach)
    cells = identify_region_by_cell_function_enrichment(reach, cells, job.N, job.R)
    cells = identify_border_cells(cells, adj)
    cells = calculate_distance_to_border(cells, adj)
    return cells, edges


def _worker(job: _SlideJob):
    """Per-slide worker: graph build -> layers -> H-plot -> metrics."""
    out_cells = job.artifact("cells", ".csv")
    out_hplot = job.artifact("hplots", ".csv")
    out_metrics = job.artifact("hmetrics", ".json")

    # Resume: reuse per-slide artifacts (reference: hplot_generation.py:40-46).
    if all(p.exists() for p in (out_cells, out_hplot, out_metrics)):
        return (
            job.stem,
            pd.read_csv(out_hplot),
            json.loads(out_metrics.read_text(encoding="utf-8")),
        )

    try:
        um_per_px = get_avg_mpp(URIPath(job.wsi_path))
    except Exception:
        return job.stem, None, None

    cells = _load_typed_cells(job)
    if cells is None:
        return job.stem, None, None
    cells, edges = _layer_and_annotate(
        job, cells, job.max_neighbor_distance_um / um_per_px
    )
    if cells is None:
        return job.stem, None, None

    out_cells.parent.mkdir(parents=True, exist_ok=True)
    cells.to_csv(out_cells, index=False)

    layers = compute_hplot(cells, edges)
    out_hplot.parent.mkdir(parents=True, exist_ok=True)
    layers.to_csv(out_hplot, index=False)

    metrics = compute_hmetrics(
        hplot_df=layers,
        range_min=job.range_min,
        range_max=job.range_max,
        hplot_samples_with_valid_range_only=job.valid_range_only,
    )
    out_metrics.parent.mkdir(parents=True, exist_ok=True)
    out_metrics.write_text(json.dumps(metrics, indent=2))

    return job.stem, layers, metrics


def upsert_by_key(df_old: pd.DataFrame, df_new: pd.DataFrame, key: str) -> pd.DataFrame:
    """Update/insert rows by unique key, new values winning.

    Same contract as the reference's cohort upsert (reference:
    hplot_generation.py:101-138): existing ids keep their row position with
    refreshed values, unseen ids append below in the new frame's order.
    """
    for frame in (df_old, df_new):
        if key not in frame.columns:
            raise KeyError(f"Key column '{key}' must exist in both DataFrames.")
    fresh = (
        df_new.reindex(columns=df_old.columns)
        .drop_duplicates(subset=[key], keep="last")
        .set_index(key)
    )
    stacked = pd.concat([df_old.set_index(key), fresh])
    stacked = stacked[~stacked.index.duplicated(keep="last")]
    order = df_old[key].tolist()
    order += [k for k in fresh.index if k not in set(order)]
    return stacked.loc[order].reset_index()


def _resolve_slides(wsi_dir, wsi_paths) -> list:
    if wsi_paths is None:
        if wsi_dir is None:
            raise errors.WholeSlideImageDirectoryNotFound(
                "hplot_generation needs wsi_dir or wsi_paths"
            )
        wsi_dir = URIPath(wsi_dir)
        if not wsi_dir.exists():
            raise errors.WholeSlideImageDirectoryNotFound(f"directory not found: {wsi_dir}")
        _validate_wsi_directory(wsi_dir)
        wsi_paths = [p for p in wsi_dir.iterdir() if p.is_file()]
    slides = [URIPath(p) for p in wsi_paths]
    if not slides:
        raise errors.WholeSlideImagesNotFound(str(wsi_dir))
    return slides


_COMPOSITE_EPS = 1e-6


def _flatten_metrics(stem: str, hm: dict) -> list:
    """One cohort hmetrics row: the 12 scoped fields then the composites."""
    scoped = [
        hm[scope][field]
        for scope, fields in (
            ("intra", ("convergence_distance", "abundance_score", "penetration_score",
                       "layerwise_enrichment_index", "global_enrichment_index",
                       "weighted_global_enrichment_index")),
            ("peri", ("convergence_distance", "abundance_score", "proximity_score",
                      "layerwise_enrichment_index", "global_enrichment_index",
                      "weighted_global_enrichment_index")),
        )
        for field in fields
    ]
    ab_in, ab_out = hm["intra"]["abundance_score"], hm["peri"]["abundance_score"]

    def mean_of(field: str) -> float:
        return 0.5 * (hm["intra"][field] + hm["peri"][field])

    composites = [
        ab_out / (_COMPOSITE_EPS + ab_out + ab_in),  # exclusion
        1 - 0.5 * (ab_in + ab_out),                  # desert
        0.5 * (ab_in + ab_out),                      # inflammation
        mean_of("layerwise_enrichment_index"),
        mean_of("global_enrichment_index"),
        mean_of("weighted_global_enrichment_index"),
    ]
    return [stem, hm["valid"], *scoped, *composites]


def _layer_rows(stem: str, layers: pd.DataFrame) -> list[list]:
    """Dense per-layer rows over the slide's observed layer span.

    Missing layers inside [floor(min), ceil(max)] get NaN value/distance —
    the cohort table is rectangular per slide (reference cohort loop,
    hplot_generation.py:269-283), built here by reindex instead of a scan.
    """
    numeric = pd.to_numeric(layers["layer"], errors="coerce")
    numeric = numeric[np.isfinite(numeric)]
    if numeric.empty:
        return []
    span = range(int(np.floor(numeric.min())), int(np.ceil(numeric.max())) + 1)
    dense = (
        layers.drop_duplicates(subset=["layer"], keep="first")
        .set_index("layer")
        .reindex(span)
    )
    return [
        [stem, layer, row.target_type_prop, row.distance]
        for layer, row in dense.iterrows()
    ]


def hplot_generation(
    wsi_dir=None,
    wsi_paths=None,
    results_dir=None,
    base_type_list: List[str] | None = None,
    target_type_list: List[str] | None = None,
    max_neighbor_distance_um: float = 25.0,
    hplot_k: int = 2,
    hplot_N: int = 8,
    hplot_R: float = 0.5,
    hplot_range_max: int | None = None,
    hplot_range_min: int | None = None,
    hplot_samples_with_valid_range_only: bool = False,
    num_workers: int = 8,
) -> list[str]:
    """Compute per-slide H-Plot layers/metrics and the cohort aggregates."""
    slides = _resolve_slides(wsi_dir, wsi_paths)

    results_dir = URIPath(results_dir)
    if not results_dir.exists():
        raise errors.ResultsDirectoryNotFound(str(results_dir))
    model_output_dir = results_dir / "model-outputs-csv"
    if not model_output_dir.exists():
        raise errors.ResultsDirectoryNotFound(
            "results directory has no 'model-outputs-csv' (run inference first)"
        )

    hplot_dir = results_dir / "hplot-outputs-csv"
    for sub in ("hplots", "hmetrics", "cells"):
        (hplot_dir / sub).mkdir(exist_ok=True, parents=True)

    jobs: list[_SlideJob] = []
    for slide in slides:
        csv = model_output_dir / f"{slide.stem}.csv"
        if not csv.exists():
            logger.warning(f"no model output for {slide.stem}, skipping: {csv}")
            continue
        jobs.append(
            _SlideJob(
                wsi_path=str(slide),
                model_output_csv=str(csv.materialize()),
                insight_dir=str(hplot_dir),
                max_neighbor_distance_um=max_neighbor_distance_um,
                base_types=tuple(base_type_list or ()),
                target_types=tuple(target_type_list or ()),
                k=hplot_k,
                N=hplot_N,
                R=hplot_R,
                range_min=hplot_range_min,
                range_max=hplot_range_max,
                valid_range_only=hplot_samples_with_valid_range_only,
            )
        )

    # Governor clamp, mirroring the reference's governed hplot pool
    # (num_worker_optimizer.py:74-165 via hplot_generation.py:257).
    from ..utils.workers import governed_workers

    failed: list[str] = []
    layer_rows: list[list] = []
    metric_rows: list[list] = []

    def fold(stem: str, layers, hm) -> None:
        if layers is None or hm is None:
            failed.append(stem)
            return
        rows = _layer_rows(stem, layers)
        layer_rows.extend(rows)
        if rows:
            metric_rows.append(_flatten_metrics(stem, hm))

    n_workers = governed_workers(max(1, num_workers))
    with tqdm(total=len(jobs), desc="H-Plot") as progress:
        if n_workers <= 1 or len(jobs) == 1:
            # Inline: a spawn worker costs a fresh interpreter + imports —
            # more than one slide's graph build on a small host.
            for job in jobs:
                try:
                    fold(*_worker(job))
                except Exception as err:
                    logger.error(f"H-plot worker failed for {job.stem}: {err!r}")
                    failed.append(job.stem)
                progress.update(1)
        else:
            pool_kw = dict(
                max_workers=n_workers,
                mp_context=multiprocessing.get_context("spawn"),
            )
            with ProcessPoolExecutor(**pool_kw) as pool:
                pending = {pool.submit(_worker, job): job for job in jobs}
                for done in as_completed(pending):
                    try:
                        fold(*done.result())
                    except Exception as err:
                        # A degenerate slide (e.g. QhullError on collinear
                        # centers, missing prob_* columns) must not abort the
                        # cohort — record it and keep aggregating the rest.
                        stem = pending[done].stem
                        logger.error(f"H-plot worker failed for {stem}: {err!r}")
                        failed.append(stem)
                    progress.update(1)

    cohort_layers = pd.DataFrame(layer_rows, columns=["id", "layer", "value", "distance"])
    cohort_metrics = pd.DataFrame(metric_rows, columns=HMETRIC_COLUMNS)

    layers_csv = results_dir / "hplot-outputs.csv"
    if layers_csv.exists():
        # Multi-row-per-id table: replace all rows of re-processed ids (the
        # reference's single-key upsert silently dropped layers here).
        prior = pd.read_csv(layers_csv.materialize())
        prior = prior[~prior["id"].isin(set(cohort_layers["id"]))]
        cohort_layers = pd.concat([prior, cohort_layers], ignore_index=True)
    with layers_csv.open("w") as fh:
        cohort_layers.to_csv(fh, index=False)

    metrics_csv = results_dir / "hmetrics-outputs.csv"
    if metrics_csv.exists():
        cohort_metrics = upsert_by_key(
            pd.read_csv(metrics_csv.materialize()), cohort_metrics, key="id"
        )
    with metrics_csv.open("w") as fh:
        cohort_metrics.to_csv(fh, index=False)

    return failed
