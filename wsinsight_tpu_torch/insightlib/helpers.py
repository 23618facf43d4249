"""Geometry/graph/statistics helpers for spatial analytics.

A copy of wsinsight_tpu/insightlib/helpers.py (host numpy/scipy).

Re-creation of the reference toolkit (reference:
wsinsight/insightlib/insight_helpers.py:13-1020) with the per-cell BFS hot
loops replaced by sparse-matrix algebra:

* k-hop reachability = boolean sparse power of (A + I) — one matmul per hop
  instead of one BFS per cell (reference: insight_helpers.py:180-233),
* enrichment index / region enrichment / border detection / distance-to-border
  all become sparse matvecs and frontier sweeps.

Outputs (column names, semantics, H-plot/metric math) match the reference.
The reference's per-iteration overwrite of is_base_type/is_target_type — which
made only the LAST listed type count (SURVEY.md §2.11) — is fixed by OR-ing
across the list.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List

import numpy as np
import pandas as pd
from scipy import sparse
from scipy.spatial import Delaunay


def compute_cell_center_points(model_output_df: pd.DataFrame) -> pd.DataFrame:
    """Add integer center_x/center_y columns (reference: insight_helpers.py:13-29)."""
    if "center_x" not in model_output_df.columns or "center_y" not in model_output_df.columns:
        model_output_df["center_x"] = np.rint(
            model_output_df["minx"] + (model_output_df["width"] / 2)
        ).astype(np.int32)
        model_output_df["center_y"] = np.rint(
            model_output_df["miny"] + (model_output_df["height"] / 2)
        ).astype(np.int32)
    return model_output_df


def delaunay_triangulation(point2d_ary: np.ndarray, max_edge_length: float) -> pd.DataFrame:
    """Delaunay edges filtered by length -> DataFrame[source, target, length]
    (reference: insight_helpers.py:32-70), vectorized over simplices."""
    tri = Delaunay(point2d_ary)
    simplices = tri.simplices
    edges = np.concatenate(
        [simplices[:, [0, 1]], simplices[:, [0, 2]], simplices[:, [1, 2]]], axis=0
    )
    edges = np.sort(edges, axis=1)
    edges = np.unique(edges, axis=0)
    p1 = point2d_ary[edges[:, 0]]
    p2 = point2d_ary[edges[:, 1]]
    lengths = np.linalg.norm(p1 - p2, axis=1)
    keep = lengths < max_edge_length
    return pd.DataFrame(
        {"source": edges[keep, 0], "target": edges[keep, 1], "length": lengths[keep]}
    )


def edges_to_csr(edges_df: pd.DataFrame, n_nodes: int) -> sparse.csr_matrix:
    """Symmetric boolean adjacency (no self loops)."""
    if len(edges_df) == 0:
        return sparse.csr_matrix((n_nodes, n_nodes), dtype=bool)
    src = edges_df["source"].to_numpy(np.int64)
    dst = edges_df["target"].to_numpy(np.int64)
    data = np.ones(2 * len(src), dtype=bool)
    a = sparse.coo_matrix(
        (data, (np.concatenate([src, dst]), np.concatenate([dst, src]))),
        shape=(n_nodes, n_nodes),
    ).tocsr()
    a.data[:] = True
    return a


def create_adjacency_list_fast(edges_df: pd.DataFrame, **_kwargs) -> Dict[int, List[int]]:
    """{node: [neighbors...]} (reference: insight_helpers.py:126-177)."""
    if len(edges_df) == 0:
        return {}
    u = edges_df["source"].to_numpy(np.int64)
    v = edges_df["target"].to_numpy(np.int64)
    src = np.concatenate([u, v])
    dst = np.concatenate([v, u])
    pairs = np.unique(np.stack([src, dst], axis=1), axis=0)
    src, dst = pairs[:, 0], pairs[:, 1]
    order = np.argsort(src, kind="mergesort")
    src_sorted, dst_sorted = src[order], dst[order]
    split_points = np.flatnonzero(np.diff(src_sorted)) + 1
    groups = np.split(dst_sorted, split_points)
    keys = src_sorted[np.r_[0, split_points]]
    return {int(k): g.tolist() for k, g in zip(keys, groups)}


def k_hop_reachability(adj: sparse.csr_matrix, k: int) -> sparse.csr_matrix:
    """Boolean (A + I)^k: rows = k-hop closed neighborhoods (incl. self)."""
    n = adj.shape[0]
    reach = (adj + sparse.identity(n, dtype=bool, format="csr")).astype(bool)
    base = reach.copy()
    for _ in range(k - 1):
        reach = (reach @ base).astype(bool)
    return reach.tocsr()


def k_hop_neighbors(nodes_df: pd.DataFrame, adjacency_list: Dict[int, List[int]], k: int):
    """Sorted k-hop closed neighborhoods per node (API-compat; sparse inside)."""
    n = len(nodes_df)
    rows, cols = [], []
    for node, neigh in adjacency_list.items():
        rows.extend([node] * len(neigh))
        cols.extend(neigh)
    a = sparse.coo_matrix(
        (np.ones(len(rows), bool), (rows, cols)), shape=(n, n)
    ).tocsr()
    reach = k_hop_reachability(a, k)
    out = []
    indptr, indices = reach.indptr, reach.indices
    for i in range(n):
        out.append(sorted(indices[indptr[i] : indptr[i + 1]].tolist()))
    return out


def compute_enrichment_index(
    nodes_df: pd.DataFrame,
    reach: sparse.csr_matrix | list,
    target_col: str = "is_target_type",
    base_col: str = "is_base_type",
    eps: float = 1e-6,
    max_workers: int | None = None,
) -> pd.DataFrame:
    """Per-cell enrichment T^2/(T+B+eps) over the k-hop neighborhood
    (reference: insight_helpers.py:321-408), as three sparse matvecs."""
    del max_workers
    reach = _as_reach(reach, len(nodes_df))
    n = np.asarray(reach.sum(axis=1)).ravel().astype(np.float64)
    t_cnt = reach @ nodes_df[target_col].to_numpy(bool).astype(np.float64)
    b_cnt = reach @ nodes_df[base_col].to_numpy(bool).astype(np.float64)
    safe_n = np.where(n > 0, n, 1.0)
    t = t_cnt / safe_n
    b = b_cnt / safe_n
    value = t * t / (t + b + eps)
    value[n == 0] = 0.0
    nodes_df["hplot_enrichment_index"] = value
    return nodes_df


def _as_reach(reach, n_nodes: int) -> sparse.csr_matrix:
    if sparse.issparse(reach):
        return reach
    rows, cols = [], []
    for i, neigh in enumerate(reach):
        rows.extend([i] * len(neigh))
        cols.extend(neigh)
    return sparse.coo_matrix(
        (np.ones(len(rows), bool), (rows, cols)), shape=(n_nodes, n_nodes)
    ).tocsr()


def identify_region_by_cell_function_enrichment(
    reach: sparse.csr_matrix | list,
    model_output_df: pd.DataFrame,
    N: int,
    R: float,
    max_workers: int | None = None,
) -> pd.DataFrame:
    """is_base_region: >=N k-hop neighbors and base ratio >= R
    (reference: insight_helpers.py:467-531)."""
    del max_workers
    reach = _as_reach(reach, len(model_output_df))
    n = np.asarray(reach.sum(axis=1)).ravel().astype(np.float64)
    b_cnt = reach @ model_output_df["is_base_type"].to_numpy(bool).astype(np.float64)
    ratio = np.divide(b_cnt, n, out=np.zeros_like(b_cnt), where=n > 0)
    model_output_df["is_base_region"] = (n >= N) & (ratio >= R)
    return model_output_df


def identify_border_cells(
    model_output_df: pd.DataFrame,
    adj: sparse.csr_matrix | Dict[int, List[int]],
    max_workers: int | None = None,
) -> pd.DataFrame:
    """is_base_border: base-region cell with a 1-hop non-base-region neighbor
    (reference: insight_helpers.py:571-643)."""
    del max_workers
    if not sparse.issparse(adj):
        adj = _adj_dict_to_csr(adj, len(model_output_df))
    base = model_output_df["is_base_region"].to_numpy(bool)
    non_base_neighbors = adj @ (~base).astype(np.float64)
    model_output_df["is_base_border"] = base & (non_base_neighbors > 0)
    return model_output_df


def _adj_dict_to_csr(adj: Dict[int, List[int]], n: int) -> sparse.csr_matrix:
    rows, cols = [], []
    for node, neigh in adj.items():
        rows.extend([node] * len(neigh))
        cols.extend(neigh)
    return sparse.coo_matrix((np.ones(len(rows), bool), (rows, cols)), shape=(n, n)).tocsr()


def calculate_distance_to_border(
    model_output_df: pd.DataFrame, adj: sparse.csr_matrix | Dict[int, List[int]]
) -> pd.DataFrame:
    """Multi-source BFS hop distance from border cells; negative inside the
    base region (reference: insight_helpers.py:670-709). Frontier sweep over
    the sparse adjacency instead of a Python deque."""
    n = len(model_output_df)
    if not sparse.issparse(adj):
        adj = _adj_dict_to_csr(adj, n)
    dist = np.full(n, np.inf)
    frontier = model_output_df["is_base_border"].to_numpy(bool).copy()
    d = 0
    while frontier.any():
        dist[frontier] = d
        reached = (adj @ frontier.astype(np.float64)) > 0
        frontier = reached & np.isinf(dist)
        d += 1
    model_output_df["distance_to_border"] = dist
    signed = dist.copy()
    signed[model_output_df["is_base_region"].to_numpy(bool)] *= -1
    signed[~np.isfinite(signed)] = np.nan
    model_output_df["hplot_signed_distance_to_border"] = signed
    return model_output_df


def compute_hplot(df_with_distances: pd.DataFrame, filtered_edges_df: pd.DataFrame) -> pd.DataFrame:
    """Per-layer base/target proportions + cumulative physical distance
    (reference: insight_helpers.py:712-812). The O(layers x edges) loop is
    replaced by one groupby over edge layer pairs."""
    d = df_with_distances.dropna(subset=["hplot_signed_distance_to_border"])
    base_prop = d.groupby("hplot_signed_distance_to_border")["is_base_type"].mean()
    target_prop = d.groupby("hplot_signed_distance_to_border")["is_target_type"].mean()

    unique_distances = sorted(d["hplot_signed_distance_to_border"].unique())
    layer_of = df_with_distances["hplot_signed_distance_to_border"]

    # Average edge length between adjacent layers, keyed by the lower layer.
    if len(filtered_edges_df):
        src_layer = layer_of.reindex(filtered_edges_df["source"]).to_numpy()
        dst_layer = layer_of.reindex(filtered_edges_df["target"]).to_numpy()
        lo = np.minimum(src_layer, dst_layer)
        hi = np.maximum(src_layer, dst_layer)
        lengths = filtered_edges_df["length"].to_numpy()
        # lo/hi hold values drawn from unique_distances itself, so their rank
        # is an exact searchsorted into the sorted unique array — adjacency is
        # one vectorised comparison over all edges (million-cell slides have
        # millions of Delaunay edges; a per-edge Python loop dominates the
        # worker runtime).
        ud = np.asarray(unique_distances, np.float64)
        mask = np.isfinite(lo) & np.isfinite(hi)
        adjacent = np.zeros(len(lo), bool)
        idx = np.flatnonzero(mask)
        ri = np.searchsorted(ud, lo[idx])
        rj = np.searchsorted(ud, hi[idx])
        adjacent[idx] = rj == ri + 1
        pairs = pd.DataFrame({"lo": lo[adjacent], "length": lengths[adjacent]})
        avg_between = pairs.groupby("lo")["length"].mean().to_dict()
    else:
        avg_between = {}
    average_edge_length_between_layers = {
        unique_distances[i]: avg_between.get(unique_distances[i], np.nan)
        for i in range(len(unique_distances) - 1)
    }

    # Gap semantics mirror the reference exactly (insight_helpers.py:769-781):
    # a layer with no edge to its neighbour gets NaN (dropped downstream), and
    # `current` is NOT advanced across the gap — the next connected layer
    # continues from the pre-gap total.
    cumulative = {0.0: 0.0}
    current = 0.0
    for sd in sorted(unique_distances):
        if sd > 0:
            prev = unique_distances[unique_distances.index(sd) - 1]
            if prev in average_edge_length_between_layers and np.isfinite(
                average_edge_length_between_layers[prev]
            ):
                current += average_edge_length_between_layers[prev]
                cumulative[sd] = current
            else:
                cumulative[sd] = np.nan
    current = 0.0
    for sd in sorted(unique_distances, reverse=True):
        if sd < 0:
            if sd in average_edge_length_between_layers and np.isfinite(
                average_edge_length_between_layers[sd]
            ):
                current -= average_edge_length_between_layers[sd]
                cumulative[sd] = current
            else:
                cumulative[sd] = np.nan

    plot_df = pd.DataFrame(
        {
            "layer": target_prop.index,
            "base_type_prop": base_prop.values,
            "target_type_prop": target_prop.values,
        }
    )
    plot_df["distance"] = plot_df["layer"].map(pd.Series(cumulative))
    plot_df = plot_df.dropna(subset=["distance"])
    return plot_df.sort_values("layer")


# ----------------------------------------------------------------------------
# H-metrics — border-layer summary scores
#
# Same metric definitions as the reference (insight_helpers.py:815-1020) —
# the numbers are a parity contract — computed here from numpy per-layer
# aggregates with one shared scorer for the intra/peri sides.
# ----------------------------------------------------------------------------

_HMETRIC_COLUMNS = ("layer", "target_type_prop", "base_type_prop", "distance")
_EPS = 1e-6


def _slides_covering_range(
    df: pd.DataFrame, range_min: int | None, range_max: int | None
) -> pd.DataFrame:
    """Keep only slides whose observed layers span [range_min, range_max]."""
    layers = pd.to_numeric(df["layer"], errors="coerce")
    ok = df["id"].notna() & layers.notna()
    if not ok.any():
        return df.iloc[0:0].copy()
    extent = layers[ok].astype(int).groupby(df["id"][ok]).agg(["min", "max"])
    covering = extent.index[(extent["min"] <= range_min) & (extent["max"] >= range_max)]
    return df[df["id"].isin(covering)].copy()


def _clean_rows(df: pd.DataFrame) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Coerce the four metric columns to floats and drop incomplete rows."""
    layer = pd.to_numeric(df["layer"], errors="coerce").to_numpy(dtype=float)
    target = pd.to_numeric(df["target_type_prop"], errors="coerce").to_numpy(dtype=float)
    tumor = pd.to_numeric(df["base_type_prop"], errors="coerce").to_numpy(dtype=float)
    dist = pd.to_numeric(df["distance"], errors="coerce").to_numpy(dtype=float)
    keep = (
        np.isfinite(layer) & np.isfinite(target) & np.isfinite(tumor) & np.isfinite(dist)
    )
    return (
        layer[keep].astype(int),
        np.clip(target[keep], 0.0, 1.0),
        np.clip(tumor[keep], 0.0, 1.0),
        dist[keep],
    )


def _per_layer_mean(layer: np.ndarray, values: np.ndarray) -> pd.Series:
    """Mean of `values` per unique layer, as a layer-indexed Series."""
    levels, inverse = np.unique(layer, return_inverse=True)
    sums = np.bincount(inverse, weights=values)
    counts = np.bincount(inverse)
    return pd.Series(sums / counts, index=levels.astype(int), dtype=float)


def _fill_levels(by_layer: pd.Series, side: str, levels: list[int]) -> pd.Series:
    """Restrict a per-layer series to one side of the border and fill the
    requested level grid from the nearest observed layer."""
    subset = by_layer[by_layer.index <= 0] if side == "inside" else by_layer[by_layer.index >= 1]
    if subset.empty:
        return pd.Series(np.nan, index=levels, dtype=float)
    return subset.sort_index().reindex(levels, method="nearest").astype(float)


def _depth_weights(levels, mode, s, range_min, range_max, side) -> pd.Series:
    levels = list(levels)
    if not levels:
        return pd.Series(dtype=float)
    mode = (mode or "linear").lower()
    lv = np.asarray(levels, dtype=float)
    if mode == "sigmoid":
        w = 1.0 - 1.0 / (1.0 + np.exp(-s * lv))
        return pd.Series(np.clip(w, 0.0, 1.0), index=levels, dtype=float)
    if side == "inside":
        denom = max(abs(int(range_min)), 1)
        w = np.clip(np.abs(lv) / denom, 0.0, 1.0)
    else:
        denom = float(max(int(range_max), 1))
        w = np.clip(1.0 - (lv / denom), 0.0, 1.0)
    return pd.Series(w, index=levels, dtype=float)


def _mass_center(mass: pd.Series, coords: pd.Series) -> float:
    """Coordinate of the center of mass; NaN when there is no positive mass."""
    m = np.asarray(mass.values, dtype=float)
    x = np.asarray(coords.values, dtype=float)
    use = np.isfinite(m) & np.isfinite(x) & (m > 0)
    if not use.any():
        return np.nan
    return float(np.sum(m[use] * x[use]) / np.sum(m[use]))


def _common_scores(
    target: pd.Series, tumor: pd.Series, depth_w: pd.Series
) -> Dict[str, float]:
    """Scores shared by both sides: abundance + the two enrichment indices."""
    abundance = 0.0 if target.empty else float(np.nanmean(target.values))

    # Layerwise: enrichment ratio per layer, averaged with target-mass x
    # depth weights, only over layers where any cells were observed.
    ratio = (target / (target + tumor + _EPS)).clip(0.0, 1.0)
    observed = (target + tumor) > 0
    weight = (target * depth_w).where(observed, np.nan)
    numer = (ratio * weight).where(observed, np.nan)
    nv = np.asarray(numer.values, dtype=float)
    wv = np.asarray(weight.values, dtype=float)
    use = np.isfinite(nv) & np.isfinite(wv) & (wv > 0)
    layerwise = float(np.sum(nv[use]) / np.sum(wv[use])) if use.any() else 0.0

    t_mean = 0.0 if target.empty else float(np.nanmean(target.values))
    b_mean = 0.0 if tumor.empty else float(np.nanmean(tumor.values))
    global_ei = float(t_mean / (t_mean + b_mean + _EPS))
    return {
        "abundance_score": abundance,
        "layerwise_enrichment_index": layerwise,
        "global_enrichment_index": global_ei,
    }


def _intra_scores(
    target: pd.Series, tumor: pd.Series, dist: pd.Series, depth_w: pd.Series,
    range_min: int,
) -> Dict[str, float]:
    out = _common_scores(target, tumor, depth_w)

    # Convergence: signed center of mass of the target distribution over the
    # strictly-inside layers, using |distance| as the coordinate.
    inside = target[target.index < 0]
    depth_mag = (-dist).clip(lower=0.0).reindex(inside.index)
    if len(inside) and float(np.nansum(inside.values)) > 0.0:
        out["convergence_distance"] = -float(_mass_center(inside, depth_mag))
    else:
        out["convergence_distance"] = 0.0

    # Penetration: mean layer depth of the target mass over the full inside
    # grid, normalized by the requested range.
    if len(target) and float(np.nansum(target.values)) > 0.0:
        level_depth = pd.Series(
            np.abs(np.asarray(target.index, dtype=float)), index=target.index
        )
        mean_depth = float(
            np.nansum((level_depth * target).values) / np.nansum(target.values)
        )
        out["penetration_score"] = float(
            np.clip(mean_depth / max(abs(int(range_min)), 1), 0.0, 1.0)
        )
    else:
        out["penetration_score"] = 0.0

    out["weighted_global_enrichment_index"] = (
        out["penetration_score"] * out["global_enrichment_index"]
    )
    return out


def _peri_scores(
    target: pd.Series, tumor: pd.Series, dist: pd.Series, depth_w: pd.Series
) -> Dict[str, float]:
    out = _common_scores(target, tumor, depth_w)

    # Proximity: how close the outside target mass sits to the border —
    # 1 at the border, 0 at the farthest observed layer.
    if float(np.nansum(target.values)) > 0 and len(dist) > 0:
        com = _mass_center(target, dist)
        farthest = float(np.nanmax(dist.values)) or 0.0
        out["proximity_score"] = (
            float(np.clip(1.0 - (com / farthest), 0.0, 1.0)) if farthest > 0 else 1.0
        )
        out["convergence_distance"] = float(com)
    else:
        out["proximity_score"] = 0.0
        out["convergence_distance"] = float(np.nanmax(dist.values)) if len(dist) else 0.0

    out["weighted_global_enrichment_index"] = (
        out["proximity_score"] * out["global_enrichment_index"]
    )
    return out


def _empty_hmetrics() -> Dict[str, Any]:
    base = {
        "convergence_distance": 0.0,
        "abundance_score": 0.0,
        "layerwise_enrichment_index": 0.0,
        "global_enrichment_index": np.nan,
        "weighted_global_enrichment_index": 0.0,
    }
    return {
        "valid": False,
        "intra": {**base, "penetration_score": 0.0},
        "peri": {**base, "proximity_score": 0.0},
    }


def compute_hmetrics(
    hplot_df: pd.DataFrame,
    range_min: int | None,
    range_max: int | None,
    hplot_samples_with_valid_range_only: bool = False,
    depth_weight_mode: str = "linear",
    s: float = 6.0,
) -> Dict[str, Any]:
    """Intra/peri convergence, abundance, penetration/proximity, and
    enrichment indices across border layers."""
    df = hplot_df
    if hplot_samples_with_valid_range_only and ("id" in hplot_df.columns):
        df = _slides_covering_range(hplot_df, range_min, range_max)

    for col in _HMETRIC_COLUMNS:
        if col not in df.columns:
            raise KeyError(f"missing required column '{col}'")

    layer, target, tumor, dist = _clean_rows(df)
    if layer.size == 0 or range_max is None or range_min is None:
        return _empty_hmetrics()

    inside_levels = list(range(0, range_min - 1, -1))
    outside_levels = list(range(1, range_max + 1))

    target_by = _per_layer_mean(layer, target)
    tumor_by = _per_layer_mean(layer, tumor)
    dist_by = _per_layer_mean(layer, dist)

    def side(which: str, levels: list[int]):
        return (
            _fill_levels(target_by, which, levels).clip(0.0, 1.0),
            _fill_levels(tumor_by, which, levels).clip(0.0, 1.0),
            _fill_levels(dist_by, which, levels),
            _depth_weights(levels, depth_weight_mode, s, range_min, range_max, which),
        )

    intra = _intra_scores(*side("inside", inside_levels), range_min=range_min)
    peri = _peri_scores(*side("outside", outside_levels))
    return {
        "valid": (range_min >= int(layer.min())) and (range_max <= int(layer.max())),
        "intra": intra,
        "peri": peri,
    }
