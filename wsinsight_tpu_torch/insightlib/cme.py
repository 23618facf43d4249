"""Cellular-microenvironment (CME) analytics: graph features, DGI embeddings,
clustering, and per-cell / region outputs.

Counterpart of wsinsight_tpu/insightlib/cme.py, which re-creates the
reference pipeline (reference: wsinsight/insightlib/cme_generation.py:698-1307)
in five phases:

1. per-slide graph build — Delaunay edges with a distance cap, isolated-node
   drop, EXACT-hop composition features with Laplace smoothing. The per-node
   BFS fan-out (reference: cme_generation.py:268-414) becomes sparse boolean
   matrix powers: ring_h = reach(<=h) & ~reach(<=h-1), aggregated with one
   sparse matmul per hop.
2. shared DGI/GCN encoder trained across slide graphs — torch and
   ``torch.optim.Adam`` on the cards (insightlib/gnn.py), graphs padded to a
   common static shape, the graph batch split over the devices.
3. cluster-count estimation: kNN graph + Leiden sweep over resolutions x
   repeats, winner by (stability NMI, modularity, silhouette) with a
   min-cluster-fraction filter (reference: :799-990). Leiden is the in-house
   native implementation (native/leiden.cpp), with no fallback: a library
   that does not build raises. The kNN graph runs on the card. Else KMeans
   with given k.
4. per-cell CSVs with feature_raw_k*/feature_normalized_k* + one-hot cme_*.
5. annotation-level region merge via capped Voronoi (insightlib/voronoi.py).

Caches: slide-graphs.joblib and dgi-embeddings.joblib (resume contract,
reference: :1092-1105), written as plain pickles (``joblib.load`` reads
them). The scikit-learn calls are the port's own (``insightlib/stats.py``):
neither scikit-learn nor joblib is needed (the H100 host the port is
measured on has neither).
"""

from __future__ import annotations

import copy
import os
import pickle
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import pandas as pd
import torch
from scipy import sparse
from tqdm import tqdm

from .. import errors
from ..parallel.mesh import resolve_device, resolve_devices
from ..uri_path import URIPath
from ..utils.profiling import hot_stage
from ..wsi import _validate_wsi_directory, get_avg_mpp
from . import stats
from .helpers import compute_cell_center_points, delaunay_triangulation


def _dump(obj: Any, path: Path) -> None:
    with open(path, "wb") as fh:
        pickle.dump(obj, fh, protocol=pickle.HIGHEST_PROTOCOL)


def _load(path: Path) -> Any:
    with open(path, "rb") as fh:
        return pickle.load(fh)


# ---------------------------------------------------------------------------
# Phase 1: slide graph construction
# ---------------------------------------------------------------------------


def probs_from_df(df: pd.DataFrame, class_order: Optional[List[str]] = None):
    """Per-cell class probabilities from prob_* columns -> ([N,C], classes)."""
    if class_order is not None:
        cols = [f"prob_{c}" if not c.startswith("prob_") else c for c in class_order]
    else:
        cols = [c for c in df.columns if c.startswith("prob_")]
    p = df[cols].to_numpy(np.float32)
    p = np.clip(p, 0.0, None)
    rowsum = p.sum(axis=1, keepdims=True)
    rowsum[rowsum == 0] = 1.0
    return p / rowsum, cols


def to_edge_index(
    edges_df: pd.DataFrame,
    src_col: str = "source",
    dst_col: str = "target",
    undirected: bool = True,
    drop_self_loops: bool = True,
) -> np.ndarray:
    u = edges_df[src_col].to_numpy(np.int64)
    v = edges_df[dst_col].to_numpy(np.int64)
    if drop_self_loops:
        keep = u != v
        u, v = u[keep], v[keep]
    if undirected:
        src = np.concatenate([u, v])
        dst = np.concatenate([v, u])
    else:
        src, dst = u, v
    pairs = np.unique(np.stack([src, dst], axis=1), axis=0)
    return pairs.T.astype(np.int64)


def drop_isolated(edge_index: np.ndarray, n: int):
    """Remove nodes with no edges; remap indices. Returns (edges, kept_idx)."""
    if edge_index.size == 0:
        return edge_index, np.zeros(0, np.int64)
    used = np.zeros(n, bool)
    used[edge_index[0]] = True
    used[edge_index[1]] = True
    kept_idx = np.flatnonzero(used)
    remap = -np.ones(n, np.int64)
    remap[kept_idx] = np.arange(len(kept_idx))
    return remap[edge_index], kept_idx


def khop_features(
    P: np.ndarray,
    edge_index: np.ndarray,
    N: int,
    k: int = 2,
    alpha: float = 1.0,
    mode: str = "soft",
) -> np.ndarray:
    """EXACT-hop composition features [N, (k+1)*C] via sparse ring algebra.

    soft: hop-0 = P[i]; hop-h = Laplace-smoothed mean of P over the exact-h
    ring. hard: one-hot argmax / smoothed label histogram. Empty ring ->
    uniform 1/C (reference semantics, cme_generation.py:268-414).
    """
    n_nodes, c = P.shape
    assert n_nodes == N, "P and N mismatch"

    if mode == "hard":
        labels = P.argmax(axis=1)
        feats = np.zeros((N, c), np.float32)
        feats[np.arange(N), labels] = 1.0
    else:
        feats = P.astype(np.float32)

    X = np.zeros((N, (k + 1) * c), np.float32)
    X[:, :c] = feats

    if edge_index.size == 0:
        for h in range(1, k + 1):
            X[:, h * c : (h + 1) * c] = 1.0 / c
        return X

    adj = sparse.coo_matrix(
        (np.ones(edge_index.shape[1], bool), (edge_index[0], edge_index[1])),
        shape=(N, N),
    ).tocsr()
    eye = sparse.identity(N, dtype=bool, format="csr")
    reach_prev = eye  # reach(<=0)
    reach_cur = ((adj + eye) > 0).tocsr()  # reach(<=1)
    for h in range(1, k + 1):
        ring = (reach_cur.astype(np.int8) - reach_prev.astype(np.int8)) > 0
        ring = ring.tocsr().astype(np.float32)
        counts = np.asarray(ring.sum(axis=1)).ravel()
        sums = ring @ feats
        safe = np.where(counts > 0, counts, 1.0)[:, None]
        mean = sums / safe
        smoothed = (mean + alpha / c) / (1.0 + alpha)
        block = np.where(counts[:, None] > 0, smoothed, 1.0 / c).astype(np.float32)
        X[:, h * c : (h + 1) * c] = block
        if h < k:
            reach_prev = reach_cur
            reach_cur = ((reach_cur @ ((adj + eye) > 0)) > 0).tocsr()
    return X


def build_slide_graph(
    cme_detection_df: pd.DataFrame,
    mpp_um_per_px: float,
    max_edge_len_um: float,
    class_order: Optional[List[str]] = None,
    k_hops: int = 2,
    alpha: float = 1.0,
    mode: str = "hard",
) -> tuple[Dict[str, Any], np.ndarray]:
    """Phase 1 on the host: the slide graph (X, the k-hop composition block;
    edge_index, kept_idx, classes, edges_df) and the kept cells' centres in
    microns, which the foundation block reads."""
    df = compute_cell_center_points(cme_detection_df.copy())
    centers_px = df[["center_x", "center_y"]].to_numpy(np.float32)
    n = len(df)
    max_edge_len_px = float(max_edge_len_um) / float(mpp_um_per_px)
    edges_df = delaunay_triangulation(centers_px, max_edge_len_px)

    edge_index = to_edge_index(edges_df)
    edge_index, kept_idx = drop_isolated(edge_index, n)
    if kept_idx.size == 0:
        raise ValueError("All nodes are isolated after distance cap; nothing to train.")

    p_all, classes = probs_from_df(df, class_order=class_order)
    p = p_all[kept_idx]
    x = khop_features(P=p, edge_index=edge_index, N=len(kept_idx), k=k_hops, alpha=alpha,
                      mode=mode)
    graph = {
        "X": x.astype(np.float32),
        "edge_index": edge_index.astype(np.int64),
        "kept_idx": kept_idx.astype(np.int64),
        "classes": classes,
        "edges_df": edges_df,
    }
    return graph, centers_px[kept_idx] * float(mpp_um_per_px)


def add_foundation_block(
    graph: Dict[str, Any],
    coords_um: np.ndarray,
    patch_source=None,
    feature_extractor=None,
    **block_kw,
) -> None:
    """Concatenate the foundation-model feature block to ``graph["X"]``, in
    place: a sampled subset of cells is embedded (``feature_extractor``;
    defaults to the port's H-Optimus on the card), PCA-reduced, and
    Gaussian-KNN-imputed to every kept cell in micron space (reference:
    cme_generation.py:436-490,753-782). ``patch_source`` supplies per-cell
    crops (insightlib/foundation.py); ``block_kw`` goes to
    ``foundation_feature_block``."""
    from .foundation import foundation_feature_block

    block = foundation_feature_block(coords_um, graph["kept_idx"], patch_source,
                                     feature_extractor, **block_kw)
    graph["X"] = np.hstack([graph["X"], block]).astype(np.float32)


def prepare_slide_graph(
    cme_detection_df: pd.DataFrame,
    mpp_um_per_px: float,
    max_edge_len_um: float,
    class_order: Optional[List[str]] = None,
    k_hops: int = 2,
    alpha: float = 1.0,
    mode: str = "hard",
    use_hoptimus: bool = False,
    patch_source=None,
    feature_extractor=None,
    sample_frac: Optional[float] = 0.2,
    sample_count: Optional[int] = None,
    pca_dim: Optional[int] = 128,
    knn_k: int = 3,
    knn_sigma_um: float = 60.0,
    seed: int = 0,
    **_unused,
) -> Dict[str, Any]:
    """Build one slide graph: X, edge_index, kept_idx, classes, edges_df.

    With ``use_hoptimus`` the k-hop composition block is concatenated with a
    foundation-model feature block (``add_foundation_block``).
    """
    graph, coords_um = build_slide_graph(cme_detection_df, mpp_um_per_px, max_edge_len_um,
                                         class_order, k_hops, alpha, mode)
    if use_hoptimus:
        add_foundation_block(graph, coords_um, patch_source, feature_extractor,
                             sample_frac=sample_frac, sample_count=sample_count,
                             pca_dim=pca_dim, knn_k=knn_k, knn_sigma_um=knn_sigma_um,
                             seed=seed)
    return graph


# ---------------------------------------------------------------------------
# Phase 2: DGI training (torch, padded graphs, over the devices)
# ---------------------------------------------------------------------------


def train_dgi_multi(
    slides: List[Dict[str, Any]],
    hidden: int = 64,
    out_dim: int = 32,
    epochs: int = 300,
    lr: float = 1e-3,
    seed: int = 0,
    max_nodes_cap: int = 16384,
    max_edges_cap: int = 131072,
    device: torch.device | str | None = None,
    devices: List[torch.device | str] | None = None,
):
    """Train one shared DGI encoder over all slide graphs; return (state, Z_list).

    Graphs larger than `max_nodes_cap` are trained on node-induced random
    subgraphs (Cluster-GCN style) so device memory stays bounded for
    million-cell slides; final embeddings are computed EXACTLY on the full
    graph with host sparse algebra (gnn.embed_full_graph). The subgraphs and
    the corruption permutations come from ``np.random.default_rng(seed)``,
    drawn in the JAX package's order; the initial weights from ``DGI``'s
    seeded generator. Returns the trained state dict (on the host) and the
    embeddings.

    The devices are ``parallel.mesh.resolve_devices``'s (every visible card
    unless ``device`` or ``devices`` says otherwise). Over several, the graph
    batch is padded by repetition to a multiple of their count and split
    into shards, as the JAX package's mesh step takes it; one device gets
    the whole batch as its one shard.
    """
    from .gnn import DGI, embed_full_graph, make_dgi_train_step, pad_graph, sample_subgraph

    devs = resolve_devices(devices, device)
    n_dev = len(devs)

    def _round_up(v, m):
        return -(-v // m) * m

    max_nodes = _round_up(
        min(max(s["X_normalized"].shape[0] for s in slides) + 1, max_nodes_cap), 8
    )
    max_edges = _round_up(
        min(max(max(s["edge_index"].shape[1], 1) for s in slides), max_edges_cap), 8
    )

    rng = np.random.default_rng(seed)

    def graph_batch():
        padded = []
        for s in slides:
            if s["X_normalized"].shape[0] + 1 <= max_nodes:
                padded.append(
                    pad_graph(s["X_normalized"], s["edge_index"], max_nodes, max_edges)
                )
            else:
                padded.append(
                    sample_subgraph(
                        s["X_normalized"], s["edge_index"], max_nodes, max_edges, rng
                    )
                )
        return padded

    n_graphs = len(slides)
    # pad the graph batch by repetition to a multiple of the device count
    reps = [i % n_graphs for i in range(_round_up(n_graphs, n_dev))]

    def put(arrays, dtype):
        """The batch's stacked ``arrays`` in equal shards, shard i on device i."""
        host = torch.from_numpy(np.stack(arrays)[reps])
        return [blk.to(d, dtype, non_blocking=True)
                for blk, d in zip(host.split(len(reps) // n_dev), devs)]

    def to_device(padded):
        return (
            put([g.x for g in padded], torch.float32),
            put([g.edges for g in padded], torch.int64),
            put([g.edge_mask for g in padded], torch.float32),
            put([g.node_mask for g in padded], torch.float32),
            # halo-aware samples restrict the loss to interior nodes
            put([g.loss_mask if g.loss_mask is not None else g.node_mask for g in padded],
                torch.float32),
        )

    def corrupt(x, perm):
        return torch.take_along_dim(x, perm.to(x.device)[:, :, None], dim=1)

    padded = graph_batch()
    model = DGI(padded[0].x.shape[1], hidden=hidden, out_dim=out_dim, seed=seed).to(devs[0])
    replicas = [copy.deepcopy(model).to(d) for d in devs[1:]]
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    train_step = make_dgi_train_step(model, opt, replicas)

    any_sampled = any(s["X_normalized"].shape[0] + 1 > max_nodes for s in slides)
    batch = to_device(padded)
    for _epoch in range(epochs):
        if any_sampled and _epoch > 0:
            padded = graph_batch()  # fresh subgraphs each epoch
            batch = to_device(padded)
        x, edges, em, nm, lm = batch
        # Corruption: per-graph node-feature row shuffle (DGI convention),
        # restricted to the REAL rows — shuffling the zero padding into real
        # node slots would make the negatives trivially separable for graphs
        # much smaller than max_nodes.
        perms = []
        for g in padded:
            p = np.arange(max_nodes)
            n_real = int(g.node_mask.sum())
            if n_real > 1:
                p[:n_real] = rng.permutation(n_real)
            perms.append(p)
        perm = put(perms, torch.int64)
        xc = [corrupt(*a) for a in zip(x, perm)]
        train_step(x, xc, edges, em, nm, lm)

    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    with hot_stage("cme.embed_full_graph"):
        z_list = [embed_full_graph(state, s["X_normalized"], s["edge_index"]) for s in slides]
    return state, z_list


# ---------------------------------------------------------------------------
# Phase 3: cluster-count estimation (kNN graph + Leiden sweep)
# ---------------------------------------------------------------------------


def _leiden_partition(
    edges: np.ndarray, n_nodes: int, resolution: float, seed: int
) -> tuple[np.ndarray, float]:
    """One Leiden run: (labels, gamma=1 modularity).

    The in-house native Leiden (native/leiden.cpp; the same algorithm family
    the reference gets from igraph/leidenalg, reference:
    cme_generation.py:812-826). It reports STANDARD (gamma=1) modularity
    whatever the optimisation resolution, as the reference ranks resolutions
    by leidenalg's ``part.modularity`` (cme_generation.py:826). Unlike the
    JAX package, there is no networkx Louvain fallback: a library that does
    not build or load raises.
    """
    from ..native import leiden_native

    return leiden_native(edges, n_nodes, resolution, seed)


def _leiden_sweep(
    z: np.ndarray,
    resolutions: Iterable[float],
    n_repeats: int = 5,
    k_nn: int = 15,
    device: torch.device | str | None = None,
) -> Dict[str, Any]:
    """Leiden sweep over resolutions x repeats.

    The kNN graph and the silhouettes are computed on ``device`` (the card
    unless the caller asks for the CPU). Runs fan out across threads — the
    native Leiden call releases the GIL — replacing the reference's per-run
    process pool (cme_generation.py:896-906).
    """
    from concurrent.futures import ThreadPoolExecutor

    from .stats import kneighbors_graph, normalized_mutual_info_score, silhouette_score

    dev = resolve_device(device)
    a = kneighbors_graph(z, n_neighbors=min(k_nn, len(z) - 1), device=dev)
    a = a.maximum(a.T).tocoo()
    keep = a.row < a.col
    edges = np.stack([a.row[keep], a.col[keep]], axis=1).astype(np.int64)

    resolutions = [float(r) for r in resolutions]
    tasks = [(r, rep) for r in resolutions for rep in range(n_repeats)]
    # Governor clamp, mirroring the reference's governed Leiden sweep pool
    # (num_worker_optimizer.py:74-165 via cme_generation.py:896-906).
    from ..utils.workers import governed_workers

    n_workers = governed_workers(min(8, max(1, (os.cpu_count() or 1) - 1)))
    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        runs_flat = list(
            ex.map(
                lambda t: _leiden_partition(edges, len(z), t[0], seed=t[1]), tasks
            )
        )
    runs_by_r: Dict[float, list] = {}
    for (r, _rep), run in zip(tasks, runs_flat):
        runs_by_r.setdefault(r, []).append(run)

    logs = []
    for r in resolutions:
        runs = runs_by_r[r]
        best_labels, best_mod = max(runs, key=lambda t: t[1])
        nmis = []
        if len(np.unique(best_labels)) > 1:
            for lab, _ in runs:
                if len(np.unique(lab)) > 1:
                    nmis.append(normalized_mutual_info_score(lab, best_labels))
        stability = float(np.mean(nmis)) if nmis else 0.0
        if len(np.unique(best_labels)) > 1:
            sil = float(
                silhouette_score(
                    z, best_labels, sample_size=int(min(len(z), 10000)), device=dev
                )
            )
        else:
            sil = -1.0
        counts = np.bincount(best_labels)
        min_frac = float(counts.min() / counts.sum()) if counts.size else 0.0
        logs.append(
            {
                "resolution": float(r),
                "n_clusters": int(len(np.unique(best_labels))),
                "modularity": float(best_mod),
                "stability": stability,
                "silhouette": sil,
                "min_frac": min_frac,
                "labels": best_labels,
            }
        )
    filtered = [d for d in logs if d["min_frac"] >= 0.005] or logs
    winner = sorted(
        filtered, key=lambda d: (d["stability"], d["modularity"], d["silhouette"]), reverse=True
    )[0]
    return {"winner": winner, "all": logs}


def estimate_cmes_from_Z_list(
    z_list: List[np.ndarray],
    mode: str = "global",
    k_nn: int = 15,
    cme_clustering_resolutions: Iterable[float] = np.arange(0.2, 2.05, 0.1),
    n_repeats: int = 5,
    device: torch.device | str | None = None,
) -> Dict[str, Any]:
    """Global (or per-slide) Leiden sweep over embeddings."""
    if mode != "global":
        raise ValueError("only mode='global' is supported (matches the CLI path)")
    offsets = np.cumsum([0] + [z.shape[0] for z in z_list[:-1]])
    z_all = np.vstack(z_list)
    sweep = _leiden_sweep(z_all, cme_clustering_resolutions, n_repeats=n_repeats, k_nn=k_nn,
                          device=device)
    w = sweep["winner"]
    labels_all = w["labels"]
    labels_list = [labels_all[off : off + len(z)] for off, z in zip(offsets, z_list)]
    return {
        "clusters_k": w["n_clusters"],
        "labels_list": labels_list,
        "winner": w,
        "all_results": sweep["all"],
    }


# ---------------------------------------------------------------------------
# Main orchestration
# ---------------------------------------------------------------------------


def cme_generation(
    wsi_dir=None,
    wsi_paths=None,
    results_dir=None,
    max_edge_len_um: float = 25.0,
    max_cell_radius_um: float = 15.0,
    class_order: Optional[List[str]] = None,
    k_hops: int = 2,
    alpha: float = 1.0,
    use_hoptimus: bool = False,
    patch_datasets=None,
    sample_frac: Optional[float] = 0.2,
    sample_count: Optional[int] = None,
    pca_dim: Optional[int] = 128,
    knn_k: int = 3,
    knn_sigma_um: float = 60.0,
    hidden: int = 64,
    out_dim: int = 32,
    epochs: int = 300,
    cme_cellular: bool = False,
    cme_annotation: bool = False,
    cme_clustering_k: int | None = 10,
    cme_clustering_resolutions: "List[float] | str" = (0.5, 1.0, 2.0),
    cme_soft_mode: bool = False,
    feature_extractor=None,
    device: torch.device | str | None = None,
) -> None:
    """Build slide graphs, train DGI, cluster, and write per-cell/region CSVs.

    ``patch_datasets`` (per-slide cell-crop sources, insightlib/foundation.py)
    and ``feature_extractor`` feed the H-Optimus branch; when
    ``use_hoptimus`` is set and no patch source is given, real crops are
    read from each slide around the detected cell centres. ``device`` runs
    the DGI training, the kNN graph and the silhouettes (the card unless the
    caller asks for the CPU; ``WSINFER_FORCE_CPU`` too); with none given the
    DGI trains on every visible card, as the JAX package's does on its mesh.
    """
    dgi_device, device = device, resolve_device(device)

    if isinstance(cme_clustering_resolutions, str):
        cme_clustering_resolutions = [
            float(v) for v in cme_clustering_resolutions.split(",") if v.strip()
        ]

    if wsi_paths is None:
        if wsi_dir is None:
            raise errors.WholeSlideImageDirectoryNotFound("cme_generation needs wsi_dir or wsi_paths")
        wsi_dir = URIPath(wsi_dir)
        if not wsi_dir.exists():
            raise errors.WholeSlideImageDirectoryNotFound(f"directory not found: {wsi_dir}")
        _validate_wsi_directory(wsi_dir)
        wsi_paths = [p for p in wsi_dir.iterdir() if p.is_file()]
    wsi_paths = [URIPath(p) for p in wsi_paths]
    if not wsi_paths:
        raise errors.WholeSlideImagesNotFound(str(wsi_dir))

    results_dir = URIPath(results_dir)
    model_output_dir = results_dir / "model-outputs-csv"
    if not model_output_dir.exists():
        raise errors.ResultsDirectoryNotFound(
            "The 'model-outputs-csv' directory was not found in results directory."
        )
    pairs = []
    for p in wsi_paths:
        csv = model_output_dir / f"{p.stem}.csv"
        if csv.exists():
            pairs.append((p, csv))
    if not pairs:
        raise errors.ResultsDirectoryNotFound("no model-output CSVs matched the slides")

    cme_output_dir = results_dir / "cme-outputs-csv"
    cme_cells_output_dir = cme_output_dir / "cells"
    cme_cmes_output_dir = cme_output_dir / "cmes"
    for d in (cme_output_dir, cme_cells_output_dir, cme_cmes_output_dir):
        d.mkdir(exist_ok=True, parents=True)
    cme_slide_graph_file = Path(str(results_dir / "slide-graphs.joblib"))
    cme_dgi_embeddings_file = Path(str(results_dir / "dgi-embeddings.joblib"))

    # Phase 1: slide graphs (joblib cache).
    if cme_slide_graph_file.exists():
        print(f"Phase 1/5: load cached slide graphs: {cme_slide_graph_file}")
        cached = _load(cme_slide_graph_file)
        if isinstance(cached, dict):
            slides = cached["slides"]
            # Re-align pairs with the cached cohort: slides[i] must describe
            # pairs[i] in Phases 4/5, and the cached build may have skipped
            # bad slides that are still present in the directory listing.
            by_stem = {p[0].stem: p for p in pairs}
            try:
                pairs = [by_stem[stem] for stem in cached["stems"]]
            except KeyError as missing:
                raise errors.WsinsightException(
                    f"cached slide graphs reference slide {missing} which is"
                    f" no longer in the inputs; delete {cme_slide_graph_file}"
                    " to rebuild"
                ) from None
        else:  # legacy cache: a bare list, only safe if nothing was skipped
            slides = cached
            if len(slides) != len(pairs):
                raise errors.WsinsightException(
                    f"cached slide graphs ({len(slides)}) do not match the"
                    f" current inputs ({len(pairs)});"
                    f" delete {cme_slide_graph_file} to rebuild"
                )
    else:
        print("Phase 1/5: build slide graphs")
        foundation_kw = dict(sample_frac=sample_frac, sample_count=sample_count,
                             pca_dim=pca_dim, knn_k=knn_k, knn_sigma_um=knn_sigma_um)
        slides = []
        good_pairs = []
        for slide_i, (wsi_path, csv_path) in enumerate(tqdm(pairs, desc="Graphs")):
            df = pd.read_csv(csv_path.materialize())
            mpp = get_avg_mpp(wsi_path)
            patch_source = None
            if use_hoptimus:
                if patch_datasets is not None:
                    patch_source = patch_datasets[slide_i]
                else:
                    from ..wsi import get_wsi_cls
                    from .foundation import SlideCropSource

                    cdf = compute_cell_center_points(df.copy())
                    patch_source = SlideCropSource(
                        get_wsi_cls()(str(wsi_path.materialize())),
                        cdf[["center_x", "center_y"]].to_numpy(np.int64),
                    )
            try:
                with hot_stage("cme.graph_build"):
                    graph, coords_um = build_slide_graph(
                        df,
                        mpp_um_per_px=mpp,
                        max_edge_len_um=max_edge_len_um,
                        class_order=class_order,
                        k_hops=k_hops,
                        alpha=alpha,
                        mode="soft" if cme_soft_mode else "hard",
                    )
            except Exception as err:
                # One bad slide (isolated cells under the edge cap, collinear
                # centers raising QhullError, malformed CSV columns, ...)
                # should not kill the cohort. Only the host graph build is
                # guarded: the foundation block below runs the port's ViT
                # (and K2) on the card, and its failures raise.
                print(f"Skipping {wsi_path.stem}: {err!r}")
                continue
            if use_hoptimus:
                if feature_extractor is None:
                    from .foundation import default_foundation_extractor

                    feature_extractor = default_foundation_extractor()
                with hot_stage("cme.foundation_block"):
                    add_foundation_block(graph, coords_um, patch_source, feature_extractor,
                                         **foundation_kw)
            slides.append(graph)
            good_pairs.append((wsi_path, csv_path))
        pairs = good_pairs
        if not slides:
            raise errors.WsinsightException(
                "No usable slide graphs (all cells isolated under the"
                f" {max_edge_len_um} um edge cap — CME expects cell-level"
                " model outputs, e.g. CellViT detections)."
            )
        # Global z-score across slides (reference: :1196-1203).
        x_all = np.vstack([s["X"] for s in slides]).astype(np.float32)
        scaler = stats.StandardScaler().fit(x_all)
        for s in slides:
            s["X_normalized"] = scaler.transform(s["X"]).astype(np.float32)
        # stems pin slides[i] <-> pairs[i] across resumed runs (the build may
        # have skipped slides that a later run would otherwise re-include)
        _dump({"slides": slides, "stems": [p[0].stem for p in pairs]}, cme_slide_graph_file)

    # Phase 2: DGI embeddings (joblib cache).
    if cme_dgi_embeddings_file.exists():
        print(f"Phase 2/5: load cached DGI embeddings: {cme_dgi_embeddings_file}")
        z_list = _load(cme_dgi_embeddings_file)
        if len(z_list) != len(slides):
            raise errors.WsinsightException(
                f"cached DGI embeddings ({len(z_list)}) do not match the slide"
                f" graphs ({len(slides)}); delete {cme_dgi_embeddings_file}"
                " to retrain"
            )
    else:
        print("Phase 2/5: train shared DGI encoder")
        with hot_stage("cme.dgi"):
            _, z_list = train_dgi_multi(slides, hidden=hidden, out_dim=out_dim, epochs=epochs,
                                        device=dgi_device)
        _dump(z_list, cme_dgi_embeddings_file)

    # Phase 3: clustering.
    if not cme_clustering_k:
        print("Phase 3/5: estimate CME cluster count (Leiden sweep)")
        with hot_stage("cme.leiden_sweep"):
            res = estimate_cmes_from_Z_list(
                z_list,
                mode="global",
                cme_clustering_resolutions=cme_clustering_resolutions,
                k_nn=15,
                device=device,
            )
        cme_clustering_k = res["winner"]["n_clusters"]
        labels_list = res["labels_list"]
    else:
        print(f"Phase 3/5: KMeans with k={cme_clustering_k}")
        # Per-slide KMeans mirrors the reference exactly
        # (cme_generation.py:1240-1244): with a user-given k, cluster ids are
        # per-slide and NOT comparable across slides; the sweep path (k=None)
        # is the one that clusters the concatenated cohort globally. The JAX
        # package's scikit-learn KMeans draws unseeded; the port's is seeded.
        labels_list = [stats.kmeans_labels(z, min(cme_clustering_k, len(z))) for z in z_list]

    # Phase 4: per-cell outputs.
    if cme_cellular:
        print("Phase 4/5: cellular-level CME outputs")
        for i, (wsi_path, csv_path) in enumerate(tqdm(pairs, desc="Cells")):
            cell_csv = cme_cells_output_dir / f"{wsi_path.stem}.csv"
            if cell_csv.exists():
                continue
            df = pd.read_csv(csv_path.materialize())
            classes = slides[i]["classes"]
            kept = slides[i]["kept_idx"]
            feat_cols = [
                f"feature_raw_k{k}_{c.replace('prob_', '')}"
                for k in range(k_hops + 1)
                for c in classes
            ]
            featn_cols = [
                f"feature_normalized_k{k}_{c.replace('prob_', '')}"
                for k in range(k_hops + 1)
                for c in classes
            ]
            # the k-hop composition block: with use_hoptimus, X goes on with
            # the foundation block, which has no columns here (the JAX
            # package assigns the whole X to these columns and raises there)
            n_khop = len(feat_cols)
            df.loc[kept, featn_cols] = slides[i]["X_normalized"][:, :n_khop]
            df.loc[kept, feat_cols] = slides[i]["X"][:, :n_khop]
            cme_cols = [f"cme_{lv}" for lv in range(cme_clustering_k)]
            one_hot = np.eye(cme_clustering_k, dtype=np.float32)[labels_list[i]]
            df.loc[kept, cme_cols] = one_hot
            with cell_csv.open("w") as fh:
                df.to_csv(fh, index=False)

    # Phase 5: annotation-level region merge.
    if cme_annotation:
        print("Phase 5/5: annotation-level CME regions")
        from .voronoi import merge_same_label_by_shared_edges_iterative, remap_edges_to_valid_indices

        for i, (wsi_path, csv_path) in enumerate(tqdm(pairs, desc="Regions")):
            cell_csv = cme_cells_output_dir / f"{wsi_path.stem}.csv"
            cme_csv = cme_cmes_output_dir / f"{wsi_path.stem}.csv"
            if cme_csv.exists() or not cell_csv.exists():
                continue
            mpp = get_avg_mpp(wsi_path)
            cme_detection_df = pd.read_csv(cell_csv.materialize())
            valid_mask = np.zeros(len(cme_detection_df), bool)
            valid_mask[np.asarray(slides[i]["kept_idx"], int)] = True
            edges_df = remap_edges_to_valid_indices(slides[i]["edges_df"], valid_mask)
            with hot_stage("cme.voronoi_merge"):
                region_df = merge_same_label_by_shared_edges_iterative(
                    cme_detection_df,
                    edges_df,
                    cme_clustering_k=cme_clustering_k,
                    mpp=mpp,
                    max_radius_um=max_cell_radius_um,
                    # edges_df above is remapped with THIS run's kept mask;
                    # pass the same index space rather than re-deriving it
                    # from the (possibly resumed/stale) cell CSV's cme_ columns
                    kept_idx=np.asarray(slides[i]["kept_idx"], int),
                )
            with cme_csv.open("w") as fh:
                region_df.to_csv(fh, index=False)
