"""The scikit-learn calls on the CME path, in numpy and torch.

The JAX package's CME (``insightlib/cme.py``, ``foundation.py``) calls
scikit-learn for a kNN graph, two clustering scores, the global z-score, a
PCA and KMeans. The port runs where scikit-learn is not installed (the H100
host it is measured on has none), so it keeps its own version of exactly
those calls, each with scikit-learn's semantics:

* ``kneighbors_graph`` (connectivity, ``include_self=False``): squared
  euclidean distances in float64 by the product form on ``device`` (the
  card, unless the caller asks for the CPU), the k + 1 nearest by
  ``topk``, then scikit-learn's rule for dropping the query itself;
* ``normalized_mutual_info_score`` (arithmetic mean of the entropies);
* ``silhouette_score`` with ``sample_size``, its sample drawn from numpy's
  global random state as scikit-learn's ``random_state=None`` does;
* ``StandardScaler``: float64 mean and two-pass variance, the transform in
  the data's float32;
* ``pca_fit_transform``: full SVD by ``torch.linalg.svd`` (in float64)
  with scikit-learn's ``svd_flip`` sign rule on the rows of Vt;
* ``kmeans_labels``: greedy k-means++ and Lloyd's iterations, seeded.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import sparse

_ROWS = 4096  # query rows per distance block on the device (4096 x n float64)

def _sq_dists(a: torch.Tensor, b: torch.Tensor, b_sq: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (float64) of rows of a to rows of b."""
    d = (a * a).sum(1, keepdim=True) - 2.0 * (a @ b.T) + b_sq[None, :]
    return d.clamp_(min=0.0)


def kneighbors_graph(x: np.ndarray, n_neighbors: int,
                     device: torch.device | str = "cpu") -> sparse.csr_matrix:
    """(n, n) CSR connectivity graph of each row's ``n_neighbors`` nearest
    other rows (``sklearn.neighbors.kneighbors_graph(x, n_neighbors,
    mode="connectivity", include_self=False)``)."""
    n = len(x)
    kk = n_neighbors + 1
    if kk > n:
        raise ValueError(f"n_neighbors {n_neighbors} needs more than {n} samples")
    xt = torch.as_tensor(np.asarray(x), device=device).double()
    x_sq = (xt * xt).sum(1)
    cand = np.empty((n, kk), np.int64)
    # a few candidates past the k + 1 nearest, so that distances tied at the
    # boundary go to the lower index, as scikit-learn keeps them
    take = min(n, kk + 8)
    for i0 in range(0, n, _ROWS):
        vals, idx = torch.topk(_sq_dists(xt[i0:i0 + _ROWS], xt, x_sq), take, dim=1,
                               largest=False, sorted=True)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        order = np.lexsort((idx, vals), axis=1)[:, :kk]
        cand[i0:i0 + _ROWS] = np.take_along_axis(idx, order, 1)
    # drop the query itself, or the nearest where it is not among the kk
    mask = cand != np.arange(n)[:, None]
    no_self = mask.all(axis=1)
    mask[no_self, 0] = False
    neigh = cand[mask].reshape(n, n_neighbors)
    rows = np.repeat(np.arange(n), n_neighbors)
    return sparse.csr_matrix((np.ones(n * n_neighbors), (rows, neigh.ravel())), shape=(n, n))


def _entropy(labels: np.ndarray) -> float:
    pi = np.unique(labels, return_counts=True)[1].astype(np.float64)
    if pi.size == 1:
        return 0.0
    total = pi.sum()
    return float(-np.sum((pi / total) * (np.log(pi) - math.log(total))))


def normalized_mutual_info_score(labels_true: np.ndarray, labels_pred: np.ndarray) -> float:
    """NMI with the arithmetic mean of the two entropies."""
    labels_true, labels_pred = np.asarray(labels_true), np.asarray(labels_pred)
    classes, ci = np.unique(labels_true, return_inverse=True)
    clusters, cj = np.unique(labels_pred, return_inverse=True)
    if classes.shape[0] == clusters.shape[0] == 1 or classes.shape[0] == clusters.shape[0] == 0:
        return 1.0
    contingency = sparse.coo_matrix((np.ones(len(ci)), (ci, cj)),
                                    shape=(len(classes), len(clusters))).tocsr()
    contingency.sum_duplicates()
    nzx, nzy, nz_val = sparse.find(contingency)
    total = contingency.sum()
    pi = np.ravel(contingency.sum(axis=1))
    pj = np.ravel(contingency.sum(axis=0))
    if pi.size == 1 or pj.size == 1:
        return 0.0
    log_contingency = np.log(nz_val)
    contingency_nm = nz_val / total
    outer = pi.take(nzx).astype(np.int64) * pj.take(nzy).astype(np.int64)
    log_outer = -np.log(outer) + math.log(pi.sum()) + math.log(pj.sum())
    mi = contingency_nm * (log_contingency - math.log(total)) + contingency_nm * log_outer
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    mi = float(np.clip(mi.sum(), 0.0, None))
    if mi == 0:
        return 0.0
    return float(mi / ((_entropy(labels_true) + _entropy(labels_pred)) / 2.0))


def silhouette_score(x: np.ndarray, labels: np.ndarray, sample_size: int | None = None,
                     device: torch.device | str = "cpu") -> float:
    """Mean silhouette coefficient (euclidean), over a sample of
    ``sample_size`` rows drawn with numpy's global random state."""
    x, labels = np.asarray(x), np.asarray(labels)
    if sample_size is not None:
        idx = np.random.permutation(x.shape[0])[:sample_size]
        x, labels = x[idx], labels[idx]
    _, enc = np.unique(labels, return_inverse=True)
    n = len(enc)
    freqs = np.bincount(enc)
    if not 1 < len(freqs) < n:
        raise ValueError(f"silhouette needs 2 to n_samples - 1 labels, got {len(freqs)}")
    xt = torch.as_tensor(x, device=device).double()
    x_sq = (xt * xt).sum(1)
    lab = torch.as_tensor(enc, device=device)
    onehot = torch.nn.functional.one_hot(lab, len(freqs)).double()
    freqs_t = torch.as_tensor(freqs, device=device, dtype=torch.float64)
    intra, inter = [], []
    for i0 in range(0, n, _ROWS):
        d = _sq_dists(xt[i0:i0 + _ROWS], xt, x_sq).sqrt_()
        rows = torch.arange(d.shape[0], device=device)
        d[rows, rows + i0] = 0.0
        per_cluster = d @ onehot  # (rows, k) summed distances
        own = lab[i0:i0 + _ROWS]
        intra.append(per_cluster[rows, own])
        per_cluster[rows, own] = float("inf")
        inter.append((per_cluster / freqs_t).min(1).values)
    a = torch.cat(intra) / (freqs_t[lab] - 1)
    b = torch.cat(inter)
    s = torch.nan_to_num((b - a) / torch.maximum(a, b))
    return float(s.mean())


class StandardScaler:
    """z-score with scikit-learn's numbers: float64 accumulators, the
    two-pass corrected variance, near-constant features scaled by 1, and the
    transform in the data's dtype (mean and scale cast to it)."""

    def fit(self, x: np.ndarray) -> "StandardScaler":
        x = np.asarray(x)
        n = x.shape[0]
        total = np.sum(x, axis=0, dtype=np.float64)
        self.mean_ = total / n
        temp = x - total / n  # float64
        correction = np.sum(temp, axis=0)
        temp **= 2
        unnormalized = np.sum(temp, axis=0)
        unnormalized -= correction ** 2 / n
        self.var_ = unnormalized / n
        eps = np.finfo(np.float64).eps
        constant = self.var_ <= n * eps * self.var_ + (n * self.mean_ * eps) ** 2
        self.scale_ = np.sqrt(self.var_)
        self.scale_[constant] = 1.0
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        x = np.array(x, copy=True)
        x -= self.mean_.astype(x.dtype)
        x /= self.scale_.astype(x.dtype)
        return x


def pca_fit_transform(x: np.ndarray, n_components: int) -> np.ndarray:
    """PCA scores ``U[:, :k] * S[:k]`` of the centred data, by a full
    ``torch.linalg.svd`` in float64 (returned in the data's dtype), signs by
    ``svd_flip`` with ``u_based_decision=False`` (each row of Vt's largest
    entry positive)."""
    x = np.asarray(x)
    xt = torch.as_tensor(x, dtype=torch.float64)
    xc = xt - xt.mean(0)
    u, s, vt = torch.linalg.svd(xc, full_matrices=False)
    signs = torch.sign(vt[torch.arange(vt.shape[0]), vt.abs().argmax(1)])
    u = u * signs[None, :]
    return (u[:, :n_components] * s[:n_components]).numpy().astype(x.dtype)


def kmeans_labels(x: np.ndarray, n_clusters: int) -> np.ndarray:
    """KMeans labels as scikit-learn's ``KMeans(n_clusters, n_init="auto")``
    computes them (one greedy k-means++ start, at most 300 of Lloyd's
    iterations, until the labels repeat or the centres move less than 1e-4
    times the mean feature variance), from a generator seeded with 0."""
    x = np.asarray(x, np.float64)
    n = len(x)
    rng = np.random.default_rng(0)
    x_sq = (x * x).sum(1)

    def sq_to(c):
        return np.maximum((c * c).sum(1)[:, None] - 2.0 * c @ x.T + x_sq[None, :], 0.0)

    trials = 2 + int(np.log(n_clusters))
    centers = [x[rng.integers(n)]]
    closest = sq_to(centers[0][None])[0]
    pot = closest.sum()
    for _ in range(1, n_clusters):
        ids = np.searchsorted(np.cumsum(closest), rng.uniform(size=trials) * pot)
        ids = np.clip(ids, None, n - 1)
        dist = np.minimum(closest, sq_to(x[ids]))
        best = int(np.argmin(dist.sum(1)))
        closest, pot = dist[best], dist[best].sum()
        centers.append(x[ids[best]])
    centers = np.stack(centers)
    tol = 1e-4 * np.mean(np.var(x, axis=0))
    labels = None
    for _ in range(300):
        new = np.argmin(sq_to(centers), axis=0)
        if labels is not None and np.array_equal(new, labels):
            break
        labels = new
        moved = centers.copy()
        for c in range(n_clusters):
            members = labels == c
            if members.any():
                moved[c] = x[members].mean(0)
        shift = ((moved - centers) ** 2).sum()
        centers = moved
        if shift <= tol:
            labels = np.argmin(sq_to(centers), axis=0)
            break
    return labels.astype(np.int32)
