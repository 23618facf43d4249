"""Graph neural nets for CME analytics: GCN encoder + DeepGraphInfomax, in torch.

Counterpart of wsinsight_tpu/insightlib/gnn.py (the reference's
torch_geometric stack: a 2-layer GCNConv encoder with PReLU, DGI with a
bilinear discriminator and row-shuffle corruption, Adam). Graphs are padded
to static (max_nodes, max_edges) shapes as in the JAX package; message
passing is ``index_add_`` over the edge arrays (a plain torch scatter: the
JAX one is XLA's ``segment_sum``, not a Pallas kernel). Module and parameter
names are the flax ones (``encoder.conv1.lin``, ``encoder.prelu1``,
``weight``), so a flax ``DGI.init`` tree carried across by
``models.convert.flax_params_to_state_dict`` loads with ``strict=True``.
``make_dgi_train_step`` trains over several devices as the JAX package's
step does over its mesh: the graph batch split into shards, the gradients
summed, one Adam step, the weights copied back to every replica.
``pad_graph``, ``sample_subgraph`` and ``embed_full_graph`` are the JAX
package's numpy, copied (``sample_subgraph`` gathers a BFS frontier's
neighbours in one indexing step instead of a list of slices: the same
arrays from the same generator).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import on_device


@dataclass
class PaddedGraph:
    """One graph padded to static shapes.

    x: (max_nodes, F); edges: (2, max_edges) int32 (src, dst) with padding
    edges pointing at node max_nodes-1 padded slot masked out by edge_mask.
    """

    x: np.ndarray
    edges: np.ndarray
    node_mask: np.ndarray  # (max_nodes,) float32 1=real (participates in propagation)
    edge_mask: np.ndarray  # (max_edges,) float32 1=real
    loss_mask: np.ndarray | None = None  # (max_nodes,) 1=contributes to the DGI loss


def pad_graph(
    x: np.ndarray, edge_index: np.ndarray, max_nodes: int, max_edges: int
) -> PaddedGraph:
    n, f = x.shape
    e = edge_index.shape[1]
    if n > max_nodes or e > max_edges:
        raise ValueError(f"graph ({n} nodes, {e} edges) exceeds padding ({max_nodes}, {max_edges})")
    xp = np.zeros((max_nodes, f), np.float32)
    xp[:n] = x
    ep = np.zeros((2, max_edges), np.int32)
    ep[:, :e] = edge_index
    ep[:, e:] = max_nodes - 1 if n < max_nodes else 0  # park padding on last slot
    nm = np.zeros(max_nodes, np.float32)
    nm[:n] = 1.0
    em = np.zeros(max_edges, np.float32)
    em[:e] = 1.0
    return PaddedGraph(x=xp, edges=ep, node_mask=nm, edge_mask=em, loss_mask=nm.copy())


def gcn_propagate(
    h: torch.Tensor, edges: torch.Tensor, edge_mask: torch.Tensor, node_mask: torch.Tensor
) -> torch.Tensor:
    """Symmetric-normalized propagation with self loops: D^-1/2 (A+I) D^-1/2 h
    (torch_geometric GCNConv's default normalization). edges: (2, E) int64."""
    src, dst = edges[0], edges[1]
    deg = torch.zeros(h.shape[0], dtype=h.dtype, device=h.device).index_add_(0, dst, edge_mask)
    deg = deg + node_mask  # self loop counts
    dinv = torch.where(deg > 0, deg.clamp(min=1e-30).rsqrt(), torch.zeros_like(deg))
    coeff = dinv[src] * dinv[dst] * edge_mask
    msgs = h.index_select(0, src) * coeff[:, None]  # its gradient is an index_add_ too
    agg = torch.zeros_like(h).index_add_(0, dst, msgs)
    return agg + h * (dinv * dinv * node_mask)[:, None]  # self loops


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax's default Dense kernel init (variance 1/fan-in, truncated normal)
    on a torch (out, in) weight."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


class GCNConv(nn.Module):
    """torch_geometric-style GCNConv (eval math) on padded edge arrays."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.lin = nn.Linear(in_features, features)

    def forward(self, h, edges, edge_mask, node_mask):
        return gcn_propagate(self.lin(h), edges, edge_mask, node_mask)


class GCNEncoder(nn.Module):
    """2-layer GCN with PReLU activations (one learned slope each)."""

    def __init__(self, in_features: int, hidden: int = 64, out_dim: int = 32):
        super().__init__()
        self.conv1 = GCNConv(in_features, hidden)
        self.prelu1 = nn.Parameter(torch.full((1,), 0.25))
        self.conv2 = GCNConv(hidden, out_dim)
        self.prelu2 = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x, edges, edge_mask, node_mask):
        h = self.conv1(x, edges, edge_mask, node_mask)
        h = torch.where(h > 0, h, self.prelu1 * h)
        h = self.conv2(h, edges, edge_mask, node_mask)
        return torch.where(h > 0, h, self.prelu2 * h)


class DGI(nn.Module):
    """DeepGraphInfomax: encoder + bilinear discriminator vs row-shuffle
    corruption. ``seed`` draws flax's initial distributions (LeCun-normal
    kernels, zero biases, PReLU 0.25, discriminator U[0, 1))."""

    def __init__(self, in_features: int, hidden: int = 64, out_dim: int = 32, seed: int = 0):
        super().__init__()
        self.encoder = GCNEncoder(in_features, hidden, out_dim)
        self.weight = nn.Parameter(torch.zeros(out_dim, out_dim))
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for conv in (self.encoder.conv1, self.encoder.conv2):
                _lecun_normal_(conv.lin.weight, gen)
                conv.lin.bias.zero_()
            self.weight.copy_(torch.rand(self.weight.shape, generator=gen))

    def embed(self, x, edges, edge_mask, node_mask):
        return self.encoder(x, edges, edge_mask, node_mask)

    def forward(self, x, x_corrupt, edges, edge_mask, node_mask, loss_mask=None):
        # node_mask gates propagation (real vs padding); loss_mask restricts
        # the objective, e.g. to the interior nodes of a halo-aware subgraph
        lm = node_mask if loss_mask is None else loss_mask
        pos = self.encoder(x, edges, edge_mask, node_mask)
        neg = self.encoder(x_corrupt, edges, edge_mask, node_mask)
        n_real = lm.sum().clamp(min=1.0)
        summary = torch.sigmoid((pos * lm[:, None]).sum(0) / n_real)
        ws = self.weight @ summary
        # BCE with logits: -log(sigmoid(s)) = softplus(-s), -log(1 - sigmoid(s)) = softplus(s)
        pos_loss = F.softplus(-(pos @ ws))
        neg_loss = F.softplus(neg @ ws)
        return ((pos_loss + neg_loss) * lm).sum() / n_real


def sample_subgraph(
    x: np.ndarray,
    edge_index: np.ndarray,
    max_nodes: int,
    max_edges: int,
    rng: np.random.Generator,
) -> PaddedGraph:
    """Halo-aware LOCAL subgraph padded to static shapes.

    Keeps DGI training memory bounded for million-cell slide graphs while
    preserving neighbourhood structure: grow a BFS ball from a random seed
    (adding further random seeds if a component runs out) until the node
    budget is filled, keep the edges among the selected nodes, and mask the
    DGI loss to the INTERIOR nodes — those whose full 1-hop neighbourhood
    made it into the sample — so boundary-clipped receptive fields never
    contribute gradient.
    """
    n = x.shape[0]
    src, dst = edge_index
    take = min(max_nodes - 1, n)

    if take >= n:
        selected = np.arange(n)
    else:
        # CSR adjacency for BFS
        order = np.argsort(src, kind="stable")
        s_sorted, d_sorted = src[order], dst[order]
        starts = np.searchsorted(s_sorted, np.arange(n + 1))
        chosen = np.zeros(n, bool)
        picked: list[np.ndarray] = []
        count = 0
        while count < take:
            free = np.flatnonzero(~chosen)
            frontier = np.array([rng.choice(free)])
            chosen[frontier] = True
            picked.append(frontier)
            count += 1
            while frontier.size and count < take:
                # the frontier's CSR rows, in frontier order, in one gather
                lo, lens = starts[frontier], starts[frontier + 1] - starts[frontier]
                ends = np.cumsum(lens)
                neigh = d_sorted[np.repeat(lo - ends + lens, lens) + np.arange(ends[-1])]
                neigh = np.unique(neigh)
                neigh = neigh[~chosen[neigh]]
                if neigh.size > take - count:
                    neigh = rng.choice(neigh, size=take - count, replace=False)
                if neigh.size == 0:
                    break
                chosen[neigh] = True
                picked.append(neigh)
                count += neigh.size
                frontier = neigh
        selected = np.concatenate(picked)

    remap = -np.ones(n, np.int64)
    remap[selected] = np.arange(len(selected))
    keep = (remap[src] >= 0) & (remap[dst] >= 0)
    sub_edges = np.stack([remap[src[keep]], remap[dst[keep]]])
    truncated_local = np.empty(0, np.int64)
    if sub_edges.shape[1] > max_edges:
        sel = rng.choice(sub_edges.shape[1], size=max_edges, replace=False)
        dropped = np.ones(sub_edges.shape[1], bool)
        dropped[sel] = False
        # endpoints of subsampled-out edges also have clipped receptive
        # fields — exclude them from the loss like boundary nodes
        truncated_local = np.unique(sub_edges[:, dropped])
        sub_edges = sub_edges[:, sel]

    # interior = selected nodes with no lost neighbours (full receptive field)
    lost = np.zeros(n, np.int64)
    cut = (remap[src] >= 0) & (remap[dst] < 0)
    np.add.at(lost, src[cut], 1)
    interior = lost[selected] == 0
    if truncated_local.size:
        interior[truncated_local] = False

    g = pad_graph(x[selected], sub_edges, max_nodes, max_edges)
    lm = np.zeros_like(g.node_mask)
    lm[: len(selected)] = interior.astype(np.float32)
    if not lm.any():  # degenerate sample: learn from everything rather than nothing
        lm[: len(selected)] = 1.0
    return PaddedGraph(
        x=g.x, edges=g.edges, node_mask=g.node_mask, edge_mask=g.edge_mask, loss_mask=lm
    )


def embed_full_graph(state: Mapping[str, torch.Tensor], x: np.ndarray,
                     edge_index: np.ndarray) -> np.ndarray:
    """Exact full-graph GCN embedding on host sparse algebra (any graph size).

    Mirrors GCNEncoder's math with the trained ``DGI`` state dict: two
    GCNConv layers (symmetric-normalized propagation with self loops) with
    PReLU. Used after subgraph-sampled training so embeddings stay exact.
    """
    from scipy import sparse

    def leaf(name: str) -> np.ndarray:
        return state[name].detach().cpu().numpy()

    n = x.shape[0]
    src, dst = edge_index
    data = np.ones(len(src), np.float32)
    a = sparse.coo_matrix((data, (dst, src)), shape=(n, n)).tocsr()
    a.data[:] = 1.0
    deg = np.asarray(a.sum(axis=1)).ravel() + 1.0  # self loops
    dinv = 1.0 / np.sqrt(deg)

    def propagate(h: np.ndarray) -> np.ndarray:
        scaled = h * dinv[:, None]
        agg = a @ scaled
        agg = (agg + scaled) * dinv[:, None]
        return agg

    def gcn(h, conv: str):
        kernel = np.ascontiguousarray(leaf(f"encoder.{conv}.lin.weight").T)  # flax's (in, out)
        h = h @ kernel + leaf(f"encoder.{conv}.lin.bias")
        return propagate(h)

    h = gcn(x.astype(np.float32), "conv1")
    a1 = float(leaf("encoder.prelu1")[0])
    h = np.where(h > 0, h, a1 * h)
    h = gcn(h, "conv2")
    a2 = float(leaf("encoder.prelu2")[0])
    return np.where(h > 0, h, a2 * h).astype(np.float32)


def make_dgi_train_step(model: DGI, optimizer: torch.optim.Optimizer,
                        replicas: Sequence[DGI] = ()):
    """DGI step over a *batch* of padded graphs, split over ``model`` and
    its ``replicas`` (its copies on further devices, in order).

    Every argument is the list of its equal shards along the batch, shard 0
    on ``model``'s device and shard i on ``replicas[i - 1]``'s; a lone
    tensor is one shard. Shard dims: x (B, N, F), x_corrupt (B, N, F),
    edges (B, 2, E) int64, masks (B, ...). The loss is the mean of all the
    graphs' losses: each device computes its shard's share of it and that
    share's gradient, the gradients are summed on ``model``'s device (the
    JAX step's psum over the mesh), ``optimizer`` steps there once, and the
    new weights are copied to every replica. Returns the loss tensor (no
    host synchronisation)."""
    models = [model, *replicas]
    params = list(model.parameters())

    def shard_loss(m, n_total, x, x_corrupt, edges, edge_mask, node_mask, loss_mask):
        losses = [m(x[i], x_corrupt[i], edges[i], edge_mask[i], node_mask[i], loss_mask[i])
                  for i in range(x.shape[0])]
        return torch.stack(losses).mean() * (x.shape[0] / n_total)

    def train_step(*batch):
        shards = [list(a) if isinstance(a, (list, tuple)) else [a] for a in batch]
        for m in models:
            m.zero_grad(set_to_none=True)
        n_total = sum(xs.shape[0] for xs in shards[0])
        losses = []
        for m, *shard in zip(models, *shards):
            with on_device(shard[0].device):
                losses.append(shard_loss(m, n_total, *shard))
        torch.autograd.backward(losses)
        with torch.no_grad():
            for r in replicas:
                for p, q in zip(params, r.parameters()):
                    p.grad.add_(q.grad.to(p.device, non_blocking=True))
            optimizer.step()
            for r in replicas:
                for p, q in zip(params, r.parameters()):
                    q.copy_(p, non_blocking=True)
        return sum(loss.detach().to(params[0].device) for loss in losses)

    return train_step
