// Leiden community detection (Traag, Waltman & van Eck 2019) with the
// RBConfiguration quality function (modularity with a resolution parameter).
// A copy of the JAX package's native/leiden.cpp, built with the other
// native/*.cpp sources by ops/native_build.py.
//
// Replaces the reference's igraph/leidenalg dependency (reference:
// wsinsight/insightlib/cme_generation.py:812-826) for the CME cluster-count
// sweep. Single-threaded per call; the Python sweep fans calls out across
// threads (this entry point releases the GIL via ctypes).
//
// Contract:
//   leiden_cluster(src, dst, n_edges, n_nodes, resolution, seed,
//                  out_labels, out_modularity) -> n_clusters (or -1 on error)
//   * edges are undirected; duplicates and self-loops are ignored
//   * out_labels: int32[n_nodes], labels contiguous from 0
//   * out_modularity: standard (gamma=1) modularity of the final partition
//     on the simple input graph

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

struct Level {
  int64_t n = 0;
  std::vector<int64_t> off;   // CSR offsets, n+1
  std::vector<int64_t> adj;   // neighbor ids (no self entries)
  std::vector<double> w;      // edge weights, parallel to adj
  std::vector<double> self;   // self-loop weight per node (w_ii)
  std::vector<double> k;      // strength: sum_j w_ij + 2*w_ii
  double two_m = 0.0;         // sum of strengths
};

Level build_from_pairs(std::vector<std::pair<int64_t, int64_t>>& pairs,
                       const std::vector<double>& pw,
                       const std::vector<double>& selfw, int64_t n) {
  // pairs are normalized (a < b); may contain duplicates -> merge weights.
  std::vector<int64_t> order(pairs.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = (int64_t)i;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return pairs[a] < pairs[b];
  });

  std::vector<std::pair<int64_t, int64_t>> uniq;
  std::vector<double> uw;
  uniq.reserve(pairs.size());
  uw.reserve(pairs.size());
  for (int64_t idx : order) {
    if (!uniq.empty() && uniq.back() == pairs[idx]) {
      uw.back() += pw.empty() ? 1.0 : pw[idx];
    } else {
      uniq.push_back(pairs[idx]);
      uw.push_back(pw.empty() ? 1.0 : pw[idx]);
    }
  }

  Level g;
  g.n = n;
  g.off.assign(n + 1, 0);
  g.self.assign(n, 0.0);
  if (!selfw.empty()) g.self = selfw;
  for (size_t i = 0; i < uniq.size(); ++i) {
    g.off[uniq[i].first + 1]++;
    g.off[uniq[i].second + 1]++;
  }
  for (int64_t v = 0; v < n; ++v) g.off[v + 1] += g.off[v];
  g.adj.assign(g.off[n], 0);
  g.w.assign(g.off[n], 0.0);
  std::vector<int64_t> cur(g.off.begin(), g.off.end() - 1);
  for (size_t i = 0; i < uniq.size(); ++i) {
    auto [a, b] = uniq[i];
    g.adj[cur[a]] = b; g.w[cur[a]++] = uw[i];
    g.adj[cur[b]] = a; g.w[cur[b]++] = uw[i];
  }
  g.k.assign(n, 0.0);
  for (int64_t v = 0; v < n; ++v) {
    double s = 2.0 * g.self[v];
    for (int64_t e = g.off[v]; e < g.off[v + 1]; ++e) s += g.w[e];
    g.k[v] = s;
    g.two_m += s;
  }
  return g;
}

// Fast local move: queue-sweep nodes, greedily reassigning each to the
// neighboring community with the highest RB-quality gain.
int64_t local_move(const Level& g, double gamma, std::mt19937_64& rng,
                   std::vector<int64_t>& comm) {
  const int64_t n = g.n;
  std::vector<double> comm_tot(n, 0.0);
  for (int64_t v = 0; v < n; ++v) comm_tot[comm[v]] += g.k[v];

  std::vector<int64_t> queue(n);
  for (int64_t v = 0; v < n; ++v) queue[v] = v;
  std::shuffle(queue.begin(), queue.end(), rng);
  std::vector<uint8_t> queued(n, 1);
  size_t head = 0;

  // scratch: weight from v to each touched community
  std::vector<double> w_to(n, 0.0);
  std::vector<int64_t> touched;
  touched.reserve(64);

  int64_t moves = 0;
  const double inv2m = g.two_m > 0 ? 1.0 / g.two_m : 0.0;

  while (head < queue.size()) {
    int64_t v = queue[head++];
    queued[v] = 0;
    int64_t c_old = comm[v];

    touched.clear();
    for (int64_t e = g.off[v]; e < g.off[v + 1]; ++e) {
      int64_t c = comm[g.adj[e]];
      if (w_to[c] == 0.0) touched.push_back(c);
      w_to[c] += g.w[e];
    }
    if (w_to[c_old] == 0.0) touched.push_back(c_old);

    comm_tot[c_old] -= g.k[v];
    double best_gain = w_to[c_old] - gamma * g.k[v] * comm_tot[c_old] * inv2m;
    int64_t best_c = c_old;
    for (int64_t c : touched) {
      if (c == c_old) continue;
      double gain = w_to[c] - gamma * g.k[v] * comm_tot[c] * inv2m;
      if (gain > best_gain + 1e-12) {
        best_gain = gain;
        best_c = c;
      }
    }
    comm[v] = best_c;
    comm_tot[best_c] += g.k[v];
    for (int64_t c : touched) w_to[c] = 0.0;

    if (best_c != c_old) {
      ++moves;
      for (int64_t e = g.off[v]; e < g.off[v + 1]; ++e) {
        int64_t u = g.adj[e];
        if (comm[u] != best_c && !queued[u]) {
          queued[u] = 1;
          queue.push_back(u);
        }
      }
    }
  }
  return moves;
}

// Leiden refinement: split each community into well-connected sub-communities
// by merging singleton nodes into neighbors within the same community, picking
// randomly among positive-gain candidates (exp-weighted, theta as in the
// paper) so repeated runs explore different splits.
std::vector<int64_t> refine(const Level& g, double gamma,
                            const std::vector<int64_t>& comm,
                            std::mt19937_64& rng, double theta = 0.01) {
  const int64_t n = g.n;
  std::vector<int64_t> sub(n);
  for (int64_t v = 0; v < n; ++v) sub[v] = v;

  std::vector<double> sub_tot(g.k);            // strength per sub-community
  std::vector<int64_t> sub_size(n, 1);
  std::vector<double> comm_tot(n, 0.0);        // strength per original community
  for (int64_t v = 0; v < n; ++v) comm_tot[comm[v]] += g.k[v];
  // connectivity of each sub-community to the rest of its parent community
  std::vector<double> sub_ext(n, 0.0);
  for (int64_t v = 0; v < n; ++v) {
    double e = 0.0;
    for (int64_t i = g.off[v]; i < g.off[v + 1]; ++i)
      if (comm[g.adj[i]] == comm[v]) e += g.w[i];
    sub_ext[v] = e;
  }

  std::vector<int64_t> order(n);
  for (int64_t v = 0; v < n; ++v) order[v] = v;
  std::shuffle(order.begin(), order.end(), rng);

  const double inv2m = g.two_m > 0 ? 1.0 / g.two_m : 0.0;
  std::vector<double> w_to(n, 0.0);
  std::vector<int64_t> touched;
  std::vector<double> gains;
  std::uniform_real_distribution<double> unit(0.0, 1.0);

  for (int64_t v : order) {
    if (sub_size[sub[v]] != 1) continue;  // only merge still-singleton nodes
    int64_t c = comm[v];
    // well-connectedness of v within its community
    double kv = g.k[v];
    if (sub_ext[sub[v]] < gamma * kv * (comm_tot[c] - kv) * inv2m) continue;

    touched.clear();
    for (int64_t e = g.off[v]; e < g.off[v + 1]; ++e) {
      int64_t u = g.adj[e];
      if (comm[u] != c) continue;
      int64_t d = sub[u];
      if (w_to[d] == 0.0) touched.push_back(d);
      w_to[d] += g.w[e];
    }

    // candidate gains for moving v (a singleton) into sub-community d
    gains.clear();
    double norm = 0.0;
    for (int64_t d : touched) {
      double gain = (w_to[d] - gamma * kv * sub_tot[d] * inv2m) * inv2m;
      double wgt = gain >= 0.0 ? std::exp(gain / theta) : 0.0;
      gains.push_back(wgt);
      norm += wgt;
    }
    int64_t dest = -1;
    if (norm > 0.0) {
      double r = unit(rng) * norm;
      for (size_t i = 0; i < touched.size(); ++i) {
        r -= gains[i];
        if (r <= 0.0) { dest = touched[i]; break; }
      }
      if (dest < 0) dest = touched.back();
    }
    if (dest >= 0 && dest != sub[v]) {
      int64_t s_old = sub[v];
      // moving v updates the destination's external connectivity:
      // edges v->dest become internal, v's other intra-community edges
      // become dest's external edges.
      sub_ext[dest] += sub_ext[s_old] - 2.0 * w_to[dest];
      sub[v] = dest;
      sub_tot[dest] += kv;
      sub_size[dest] += 1;
      sub_tot[s_old] = 0.0;
      sub_size[s_old] = 0;
      sub_ext[s_old] = 0.0;
    }
    for (int64_t d : touched) w_to[d] = 0.0;
  }
  return sub;
}

}  // namespace

extern "C" int64_t leiden_cluster(const int64_t* src, const int64_t* dst,
                                  int64_t n_edges, int64_t n_nodes,
                                  double resolution, uint64_t seed,
                                  int32_t* out_labels,
                                  double* out_modularity) {
  if (n_nodes <= 0) return 0;

  std::vector<std::pair<int64_t, int64_t>> pairs;
  pairs.reserve(n_edges);
  for (int64_t i = 0; i < n_edges; ++i) {
    int64_t a = src[i], b = dst[i];
    if (a == b || a < 0 || b < 0 || a >= n_nodes || b >= n_nodes) continue;
    pairs.emplace_back(std::min(a, b), std::max(a, b));
  }
  // simple-graph semantics: duplicate input edges collapse to weight 1
  // (igraph simplify(combine_edges="ignore") behavior)
  std::sort(pairs.begin(), pairs.end());
  pairs.erase(std::unique(pairs.begin(), pairs.end()), pairs.end());
  std::vector<double> no_weights, no_self;
  Level base = build_from_pairs(pairs, no_weights, no_self, n_nodes);

  std::mt19937_64 rng(seed);

  Level g = base;
  std::vector<int64_t> node_of(n_nodes);  // original node -> current level node
  for (int64_t v = 0; v < n_nodes; ++v) node_of[v] = v;
  std::vector<int64_t> init(g.n);         // initial communities for this level
  for (int64_t v = 0; v < g.n; ++v) init[v] = v;

  for (int level = 0; level < 64; ++level) {
    std::vector<int64_t> comm = init;
    int64_t moves = local_move(g, resolution, rng, comm);
    std::vector<int64_t> sub = refine(g, resolution, comm, rng);

    // compact refined ids
    std::vector<int64_t> remap(g.n, -1);
    int64_t n_sub = 0;
    for (int64_t v = 0; v < g.n; ++v)
      if (remap[sub[v]] < 0) remap[sub[v]] = n_sub++;
    for (int64_t v = 0; v < g.n; ++v) sub[v] = remap[sub[v]];

    bool converged = (n_sub == g.n) && (moves == 0);
    if (converged || level == 63) {
      // final communities = comm on this level's nodes
      std::vector<int64_t> cremap(g.n, -1);
      int64_t n_comm = 0;
      for (int64_t v = 0; v < g.n; ++v)
        if (cremap[comm[v]] < 0) cremap[comm[v]] = n_comm++;
      for (int64_t ov = 0; ov < n_nodes; ++ov)
        out_labels[ov] = (int32_t)cremap[comm[node_of[ov]]];

      if (out_modularity) {
        // gamma=1 modularity of the final partition on the simple input graph
        std::vector<double> in_w(n_comm, 0.0), tot(n_comm, 0.0);
        for (int64_t v = 0; v < base.n; ++v) {
          tot[out_labels[v]] += base.k[v];
          for (int64_t e = base.off[v]; e < base.off[v + 1]; ++e) {
            int64_t u = base.adj[e];
            if (u > v && out_labels[u] == out_labels[v])
              in_w[out_labels[v]] += base.w[e];
          }
        }
        double m = base.two_m / 2.0, q = 0.0;
        if (m > 0) {
          for (int64_t c = 0; c < n_comm; ++c)
            q += in_w[c] / m - (tot[c] / (2.0 * m)) * (tot[c] / (2.0 * m));
        }
        *out_modularity = q;
      }
      return n_comm;
    }

    // track original nodes through the refined partition
    for (int64_t ov = 0; ov < n_nodes; ++ov) node_of[ov] = sub[node_of[ov]];

    // aggregate by the refined partition; each undirected edge visited once
    std::vector<std::pair<int64_t, int64_t>> apairs;
    std::vector<double> aw;
    std::vector<double> aself(n_sub, 0.0);
    apairs.reserve(g.adj.size() / 2);
    aw.reserve(g.adj.size() / 2);
    for (int64_t v = 0; v < g.n; ++v) {
      aself[sub[v]] += g.self[v];
      for (int64_t e = g.off[v]; e < g.off[v + 1]; ++e) {
        int64_t u = g.adj[e];
        if (u <= v) continue;
        int64_t a = sub[v], b = sub[u];
        if (a == b) {
          aself[a] += g.w[e];
        } else {
          apairs.emplace_back(std::min(a, b), std::max(a, b));
          aw.push_back(g.w[e]);
        }
      }
    }

    // next level starts from the communities found here (Leiden invariant:
    // refinement is a sub-partition of comm, so comm projects onto
    // aggregates). Community ids must be re-compacted to < n_sub, since the
    // next level's scratch arrays are sized by its node count.
    std::vector<int64_t> next_init(n_sub, 0);
    for (int64_t v = 0; v < g.n; ++v) next_init[sub[v]] = comm[v];
    std::vector<int64_t> cmap(g.n, -1);
    int64_t n_comm_next = 0;
    for (int64_t s = 0; s < n_sub; ++s) {
      if (cmap[next_init[s]] < 0) cmap[next_init[s]] = n_comm_next++;
      next_init[s] = cmap[next_init[s]];
    }

    g = build_from_pairs(apairs, aw, aself, n_sub);
    init = std::move(next_init);
  }
  return -1;  // unreachable
}
