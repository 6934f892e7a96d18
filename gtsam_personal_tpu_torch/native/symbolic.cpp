// Native host-side symbolic analysis for the factor-graph engine.
//
// The port's own copy of gtsam_personal_tpu/native/symbolic.cpp: the same
// four functions behind the same C ABI. The reference does its symbolic work
// in C++ (CCOLAMD orderings, inference/Ordering.h; elimination trees,
// inference/EliminationTree.h). Here the device-side numerics are torch
// programs, but the per-dataset symbolic analysis (graph traversal,
// fill-reducing ordering, partition planning) is still latency-sensitive
// host work, so it is native C++ too, consumed with ctypes
// (gtsam_personal_tpu_torch/native/__init__.py builds and loads it).
//
// Build: g++ -O3 -shared -fPIC symbolic.cpp -o <library>.so

#include <cstdint>
#include <vector>
#include <queue>
#include <algorithm>
#include <unordered_set>

extern "C" {

// BFS levels over a masked subgraph (CSR). level[i] = -1 if unreached/masked.
// Returns number of reached nodes.
int64_t bfs_levels(int64_t n, const int64_t* indptr, const int64_t* indices,
                   const uint8_t* mask, int64_t start, int64_t* level) {
  for (int64_t i = 0; i < n; ++i) level[i] = -1;
  if (!mask[start]) return 0;
  std::vector<int64_t> frontier, next;
  frontier.push_back(start);
  level[start] = 0;
  int64_t reached = 1, l = 0;
  while (!frontier.empty()) {
    ++l;
    next.clear();
    for (int64_t u : frontier) {
      for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
        int64_t v = indices[k];
        if (mask[v] && level[v] < 0) {
          level[v] = l;
          next.push_back(v);
          ++reached;
        }
      }
    }
    frontier.swap(next);
  }
  return reached;
}

// Minimum-degree elimination ordering (exact degree, clique update).
// A lightweight stand-in for CCOLAMD (inference/Ordering.h:93): good
// fill-reducing quality on SLAM-sized graphs. perm[k] = k-th variable to
// eliminate.
void min_degree_order(int64_t n, const int64_t* indptr, const int64_t* indices,
                      int64_t* perm) {
  std::vector<std::unordered_set<int64_t>> adj(n);
  for (int64_t u = 0; u < n; ++u)
    for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k)
      if (indices[k] != u) adj[u].insert(indices[k]);

  std::vector<char> eliminated(n, 0);
  using Entry = std::pair<int64_t, int64_t>;  // (degree, node)
  std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> heap;
  for (int64_t u = 0; u < n; ++u) heap.push({(int64_t)adj[u].size(), u});

  int64_t count = 0;
  while (count < n) {
    auto [deg, u] = heap.top();
    heap.pop();
    if (eliminated[u] || (int64_t)adj[u].size() != deg) {
      if (!eliminated[u]) heap.push({(int64_t)adj[u].size(), u});
      continue;
    }
    perm[count++] = u;
    eliminated[u] = 1;
    // connect neighbors into a clique
    std::vector<int64_t> nbrs(adj[u].begin(), adj[u].end());
    for (int64_t v : nbrs) adj[v].erase(u);
    for (size_t a = 0; a < nbrs.size(); ++a) {
      int64_t va = nbrs[a];
      if (eliminated[va]) continue;
      for (size_t b = a + 1; b < nbrs.size(); ++b) {
        int64_t vb = nbrs[b];
        if (eliminated[vb]) continue;
        if (adj[va].insert(vb).second) adj[vb].insert(va);
      }
      heap.push({(int64_t)adj[va].size(), va});
    }
    adj[u].clear();
  }
}

// Group-constrained minimum degree: eliminate all group-g vertices before
// any group-(g+1) vertex, min-degree within a group (the analogue of
// Ordering::ColamdConstrainedLast/First, inference/Ordering.h:112-139 —
// e.g. new keys eliminated last in ISAM2's recalculate).
void min_degree_order_grouped(int64_t n, const int64_t* indptr,
                              const int64_t* indices, const int64_t* group,
                              int64_t* perm) {
  std::vector<std::unordered_set<int64_t>> adj(n);
  for (int64_t u = 0; u < n; ++u)
    for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k)
      if (indices[k] != u) adj[u].insert(indices[k]);

  std::vector<char> eliminated(n, 0);
  struct Entry {
    int64_t grp, deg, node;
    bool operator>(const Entry& o) const {
      if (grp != o.grp) return grp > o.grp;
      if (deg != o.deg) return deg > o.deg;
      return node > o.node;
    }
  };
  std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> heap;
  for (int64_t u = 0; u < n; ++u)
    heap.push({group[u], (int64_t)adj[u].size(), u});

  int64_t count = 0;
  while (count < n) {
    auto [grp, deg, u] = heap.top();
    heap.pop();
    if (eliminated[u] || (int64_t)adj[u].size() != deg) {
      if (!eliminated[u]) heap.push({group[u], (int64_t)adj[u].size(), u});
      continue;
    }
    perm[count++] = u;
    eliminated[u] = 1;
    std::vector<int64_t> nbrs(adj[u].begin(), adj[u].end());
    for (int64_t v : nbrs) adj[v].erase(u);
    for (size_t a = 0; a < nbrs.size(); ++a) {
      int64_t va = nbrs[a];
      if (eliminated[va]) continue;
      for (size_t b = a + 1; b < nbrs.size(); ++b) {
        int64_t vb = nbrs[b];
        if (eliminated[vb]) continue;
        if (adj[va].insert(vb).second) adj[vb].insert(va);
      }
      heap.push({group[va], (int64_t)adj[va].size(), va});
    }
    adj[u].clear();
  }
}

// Classify factors against a partition: for each factor (row of vids
// [K, S]), find its interior part (max over non-separator slots; -1 if all
// slots are separator). Returns 0 on success, row index + 1 of the first
// factor spanning two interiors on failure.
int64_t classify_factors(int64_t K, int64_t S, const int64_t* vids,
                         const int64_t* part_of, int64_t* fpart) {
  for (int64_t k = 0; k < K; ++k) {
    int64_t p = -1;
    for (int64_t s = 0; s < S; ++s) {
      int64_t q = part_of[vids[k * S + s]];
      if (q < 0) continue;
      if (p < 0) p = q;
      else if (p != q) return k + 1;
    }
    fpart[k] = p;
  }
  return 0;
}

}  // extern "C"
