// Constrained approximate-minimum-degree elimination ordering.
//
// The PyTorch port's own copy of incrementalinference/jl_tpu/native/
// ordering.cpp (the port shares no file with the JAX package); the two must
// stay identical in behaviour, which tests/test_torch_tree.py checks.
//
// Native replacement for the reference's SuiteSparse CCOLAMD dependency
// (reference: ext/IncrInfrApproxMinDegreeExt.jl reaches C CCOLAMD via
// AMD.jl; attic/src/ccolamd.jl was a direct ccall).  Implements a
// quotient-graph-flavoured constrained minimum-degree over the variable
// adjacency induced by factors:
//
//   - `cmember[v]` assigns each variable to an ordered constraint group
//     (CCOLAMD's cmember semantics): all group-g variables are eliminated
//     before any group-(g+1) variable.  Fixed-lag and incremental solves
//     use this to force recent/frontal variables to the end (tree root).
//   - Within the active group, picks the minimum-fill-degree variable
//     (ties by index for determinism) and merges its neighborhood into a
//     clique (element absorption via flat adjacency sets).
//
// Exposed with a plain C ABI for ctypes.  Complexity is fine for the
// graph sizes the host-side symbolic layer handles (the heavy numeric
// work lives on the GPU).

#include <algorithm>
#include <cstdint>
#include <queue>
#include <tuple>
#include <vector>

extern "C" {

// fptr: factor row pointers (n_factors+1); fvars: concatenated variable
// indices per factor; cmember: constraint group per variable (nullptr = all
// group 0); order_out: resulting elimination order (variable indices).
// Returns 0 on success.
//
// Degrees are MAINTAINED incrementally with a lazy min-heap per
// constraint group instead of re-scanned per pivot (a rescan is O(V·deg)
// per pivot, quadratic-plus on LineStep(1000)-scale graphs).  Only the eliminated
// pivot's live neighborhood changes degree, so only those entries are
// recomputed and re-pushed (stale heap entries are skipped on pop).
// Deterministic: ties break by variable index via the (deg, v) heap key.
int iitpu_ccolamd(int32_t n_vars, int32_t n_factors, const int32_t *fptr,
                  const int32_t *fvars, const int32_t *cmember,
                  int32_t *order_out) {
  if (n_vars <= 0) return 0;
  std::vector<std::vector<int32_t>> adj(n_vars);

  // variable adjacency from shared factors
  for (int32_t f = 0; f < n_factors; ++f) {
    for (int32_t i = fptr[f]; i < fptr[f + 1]; ++i) {
      for (int32_t j = fptr[f]; j < fptr[f + 1]; ++j) {
        if (fvars[i] != fvars[j]) adj[fvars[i]].push_back(fvars[j]);
      }
    }
  }
  for (auto &a : adj) {
    std::sort(a.begin(), a.end());
    a.erase(std::unique(a.begin(), a.end()), a.end());
  }

  std::vector<char> eliminated(n_vars, 0);
  std::vector<int32_t> group(n_vars, 0);
  if (cmember != nullptr)
    for (int32_t v = 0; v < n_vars; ++v) group[v] = cmember[v];

  int32_t max_group = 0;
  for (int32_t v = 0; v < n_vars; ++v)
    max_group = std::max(max_group, group[v]);

  auto live_degree = [&](int32_t v) {
    int32_t d = 0;
    for (int32_t u : adj[v])
      if (!eliminated[u]) ++d;
    return d;
  };

  std::vector<int32_t> deg(n_vars, 0);
  for (int32_t v = 0; v < n_vars; ++v) deg[v] = (int32_t)adj[v].size();

  using Entry = std::pair<int32_t, int32_t>;  // (deg, v) — min-heap
  int32_t pos = 0;
  for (int32_t g = 0; g <= max_group; ++g) {
    std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> pq;
    int32_t remaining = 0;
    for (int32_t v = 0; v < n_vars; ++v) {
      if (!eliminated[v] && group[v] == g) {
        deg[v] = live_degree(v);
        pq.emplace(deg[v], v);
        ++remaining;
      }
    }

    while (remaining > 0 && !pq.empty()) {
      auto [d, best] = pq.top();
      pq.pop();
      if (eliminated[best] || d != deg[best]) continue;  // stale entry

      // eliminate: connect live neighbors into a clique (fill)
      std::vector<int32_t> nbrs;
      for (int32_t u : adj[best])
        if (!eliminated[u]) nbrs.push_back(u);
      for (size_t i = 0; i < nbrs.size(); ++i) {
        for (size_t j = 0; j < nbrs.size(); ++j) {
          if (i == j) continue;
          auto &a = adj[nbrs[i]];
          if (!std::binary_search(a.begin(), a.end(), nbrs[j])) {
            a.insert(std::lower_bound(a.begin(), a.end(), nbrs[j]),
                     nbrs[j]);
          }
        }
      }
      eliminated[best] = 1;
      order_out[pos++] = best;
      --remaining;
      // only the pivot's live neighborhood changed degree
      for (int32_t u : nbrs) {
        deg[u] = live_degree(u);
        if (group[u] == g) pq.emplace(deg[u], u);
      }
    }
  }
  return pos == n_vars ? 0 : 1;
}

}  // extern "C"
