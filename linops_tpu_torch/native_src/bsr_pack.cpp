// Native CSR -> BSR packer + reordering helpers.
//
// The runtime side of the sparse subsystem (SURVEY.md §2.3 'Sparse storage
// formats'): building the TPU block layout from raw CSR is pure host-side
// pointer-chasing — the kind of work the reference delegates to
// SparseArrays' C routines — so it lives in C++ (the Python/numpy packer in
// sparse/formats.py materializes the dense matrix: fine for tests, unusable
// at production nnz).
//
// Exposed via ctypes (no pybind11 in the image). All index arrays are
// int32, matching the device format.
//
// Build: g++ -O3 -shared -fPIC bsr_pack.cpp -o libbsrpack.so

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <queue>

// Pass 2: fill blocks (nbrow, kmax, bm, bn) and block_cols (nbrow, kmax).
// Padding entries keep block_col 0 and zero values (they contribute 0).
// Duplicate (row, col) CSR entries are SUMMED (scipy canonical convention).
template <typename T>
static void bsr_fill(const T* vals, const int32_t* cols, const int32_t* indptr,
                     int64_t nrow, int32_t bm, int32_t bn, int32_t kmax,
                     T* blocks, int32_t* block_cols) {
  int64_t nbrow = (nrow + bm - 1) / bm;
  std::vector<int32_t> bcs;
  std::vector<int32_t> pos(1 << 16);
  for (int64_t bi = 0; bi < nbrow; ++bi) {
    bcs.clear();
    int64_t r0 = bi * bm;
    int64_t r1 = std::min<int64_t>(r0 + bm, nrow);
    for (int64_t r = r0; r < r1; ++r)
      for (int32_t p = indptr[r]; p < indptr[r + 1]; ++p)
        bcs.push_back(cols[p] / bn);
    std::sort(bcs.begin(), bcs.end());
    bcs.erase(std::unique(bcs.begin(), bcs.end()), bcs.end());

    int32_t* bc_row = block_cols + bi * kmax;
    for (int32_t k = 0; k < kmax; ++k)
      bc_row[k] = (k < (int32_t)bcs.size()) ? bcs[k] : 0;

    // map block-col -> slot k for this block-row
    for (size_t k = 0; k < bcs.size(); ++k) {
      if (bcs[k] >= (int32_t)pos.size()) pos.resize(bcs[k] + 1);
      pos[bcs[k]] = (int32_t)k;
    }

    T* blk_row = blocks + (int64_t)bi * kmax * bm * bn;
    for (int64_t r = r0; r < r1; ++r) {
      int32_t rr = (int32_t)(r - r0);
      for (int32_t p = indptr[r]; p < indptr[r + 1]; ++p) {
        int32_t bc = cols[p] / bn;
        int32_t cc = cols[p] % bn;
        int32_t k = pos[bc];
        blk_row[((int64_t)k * bm + rr) * bn + cc] += vals[p];
      }
    }
  }
}


extern "C" {

// Pass 1: for each block-row, count distinct nonzero block-columns.
// Returns the max count over block-rows (kmax); fills counts[nbrow].
int32_t bsr_count(const int32_t* cols, const int32_t* indptr, int64_t nrow,
                  int32_t bm, int32_t bn, int32_t* counts) {
  int64_t nbrow = (nrow + bm - 1) / bm;
  int32_t kmax = 0;
  std::vector<int32_t> seen;
  for (int64_t bi = 0; bi < nbrow; ++bi) {
    seen.clear();
    int64_t r0 = bi * bm;
    int64_t r1 = std::min<int64_t>(r0 + bm, nrow);
    for (int64_t r = r0; r < r1; ++r) {
      for (int32_t p = indptr[r]; p < indptr[r + 1]; ++p) {
        seen.push_back(cols[p] / bn);
      }
    }
    std::sort(seen.begin(), seen.end());
    seen.erase(std::unique(seen.begin(), seen.end()), seen.end());
    counts[bi] = (int32_t)seen.size();
    kmax = std::max(kmax, counts[bi]);
  }
  return kmax;
}

void bsr_fill_f32(const float* vals, const int32_t* cols,
                  const int32_t* indptr, int64_t nrow, int32_t bm, int32_t bn,
                  int32_t kmax, float* blocks, int32_t* block_cols) {
  bsr_fill<float>(vals, cols, indptr, nrow, bm, bn, kmax, blocks, block_cols);
}

void bsr_fill_f64(const double* vals, const int32_t* cols,
                  const int32_t* indptr, int64_t nrow, int32_t bm, int32_t bn,
                  int32_t kmax, double* blocks, int32_t* block_cols) {
  bsr_fill<double>(vals, cols, indptr, nrow, bm, bn, kmax, blocks, block_cols);
}

// Reverse Cuthill-McKee ordering on the symmetrized pattern of a CSR
// matrix: reduces bandwidth so BSR block-rows touch fewer block-columns
// (smaller kmax, less padding) and row-partitions have thinner halos.
// perm[i] = old index of the node placed at new position i.
void rcm_order(const int32_t* cols, const int32_t* indptr, int64_t n,
               int32_t* perm) {
  // build symmetric adjacency (pattern only)
  std::vector<std::vector<int32_t>> adj(n);
  for (int64_t r = 0; r < n; ++r)
    for (int32_t p = indptr[r]; p < indptr[r + 1]; ++p) {
      int32_t c = cols[p];
      if (c != r && c >= 0 && c < n) {
        adj[r].push_back(c);
        adj[c].push_back((int32_t)r);
      }
    }
  std::vector<int32_t> deg(n);
  for (int64_t i = 0; i < n; ++i) {
    auto& a = adj[i];
    std::sort(a.begin(), a.end());
    a.erase(std::unique(a.begin(), a.end()), a.end());
    deg[i] = (int32_t)a.size();
  }

  std::vector<char> visited(n, 0);
  std::vector<int32_t> order;
  order.reserve(n);
  std::vector<int32_t> frontier;

  for (;;) {
    // lowest-degree unvisited seed
    int32_t seed = -1;
    for (int64_t i = 0; i < n; ++i)
      if (!visited[i] && (seed < 0 || deg[i] < deg[seed])) seed = (int32_t)i;
    if (seed < 0) break;

    std::queue<int32_t> q;
    q.push(seed);
    visited[seed] = 1;
    while (!q.empty()) {
      int32_t u = q.front();
      q.pop();
      order.push_back(u);
      frontier.clear();
      for (int32_t v : adj[u])
        if (!visited[v]) {
          visited[v] = 1;
          frontier.push_back(v);
        }
      std::sort(frontier.begin(), frontier.end(),
                [&](int32_t a, int32_t b) { return deg[a] < deg[b]; });
      for (int32_t v : frontier) q.push(v);
    }
  }
  // reverse
  for (int64_t i = 0; i < n; ++i) perm[i] = order[n - 1 - i];
}

}  // extern "C"
