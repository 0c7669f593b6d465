// Radix-128 Clos routing — native port of sparse/routing.py.
//
// The route computation (recursive Euler-split edge coloring of 128-regular
// bipartite multigraphs) is pure pointer chasing: ~45 s in numpy at the
// 2^21-element domain. The layout contract is IDENTICAL to the Python
// router (routing.py::clos_apply is the oracle for both); tests assert
// elementwise equality of the emitted stage arrays.
//
// v2 (round 4): the v1 port re-sorted edges by src/dst with counting sorts
// at EVERY recursion level and chased int64 global arrays (measured 1.5-2.2 s
// at the 2^21 domain — it had become the pack bottleneck). This version
//   - keeps per-subproblem LOCAL int32 copies of (src, dst) so the Euler
//     walk touches small contiguous memory,
//   - maintains the by-src / by-dst edge orders across the recursion by
//     STABLE PARTITION instead of re-sorting (a stable partition of a
//     stably-sorted list is still sorted, so the walk visits edges in
//     exactly the v1 order — outputs stay bit-identical),
//   - forks the two Euler halves onto threads near the top of the
//     recursion and spreads the 128 independent middle subnets over a
//     small thread pool.
//
// Built with g++ by linops_tpu/native/__init__.py on first use.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int64_t RADIX = 128;

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  if (n == 0) n = 1;
  if (n > 8) n = 8;
  return (int)n;
}

// One subproblem: n edges of a deg-regular bipartite multigraph with dense
// node ids [0, n/deg). All arrays are LOCAL (length n); ids maps local
// edge index -> global edge id (for the final color writeback).
struct Sub {
  std::vector<int32_t> ids, src, dst, order_s, order_d;
};

// Split into two (deg/2)-regular halves by alternately 2-coloring Euler
// circuits. Mirrors routing.py::_euler_split; `side[i]` = first half.
// order_s / order_d are consumed as per-node slices (node u owns
// order_s[u*deg .. u*deg+deg)) — valid because the graph is deg-regular
// with dense node ids.
void euler_split(const Sub& G, int64_t n, int64_t deg, uint8_t* side,
                 std::vector<int32_t>& ptr_s, std::vector<int32_t>& ptr_d,
                 std::vector<uint8_t>& visited) {
  if (n == 0) return;
  const int64_t n_src = n / deg;
  const int64_t n_dst = n / deg;
  ptr_s.assign(n_src, 0);
  ptr_d.assign(n_dst, 0);
  visited.assign(n, 0);
  const int32_t* os = G.order_s.data();
  const int32_t* od = G.order_d.data();
  const int32_t* src = G.src.data();
  const int32_t* dst = G.dst.data();
  uint8_t* vis = visited.data();

  auto next_from_src = [&](int32_t u) -> int64_t {
    int32_t& p = ptr_s[u];
    const int64_t base = (int64_t)u * deg;
    while (p < deg) {
      int64_t i = os[base + p];
      p++;
      if (!vis[i]) return i;
    }
    return -1;
  };
  auto next_from_dst = [&](int32_t v) -> int64_t {
    int32_t& p = ptr_d[v];
    const int64_t base = (int64_t)v * deg;
    while (p < deg) {
      int64_t i = od[base + p];
      p++;
      if (!vis[i]) return i;
    }
    return -1;
  };

  for (int64_t i0 = 0; i0 < n; i0++) {
    if (vis[i0]) continue;
    int64_t i = i0;
    const bool first = true;
    while (i >= 0) {
      vis[i] = 1;
      side[i] = first;
      int64_t i2 = next_from_dst(dst[i]);
      if (i2 < 0) break;
      vis[i2] = 1;
      side[i2] = !first;
      i = next_from_src(src[i2]);
    }
  }
}

// Stable-partition G by `side` into A (side=1) and B (side=0), carrying the
// maintained orders: new_order = old order filtered per half with local
// indices renumbered by rank — equivalent to re-sorting, but O(n).
void partition(const Sub& G, const uint8_t* side, int64_t n, Sub& A, Sub& B,
               std::vector<int32_t>& newidx) {
  newidx.resize(n);
  int64_t na = 0;
  for (int64_t i = 0; i < n; i++)
    if (side[i]) newidx[i] = (int32_t)na++;
  int64_t nb = 0;
  for (int64_t i = 0; i < n; i++)
    if (!side[i]) newidx[i] = (int32_t)nb++;
  A.ids.resize(na); A.src.resize(na); A.dst.resize(na);
  A.order_s.resize(na); A.order_d.resize(na);
  B.ids.resize(nb); B.src.resize(nb); B.dst.resize(nb);
  B.order_s.resize(nb); B.order_d.resize(nb);
  int64_t a = 0, b = 0;
  for (int64_t i = 0; i < n; i++) {
    if (side[i]) {
      A.ids[a] = G.ids[i]; A.src[a] = G.src[i]; A.dst[a] = G.dst[i]; a++;
    } else {
      B.ids[b] = G.ids[i]; B.src[b] = G.src[i]; B.dst[b] = G.dst[i]; b++;
    }
  }
  a = b = 0;
  for (int64_t i = 0; i < n; i++) {
    int32_t e = G.order_s[i];
    if (side[e]) A.order_s[a++] = newidx[e];
    else B.order_s[b++] = newidx[e];
  }
  a = b = 0;
  for (int64_t i = 0; i < n; i++) {
    int32_t e = G.order_d[i];
    if (side[e]) A.order_d[a++] = newidx[e];
    else B.order_d[b++] = newidx[e];
  }
}

// Proper deg-edge-coloring by recursive Euler splitting (deg a power of 2).
// `par_depth` > 0 forks the second half onto a thread.
void edge_color(Sub& G, int64_t deg, int64_t base, int64_t* colors,
                int par_depth) {
  const int64_t n = (int64_t)G.ids.size();
  if (deg == 1) {
    for (int64_t i = 0; i < n; i++) colors[G.ids[i]] = base;
    return;
  }
  std::vector<uint8_t> side(n);
  {
    std::vector<int32_t> ptr_s, ptr_d;
    std::vector<uint8_t> visited;
    euler_split(G, n, deg, side.data(), ptr_s, ptr_d, visited);
  }
  if (deg == 2) {
    // deepest level (most total edges): the split IS the 2-coloring —
    // each half is 1-regular, so its recursion would only assign a
    // constant. Writing colors here skips the level's partition (7
    // linear passes) and two deg-1 recursions; outputs are identical.
    for (int64_t i = 0; i < n; i++)
      colors[G.ids[i]] = side[i] ? base : base + 1;
    return;
  }
  Sub A, B;
  {
    std::vector<int32_t> newidx;
    partition(G, side.data(), n, A, B, newidx);
  }
  // free this level's edge arrays before recursing
  std::vector<int32_t>().swap(G.ids);
  std::vector<int32_t>().swap(G.src); std::vector<int32_t>().swap(G.dst);
  std::vector<int32_t>().swap(G.order_s); std::vector<int32_t>().swap(G.order_d);
  if (par_depth > 0) {
    std::thread t([&] { edge_color(A, deg / 2, base, colors, par_depth - 1); });
    edge_color(B, deg / 2, base + deg / 2, colors, par_depth - 1);
    t.join();
  } else {
    edge_color(A, deg / 2, base, colors, 0);
    edge_color(B, deg / 2, base + deg / 2, colors, 0);
  }
}

// Color the full permutation graph: src = i/128 (identity-sorted), dst =
// dest[i]/128; order_d built by one counting sort.
void color_perm(const int64_t* dest, int64_t n, int64_t* colors,
                int par_depth) {
  const int64_t m = n / RADIX;
  Sub G;
  G.ids.resize(n); G.src.resize(n); G.dst.resize(n);
  G.order_s.resize(n); G.order_d.resize(n);
  for (int64_t i = 0; i < n; i++) {
    G.ids[i] = (int32_t)i;
    G.src[i] = (int32_t)(i / RADIX);
    G.dst[i] = (int32_t)(dest[i] / RADIX);
    G.order_s[i] = (int32_t)i;  // already sorted by src
  }
  std::vector<int64_t> cnt(m + 1, 0);
  for (int64_t i = 0; i < n; i++) cnt[G.dst[i] + 1]++;
  for (int64_t v = 0; v < m; v++) cnt[v + 1] += cnt[v];
  for (int64_t i = 0; i < n; i++) G.order_d[cnt[G.dst[i]]++] = (int32_t)i;
  edge_color(G, RADIX, 0, colors, par_depth);
}

// 3-stage (m <= 128) or single-crossbar route of a permutation of n = m*128.
// Writes g1 (m,128), g3 (128,m), g5 (m,128). Returns stage count (1 or 3).
int route3(const int64_t* dest, int64_t n, int32_t* g1, int32_t* g3,
           int32_t* g5, int par_depth) {
  int64_t m = n / RADIX;
  if (m == 1) {
    for (int64_t i = 0; i < n; i++) g1[dest[i]] = (int32_t)i;
    return 1;
  }
  std::vector<int64_t> color(n);
  color_perm(dest, n, color.data(), par_depth);
  std::vector<int64_t> sub_dest(RADIX * m);
  for (int64_t i = 0; i < n; i++) {
    int64_t c = color[i];
    int64_t s = i / RADIX, d = dest[i] / RADIX;
    g1[s * RADIX + c] = (int32_t)(i % RADIX);
    sub_dest[c * m + s] = d;
    g5[d * RADIX + dest[i] % RADIX] = (int32_t)c;
  }
  for (int64_t c = 0; c < RADIX; c++)
    for (int64_t p = 0; p < m; p++) g3[c * m + sub_dest[c * m + p]] = (int32_t)p;
  return 3;
}

}  // namespace

extern "C" {

// Route a permutation of n = m*128 (m <= 128, or m = B*128 with B <= 128).
// g1 (m,128), g5 (m,128); 3-stage: g3 (128,m); 5-stage: g2 (128B,128),
// g3 (128*128,B), g4 (128B,128). Returns the stage count (1, 3 or 5),
// or -1 on an unsupported size.
int64_t clos_route_c(const int64_t* dest, int64_t n, int32_t* g1, int32_t* g2,
                     int32_t* g3, int32_t* g4, int32_t* g5) {
  if (n % RADIX) return -1;
  int64_t m = n / RADIX;
  const int nthreads = hw_threads();
  // fork the Euler halves two levels deep when threads are available
  const int par_depth = nthreads >= 4 ? 2 : (nthreads >= 2 ? 1 : 0);
  if (m <= RADIX) return route3(dest, n, g1, g3, g5, par_depth);
  if (m % RADIX || m > RADIX * RADIX) return -1;
  int64_t B = m / RADIX;

  std::vector<int64_t> color(n);
  color_perm(dest, n, color.data(), par_depth);
  std::vector<int64_t> sub_dest(RADIX * m);
  for (int64_t i = 0; i < n; i++) {
    int64_t c = color[i];
    int64_t s = i / RADIX, d = dest[i] / RADIX;
    g1[s * RADIX + c] = (int32_t)(i % RADIX);
    sub_dest[c * m + s] = d;
    g5[d * RADIX + dest[i] % RADIX] = (int32_t)c;
  }
  // the 128 middle subnets are independent 3-stage routes — thread pool
  std::atomic<int64_t> next(0);
  std::atomic<int> bad(0);
  auto worker = [&]() {
    std::vector<int32_t> s3(RADIX * B);
    for (;;) {
      int64_t c = next.fetch_add(1);
      if (c >= RADIX) break;
      int stages = route3(sub_dest.data() + c * m, m, g2 + c * B * RADIX,
                          s3.data(), g4 + c * B * RADIX, 0);
      if (stages != 3) { bad.store(1); break; }
      std::memcpy(g3 + c * RADIX * B, s3.data(), RADIX * B * sizeof(int32_t));
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < nthreads; t++) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();
  if (bad.load()) return -2;
  return 5;
}

}  // extern "C"
