// Native host runtime: bulk graph-structure kernels.
//
// The reference's data-plane hot loops are JVM object churn
// (EdgeSerializer.parseRelation per cell, NonBlockingHashMapLong inserts);
// this framework's host hot loops are array passes: CSR assembly (the OLAP
// bulk loader), ELLPACK slot filling, and R-MAT edge synthesis. They are
// implemented here as flat-array C++ (counting sort, no Python object
// traffic), exposed through ctypes (no pybind11 in the image).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread (driven by
// janusgraph_tpu_torch/_build.py, into _build/<source hash>/; the port's
// native.py keeps numpy versions of every entry point for hosts without a
// compiler). The JAX package's host library's source, so both packages
// draw the same R-MAT edges from the same seed; build_csr also sorts on
// several threads here (the same arrays).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

// shared worker-count policy for every parallel entry point
static unsigned worker_threads() {
  unsigned n = std::thread::hardware_concurrency();
  if (n == 0) n = 1;
  if (n > 16) n = 16;
  return n;
}

// Run fn(t) for t in [0, threads) on that many threads and join them.
template <typename Fn>
static void parallel_for(unsigned threads, Fn fn) {
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < threads; ++t) ts.emplace_back(fn, t);
  for (auto& th : ts) th.join();
}

// Edges from which build_csr sorts on several threads
static const int64_t kParallelEdges = 1 << 16;

// One orientation: a stable counting sort of the edges by key[i].
//   indptr: (n+1,) offsets; vals[p] = other[i] and perm[p] = i for the edge
//   i at sorted slot p, edges of one key in input order.
// On T threads each thread counts its contiguous chunk of the edges into its
// own histogram; each chunk's first slot per key is the key's offset plus
// the counts of the chunks before it (so the order within a key stays the
// input order, whatever T); then each thread scatters its chunk. The
// histograms are int32, so m < 2^31 (native.py refuses more).
static void sort_by_key(int64_t n, int64_t m, const int32_t* key, const int32_t* other,
                        int64_t* indptr, int32_t* vals, int64_t* perm, unsigned threads) {
  std::vector<int32_t> slot((size_t)threads * (size_t)n, 0);
  auto lo = [&](unsigned t, int64_t total) { return total * (int64_t)t / (int64_t)threads; };
  parallel_for(threads, [&](unsigned t) {
    int32_t* h = slot.data() + (size_t)t * n;
    for (int64_t i = lo(t, m); i < lo(t + 1, m); ++i) ++h[key[i]];
  });
  parallel_for(threads, [&](unsigned t) {
    for (int64_t v = lo(t, n); v < lo(t + 1, n); ++v) {
      int64_t total = 0;
      for (unsigned c = 0; c < threads; ++c) total += slot[(size_t)c * n + v];
      indptr[v + 1] = total;
    }
  });
  indptr[0] = 0;
  for (int64_t v = 0; v < n; ++v) indptr[v + 1] += indptr[v];
  parallel_for(threads, [&](unsigned t) {
    for (int64_t v = lo(t, n); v < lo(t + 1, n); ++v) {
      int64_t run = indptr[v];
      for (unsigned c = 0; c < threads; ++c) {
        int32_t k = slot[(size_t)c * n + v];
        slot[(size_t)c * n + v] = (int32_t)run;
        run += k;
      }
    }
  });
  parallel_for(threads, [&](unsigned t) {
    int32_t* h = slot.data() + (size_t)t * n;
    for (int64_t i = lo(t, m); i < lo(t + 1, m); ++i) {
      int64_t p = h[key[i]]++;
      vals[p] = other[i];
      perm[p] = i;
    }
  });
}

extern "C" {

// Counting-sort both CSR orientations, m < 2^31.
//   src/dst:     (m,) int32 edge endpoints in [0, n)
//   out_indptr:  (n+1,) int64   out_dst: (m,) int32   out_perm: (m,) int64
//   in_indptr:   (n+1,) int64   in_src:  (m,) int32   in_perm:  (m,) int64
// perm arrays map sorted edge slots back to original edge indices (for
// aligning weights), matching numpy argsort(kind="stable") semantics. From
// kParallelEdges edges each orientation sorts on worker_threads() threads
// (the same arrays: a stable sort has one result).
void build_csr(int64_t n, int64_t m,
               const int32_t* src, const int32_t* dst,
               int64_t* out_indptr, int32_t* out_dst, int64_t* out_perm,
               int64_t* in_indptr, int32_t* in_src, int64_t* in_perm) {
  unsigned threads = m < kParallelEdges ? 1 : worker_threads();
  sort_by_key(n, m, src, dst, out_indptr, out_dst, out_perm, threads);
  sort_by_key(n, m, dst, src, in_indptr, in_src, in_perm, threads);
}

// Expand an indptr into per-slot segment ids: seg[indptr[v]..indptr[v+1]) = v,
// clamped to the output buffer length m (matching numpy repeat(...)[:m]).
void segment_ids(int64_t n, int64_t m, const int64_t* indptr, int32_t* seg) {
  for (int64_t v = 0; v < n; ++v) {
    int64_t lo = std::min(indptr[v], m);
    int64_t hi = std::min(indptr[v + 1], m);
    for (int64_t e = lo; e < hi; ++e) seg[e] = (int32_t)v;
  }
}

// Fill one ELLPACK bucket: for `rows` member vertices with degrees deg[r]
// and edge ranges starting at starts[r] in the dst-sorted edge arrays,
// write idx/weight/valid matrices of width `cap` (pre-filled by caller with
// sentinel/0/0).
void ell_fill(int64_t rows, int64_t cap,
              const int64_t* starts, const int64_t* degs,
              const int32_t* sorted_src, const float* sorted_w,
              int32_t* idx, float* wmat, float* valid) {
  // row-parallel: rows are disjoint output ranges, so threads never touch
  // the same cells (s23 fill was ~40s single-threaded)
  auto fill_range = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      int64_t base = r * cap;
      int64_t s = starts[r];
      int64_t d = degs[r];
      for (int64_t j = 0; j < d; ++j) {
        idx[base + j] = sorted_src[s + j];
        if (wmat) wmat[base + j] = sorted_w ? sorted_w[s + j] : 1.0f;
        if (valid) valid[base + j] = 1.0f;
      }
    }
  };
  unsigned nthreads = worker_threads();
  if (rows < 4096 || nthreads == 1) {
    fill_range(0, rows);
    return;
  }
  int64_t chunk = (rows + nthreads - 1) / nthreads;
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < nthreads; ++t) {
    int64_t lo = (int64_t)t * chunk;
    int64_t hi = lo + chunk < rows ? lo + chunk : rows;
    if (lo >= hi) break;
    ts.emplace_back(fill_range, lo, hi);
  }
  for (auto& th : ts) th.join();
}

// R-MAT edge synthesis (graph500 generator shape), SplitMix64 PRNG.
// a,b,c,d are the quadrant probabilities scaled to 2^32.
static inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

void rmat_edges(int64_t scale, int64_t m, uint64_t seed,
                double a, double b, double c,
                int32_t* src, int32_t* dst) {
  // fixed chunk grid (NOT thread-count-dependent): the same seed yields the
  // same edge list on any machine; threads just pick up chunks
  const int64_t NCHUNKS = 64;
  unsigned nthreads = worker_threads();
  int64_t chunk = (m + NCHUNKS - 1) / NCHUNKS;
  std::atomic<int64_t> next_chunk(0);
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < nthreads; ++t) {
    ts.emplace_back([&, seed, scale, m, a, b, c, chunk]() {
      for (;;) {
        int64_t ci = next_chunk.fetch_add(1);
        if (ci >= NCHUNKS) break;
        int64_t lo = ci * chunk, hi = std::min(m, lo + chunk);
        uint64_t s = seed + 0x9e3779b97f4a7c15ULL * (uint64_t)(ci + 1);
        for (int64_t i = lo; i < hi; ++i) {
        uint32_t u = 0, v = 0;
        for (int64_t bit = 0; bit < scale; ++bit) {
          double r = (double)(splitmix64(s) >> 11) * (1.0 / 9007199254740992.0);
          uint32_t ubit, vbit;
          if (r < a)           { ubit = 0; vbit = 0; }
          else if (r < a + b)  { ubit = 0; vbit = 1; }
          else if (r < a + b + c) { ubit = 1; vbit = 0; }
          else                 { ubit = 1; vbit = 1; }
          u = (u << 1) | ubit;
          v = (v << 1) | vbit;
        }
        src[i] = (int32_t)u;
        dst[i] = (int32_t)v;
        }
      }
    });
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"
