// Sorted segment sum over a merge-path split of the work, for Hopper (sm_90a).
//
// Replaces janusgraph_tpu/olap/kernels.py::pallas_sorted_segment_sum
// (pl.pallas_call at :812). For each output segment s it computes the fp32
// sum of data[seg_ptr[s] : seg_ptr[s + 1]], and 0 for a segment with no
// edges. Edges are sorted by segment, so the n + 1 segment offsets seg_ptr
// carry everything the reference plan's per-slot arrays carry; this kernel
// reads none of those.
//
// What bounds it: memory. The sum needs each value read once, the offsets
// read once and each sum written once, 4 * (E + 2n + 1) bytes; it does one
// add per edge, far below what the card computes in that time. At graph500
// scale 20 (E = 16,777,216 edges, n = 1,048,576 segments) that is
// 75,497,476 bytes, 0.022537 ms at 3.35 TB/s.
//
// Design: the merge-path split of Merrill and Garland ("Merge-based Parallel
// Sparse Matrix-Vector Multiplication", SC '16). Merge the n segment ends
// seg_ptr[1:] with the E edge indices; the host cuts the n + E items into
// runs of items_per_cta (_SegSumPlan: CTA k starts at segment end
// seg_start[k] and edge edge_start[k]). Every CTA gets the same number of
// items however the edges fall into segments, so an R-MAT hub is spread over
// many CTAs instead of one CTA walking it alone. CTA k:
//   1. copies its values data[edge_start[k] : edge_start[k + 1]] and its
//      segment ends seg_ptr[seg_start[k] + 1 : seg_start[k + 1] + 1] into
//      shared memory: one cp.async.bulk each for the 16-byte-aligned
//      interior, completing on one mbarrier; the at most 3 elements before
//      and after it are plain loads, so no byte outside the arrays is read.
//      The ~15 KB of staging is all the shared memory a CTA uses, so 8 CTAs
//      (the most 256-thread CTAs an SM holds) share an SM, each with its
//      whole copy in flight at once.
//   2. each thread finds its first item by a binary search over the CTA's
//      segment ends and walks a fixed run of 15 consecutive items in order,
//      without branches: an edge adds its value to a running sum, a segment
//      end closes the segment. A segment the thread opened and closed is
//      final; its sum takes the place of its staged end, which no other
//      thread reads once the searches are done.
//   3. the first segment a thread closes may have started in the threads
//      before it: a block-wide segmented scan of the threads' open runs by
//      segment (warp shuffles, then one scan of the warp totals) gives it
//      their sum.
//   4. the sums go from shared memory to out coalesced; the run still open
//      at the CTA's end (segment seg_start[k + 1]) goes to carry[k]. The
//      first segment of a CTA after the first began in the CTA before: its
//      part goes to head[k] instead of out.
// A second launch, one CTA, writes those segments: the carries of the run
// of CTAs that ends just before the closing CTA, summed in CTA order, plus
// that CTA's head. Every segment is written exactly once, and out is never
// read.
//
// Every add happens in an order fixed by the partition and no atomics touch
// a float, so two launches on the same input give the same bits. The fix-up
// also adds one to a device-side launch counter when the caller passes one:
// a call replayed from a CUDA graph runs without the host wrapper, and the
// counter still sees it. No tensor
// cores: the function is one add per edge. The TPU kernel did T = 1024
// multiply-adds per edge as a one-hot (B, T) matmul only because its matrix
// unit was otherwise idle; here that would be 1024 times the work.
//
// Measured by chip_smoke.py at scale 20 on an NVIDIA H100 80GB HBM3 at a
// 700 W power limit: 0.0495-0.0501 ms with the L2 flushed by writing, 0.0439
// ms after a flush that leaves it clean, 0.0421-0.0446 ms back to back;
// 0.45 of the bound (flushed). The merge pass takes ~36 us of it and the
// fix-up ~7 us. What holds it back is in PERF.md.
//
// One difference from the reference: it has no padded slots. The reference
// computes data[gather_idx] * pad_mask, so a non-finite data[0] turns the
// padded slots, and through the one-hot matmul every segment of a padded
// tile, into NaN (kernels.py:785). Here a non-finite value reaches its own
// segment only (tests/test_torch_segsum_plan.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // threads of the main kernel
constexpr int kItemsPerThread = 15;  // odd: a warp's runs spread over the banks
constexpr int kMaxItemsPerCta = kThreads * kItemsPerThread;
constexpr int kPad = 12;             // alignment slack of the staging, words
constexpr int kFixThreads = 1024;    // threads of the fix-up kernel
constexpr int kFixBatch = 8;         // carries a fix-up thread loads at once
constexpr unsigned kFull = 0xffffffffu;

// Inclusive segmented scan across the warp: lanes with equal keys (which
// are contiguous, keys being sorted) sum the values of the lanes up to them.
__device__ __forceinline__ float warp_segmented_scan(int lane, int key, float v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up_v = __shfl_up_sync(kFull, v, off);
    const int up_k = __shfl_up_sync(kFull, key, off);
    if (lane >= off && up_k == key) v += up_v;
  }
  return v;
}

// Segmented scan by key over the block, keys nondecreasing in thread order.
// Returns the inclusive value of the thread before (0 for thread 0): the
// carry into this thread's first run. *total gets the last thread's
// inclusive value. Every thread of the block must call it.
template <int kT>
__device__ __forceinline__ float block_carry_in(int key, float v, float* total) {
  constexpr int kW = kT / 32;
  __shared__ int wkey[kW];
  __shared__ float wval[kW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_segmented_scan(lane, key, v);
  if (lane == 31) {
    wkey[warp] = key;
    wval[warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
    // wval[w] becomes the inclusive value of the last thread of warp w;
    // lanes at or above kW take no part (shuffles only read lower lanes)
    const int k = lane < kW ? wkey[lane] : 0;
    const float x = lane < kW ? wval[lane] : 0.0f;
    const float s = warp_segmented_scan(lane, k, x);
    if (lane < kW) wval[lane] = s;
  }
  __syncthreads();
  if (warp > 0 && wkey[warp - 1] == key) v += wval[warp - 1];
  float prev = __shfl_up_sync(kFull, v, 1);
  if (lane == 0) prev = warp > 0 ? wval[warp - 1] : 0.0f;
  *total = wval[kW - 1];
  return prev;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A range [g0, g1) of 4-byte elements: [lo, hi) is its 16-byte-aligned
// interior, copied in bulk (empty: lo == hi == g1, all plain loads).
struct Span {
  int64_t lo, hi;
};

__device__ __forceinline__ Span span_of(const void* base, int64_t g0, int64_t g1) {
  const int64_t phase = static_cast<int64_t>(reinterpret_cast<uintptr_t>(base) >> 2);
  Span s;
  s.lo = g0 + ((4 - ((phase + g0) & 3)) & 3);
  s.hi = g1 - ((phase + g1) & 3);
  if (s.hi <= s.lo) s.lo = s.hi = g1;
  return s;
}

// buf[g - g0] = src[g] for g in [g0, g1) outside the bulk interior: at most
// 3 elements on each side, or 7 where there is no interior.
template <typename T>
__device__ __forceinline__ void load_edges(const T* __restrict__ src, int64_t g0,
                                           int64_t g1, Span s, T* buf) {
  const int head = static_cast<int>(s.lo - g0);
  const int n = head + static_cast<int>(g1 - s.hi);
  const int i = static_cast<int>(threadIdx.x) - 32;  // warp 0 issues the bulk copies
  if (i >= 0 && i < n) {
    const int64_t g = i < head ? g0 + i : s.hi + (i - head);
    buf[g - g0] = src[g];
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__global__ void __launch_bounds__(kThreads) segsum_merge_kernel(
    const float* __restrict__ data, const int32_t* __restrict__ seg_ptr,
    const int32_t* __restrict__ seg_start, const int32_t* __restrict__ edge_start,
    float* __restrict__ carry, float* __restrict__ head, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;

  const int k = blockIdx.x;
  const int s0 = seg_start[k], s1 = seg_start[k + 1];
  const int e0 = edge_start[k], e1 = edge_start[k + 1];
  const int ns = s1 - s0;  // segment ends s0 .. s1 - 1 close here
  const int ne = e1 - e0;  // edges e0 .. e1 - 1 are summed here

  // vals[j] = data[e0 + j]; ends[i] = seg_ptr[s0 + 1 + i], the end of
  // segment s0 + i; each placed so that its bulk interior is 16-byte aligned
  const Span sv = span_of(data, e0, e1);
  const Span se = span_of(seg_ptr, s0 + 1, s1 + 1);
  const int vphase = static_cast<int>((reinterpret_cast<uintptr_t>(data) >> 2) + e0) & 3;
  const int ephase = static_cast<int>((reinterpret_cast<uintptr_t>(seg_ptr) >> 2) + s0 + 1) & 3;
  float* vals = smem + vphase;
  int32_t* ends = reinterpret_cast<int32_t*>(smem + ((vphase + ne + 3) & ~3)) + ephase;

  const uint32_t bar_addr = smem_addr(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_addr) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t vbytes = static_cast<uint32_t>(sv.hi - sv.lo) * 4;
    const uint32_t ebytes = static_cast<uint32_t>(se.hi - se.lo) * 4;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar_addr), "r"(vbytes + ebytes)
                 : "memory");
    if (vbytes) bulk_copy(vals + (sv.lo - e0), data + sv.lo, vbytes, bar_addr);
    if (ebytes) bulk_copy(ends + (se.lo - (s0 + 1)), seg_ptr + se.lo, ebytes, bar_addr);
  }
  load_edges(data, e0, e1, sv, vals);
  load_edges(seg_ptr, static_cast<int64_t>(s0) + 1, static_cast<int64_t>(s1) + 1, se, ends);
  // past the last end a sentinel no edge reaches: the walk needs no bound
  if (threadIdx.x == 64) ends[ns] = INT32_MAX;
  while (!mbar_try_wait(bar_addr, 0)) {
  }
  __syncthreads();

  // this thread's items [lo, hi) of the CTA's ns + ne; segment end i is
  // item i + ends[i] - e0 (its edges come before it), so the number of ends
  // among the first lo items is a lower bound over that increasing sequence
  const int total = ns + ne;
  const int lo = min(static_cast<int>(threadIdx.x) * kItemsPerThread, total);
  const int hi = min(lo + kItemsPerThread, total);
  int a = max(0, lo - ne), b = min(lo, ns);
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (mid + ends[mid] - e0 < lo) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  const int i0 = a;
  int i = a;            // next segment end
  int j = e0 + lo - a;  // next edge, as a global index
  const float* vals_g = vals - e0;
  // from here on a thread reads only ends[i0 .. its last end + 1], and the
  // sum of segment s0 + i replaces ends[i] once the thread that closes it
  // has read it: the first end of each thread is overwritten only after
  // the scan's barriers
  __syncthreads();
  float run = 0.0f, first = 0.0f;
  bool closed = false;
  // both loads issued together and no branch: the item is segment end i if
  // that segment ends before edge j (vals_g[j] past the last edge is read
  // and dropped)
#pragma unroll
  for (int u = 0; u < kItemsPerThread; ++u) {
    if (lo + u < hi) {
      const bool is_end = ends[i] <= j;
      const float v = vals_g[j];
      if (is_end && closed) ends[i] = __float_as_int(run);
      first = is_end && !closed ? run : first;
      closed = closed || is_end;
      run = is_end ? 0.0f : run + v;
      i += is_end;
      j += !is_end;
    }
  }

  // the run open at this thread's end belongs to segment s0 + i
  float cta_total;
  const float carry_in = block_carry_in<kThreads>(s0 + i, run, &cta_total);
  if (closed) ends[i0] = __float_as_int(carry_in + first);
  __syncthreads();
  // segment s0 of a CTA after the first began in the CTA before: its part
  // here goes to head[k], and the fix-up writes its sum
  for (int x = threadIdx.x + (k > 0); x < ns; x += kThreads) out[s0 + x] = __int_as_float(ends[x]);
  if (threadIdx.x == 0) {
    carry[k] = cta_total;
    if (k > 0 && ns > 0) head[k] = __int_as_float(ends[0]);
  }
}

// carry[c] is CTA c's part of segment seg_start[c + 1], the segment open at
// its end (num_segments after the last CTA). A run of CTAs with the same open
// segment ends just before the CTA that closes it, whose own part is in
// head[]: the segment's sum is the run's sum plus that part, in CTA order.
// Every load comes before the stores it feeds, and out is only written.
__global__ void __launch_bounds__(kFixThreads) segsum_fixup_kernel(
    const int32_t* __restrict__ seg_start, const float* __restrict__ carry,
    const float* __restrict__ head, int num_ctas, int num_segments, float* __restrict__ out,
    unsigned long long* __restrict__ launches) {
  // one CTA, and the calls on a stream run one after another: thread 0's
  // increment needs no atomic
  if (launches != nullptr && threadIdx.x == 0) *launches += 1ULL;
  const int per_thread = (num_ctas + kFixThreads - 1) / kFixThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per_thread, num_ctas);
  const int hi = min(lo + per_thread, num_ctas);
  float run = 0.0f, first = 0.0f, first_head = 0.0f;
  int first_key = -1;
  for (int base = lo; base < hi; base += kFixBatch) {
    // all loads of a batch first, so their latencies overlap
    int key[kFixBatch + 1];
    float v[kFixBatch], h[kFixBatch];
#pragma unroll
    for (int u = 0; u <= kFixBatch; ++u) {
      key[u] = base + u < num_ctas ? seg_start[base + u + 1] : -1;
    }
#pragma unroll
    for (int u = 0; u < kFixBatch; ++u) {
      v[u] = base + u < hi ? carry[base + u] : 0.0f;
      h[u] = base + u + 1 < num_ctas ? head[base + u + 1] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kFixBatch; ++u) {
      if (base + u < hi) {
        run += v[u];
        if (key[u + 1] != key[u] && key[u + 1] >= 0) {  // CTA c + 1 closes segment key[u]
          if (first_key >= 0) {
            out[key[u]] = run + h[u];
          } else {
            first = run;
            first_head = h[u];
            first_key = key[u];
          }
          run = 0.0f;
        }
      }
    }
  }
  const int open_key = hi < num_ctas ? seg_start[hi + 1] : num_segments;
  float unused;
  const float carry_in = block_carry_in<kFixThreads>(open_key, run, &unused);
  if (first_key >= 0) out[first_key] = (carry_in + first) + first_head;
}

// The merge kernel's dynamic shared memory: the staged values and ends.
size_t merge_smem_bytes(int items_per_cta) {
  return (static_cast<size_t>(items_per_cta) + kPad) * sizeof(float);
}

// All of each SM's unified memory as shared memory for the merge kernel, so
// that as many CTAs fit as threads allow.
cudaError_t set_carveout() {
  return cudaFuncSetAttribute(segsum_merge_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Launch both kernels on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue without launching if items_per_cta is
// outside [1, kMaxItemsPerCta]. Pointers are device pointers: seg_ptr
// (num_segments + 1), seg_start and edge_start (num_ctas + 1) int32;
// carry (2 * num_ctas floats: each CTA's open run, then its part of its
// first segment) is scratch; out (num_segments floats) the result.
extern "C" int jg_sorted_segment_sum(
    const void* data, const void* seg_ptr, const void* seg_start, const void* edge_start,
    int num_ctas, int items_per_cta, int num_segments, void* carry, void* out,
    void* launches, void* stream) {
  if (items_per_cta < 1 || items_per_cta > kMaxItemsPerCta) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_ctas <= 0) return 0;
  cudaError_t e = set_carveout();
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto s = static_cast<cudaStream_t>(stream);
  float* carry_v = static_cast<float*>(carry);
  float* head_v = carry_v + num_ctas;
  segsum_merge_kernel<<<num_ctas, kThreads, merge_smem_bytes(items_per_cta), s>>>(
      static_cast<const float*>(data), static_cast<const int32_t*>(seg_ptr),
      static_cast<const int32_t*>(seg_start), static_cast<const int32_t*>(edge_start),
      carry_v, head_v, static_cast<float*>(out));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  segsum_fixup_kernel<<<1, kFixThreads, 0, s>>>(
      static_cast<const int32_t*>(seg_start), carry_v, head_v, num_ctas, num_segments,
      static_cast<float*>(out), static_cast<unsigned long long*>(launches));
  return static_cast<int>(cudaGetLastError());
}

// How many CTAs of the merge kernel share an SM at this items_per_cta (0 on
// error).
extern "C" int jg_segsum_ctas_per_sm(int items_per_cta) {
  int n = 0;
  if (set_carveout() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, segsum_merge_kernel, kThreads, merge_smem_bytes(items_per_cta)) != cudaSuccess) {
    return 0;
  }
  return n;
}

extern "C" const char* jg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
