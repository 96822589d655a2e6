// Sorted segment sum over a tile-aligned plan, for Hopper (sm_90a).
//
// Replaces janusgraph_tpu/olap/kernels.py::pallas_sorted_segment_sum. For
// each output segment it computes the fp32 sum of its edges' values, and
// zero for a segment with no edges. The plan is the reference's, read as
// built (janusgraph_tpu_torch/olap/kernels.py::_SegSumPlan): the edges of
// output tile t (T segments wide) occupy plan slots
// [tile_block_ptr[t] * B, tile_block_ptr[t + 1] * B); a slot holds its edge
// (gather_idx), a 1/0 validity flag (pad_mask) and its segment inside the
// tile (seg_local), sorted ascending within the tile.
//
// What bounds it: memory. The sum itself needs each edge's value and
// segment id read once and each sum written once, 4 * (2E + n) bytes; it
// does about one add per edge, far below what the card computes in that
// time. At graph500 scale 20 (E = 16,777,216 edges, n = 1,048,576) that is
// 138,412,032 bytes, 0.0413 ms at 3.35 TB/s. Over the plan this kernel
// moves more: pad_mask for every one of the E' padded slots, gather_idx,
// seg_local and data for each valid slot, and the padded output, 4 * (E' +
// 3E + n') bytes (E' = 17,310,720 slots in 1,024 tiles at scale 20:
// 274,767,876 bytes). It took 0.201 ms there, about 20 % of the bound, on
// an H100 80GB HBM3 at a 700 W power limit, measured by chip_smoke.py.
//
// Design. On the TPU the grid runs in order, so one tile accumulator is
// carried from block to block. Here one CTA owns one output tile: it keeps
// the tile's T fp32 sums in shared memory, walks the tile's slots in plan
// order, 1024 at a time, and writes the tile once. No global atomics, no
// second pass. Within a chunk of 1024 slots each warp runs a segmented
// inclusive scan with shuffles, warp 0 scans the 32 warp tails, each warp's
// first run takes the carry of the warps before it, and the one slot that
// ends a segment's run in the chunk adds the run total to the shared sum.
// Every add happens in a fixed order, so two launches on the same input
// give the same bits. The next chunk's loads are issued before the current
// chunk's scans to hide part of the load latency.
//
// Known limits: a tile whose destinations own many edges (an R-MAT hub)
// is walked by one CTA alone while the rest of the card idles at the end
// of the grid. At scale 20 the heaviest tile has 78 blocks against a mean
// of 16.5; PERF.md records what that costs.
//
// One difference from the reference: padded slots are skipped, not
// multiplied by 0. The reference computes data[gather_idx] * pad_mask, so a
// non-finite data[0] turns the padded slots, and through them the sums of
// segments in those tiles, into NaN (kernels.py:785). Here they stay finite.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
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

// One plan slot: its segment inside the tile (`tile` for a padded or
// out-of-range slot, which is read as no edge at all) and its value.
__device__ __forceinline__ void load_slot(
    const float* __restrict__ data, const int32_t* __restrict__ gather_idx,
    const float* __restrict__ pad_mask, const int32_t* __restrict__ seg_local,
    int64_t p, int64_t end, int tile, int& key, float& v) {
  key = tile;
  v = 0.0f;
  if (p < end && __ldg(pad_mask + p) != 0.0f) {
    key = __ldg(seg_local + p);
    v = __ldg(data + __ldg(gather_idx + p));
  }
}

__global__ void __launch_bounds__(kThreads, 2) segsum_tile_kernel(
    const float* __restrict__ data, const int32_t* __restrict__ gather_idx,
    const float* __restrict__ pad_mask, const int32_t* __restrict__ seg_local,
    const int32_t* __restrict__ tile_block_ptr, int block, int tile,
    float* __restrict__ out) {
  extern __shared__ float acc[];  // the tile's T sums
  __shared__ int head_key[kWarps];
  __shared__ int tail_key[kWarps];
  __shared__ float tail_val[kWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = blockIdx.x;
  const int64_t s0 = static_cast<int64_t>(tile_block_ptr[t]) * block;
  const int64_t s1 = static_cast<int64_t>(tile_block_ptr[t + 1]) * block;

  for (int i = threadIdx.x; i < tile; i += kThreads) acc[i] = 0.0f;

  int key;
  float v;
  load_slot(data, gather_idx, pad_mask, seg_local, s0 + threadIdx.x, s1, tile, key, v);
  __syncthreads();

  for (int64_t base = s0; base < s1; base += kThreads) {
    const int cur_key = key;
    float cur = v;
    load_slot(data, gather_idx, pad_mask, seg_local, base + kThreads + threadIdx.x,
              s1, tile, key, v);

    cur = warp_segmented_scan(lane, cur_key, cur);
    const int next_key = __shfl_down_sync(kFull, cur_key, 1);
    if (lane == 0) head_key[warp] = cur_key;
    if (lane == 31) {
      tail_key[warp] = cur_key;
      tail_val[warp] = cur;
    }
    __syncthreads();
    if (warp == 0) {
      // tail_val[w] becomes the sum of segment tail_key[w] from the chunk's
      // start through the end of warp w
      tail_val[lane] = warp_segmented_scan(lane, tail_key[lane], tail_val[lane]);
    }
    __syncthreads();
    if (warp > 0 && tail_key[warp - 1] == cur_key) cur += tail_val[warp - 1];
    bool run_end;
    if (lane < 31) {
      run_end = next_key != cur_key;
    } else {
      run_end = warp == kWarps - 1 || head_key[warp + 1] != cur_key;
    }
    // one writer per segment per chunk, chunks in plan order
    if (run_end && cur_key < tile) acc[cur_key] += cur;
    __syncthreads();
  }

  float* o = out + t * tile;
  for (int i = threadIdx.x; i < tile; i += kThreads) o[i] = acc[i];
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). Pointers
// are device pointers; `out` holds num_tiles * tile floats.
extern "C" int jg_sorted_segment_sum(
    const void* data, const void* gather_idx, const void* pad_mask,
    const void* seg_local, const void* tile_block_ptr, int num_tiles, int block,
    int tile, void* out, void* stream) {
  if (num_tiles <= 0) return 0;
  const size_t smem = static_cast<size_t>(tile) * sizeof(float);
  segsum_tile_kernel<<<num_tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int32_t*>(gather_idx),
      static_cast<const float*>(pad_mask), static_cast<const int32_t*>(seg_local),
      static_cast<const int32_t*>(tile_block_ptr), block, tile,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* jg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
