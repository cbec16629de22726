// Capacity-bounded token -> expert slot assignment for Hopper (sm_90a), with a
// plain C interface, built with nvcc into a shared library and loaded with
// ctypes by ../moe_dispatch.py.
//
// Replaces (TPU kernel of the JAX reference package):
//   moe_dispatch  <- src/repro/kernels/moe_dispatch.py,
//                    moe_dispatch / _dispatch_kernel
//
// What it computes, for each shard s of dest [S, T] (expert ids, one per
// (token, choice) in arrival order): rank = the number of earlier rows of
// the shard with the same expert; slot = e * C + rank if rank < C, else the
// drop bin E * C; and counts[s, e] = min(rows of expert e, C).  Ids outside
// [0, E) (the wrapper's padding id E among them) match no expert: they land
// in the drop bin and are not counted.  The outputs are bit-identical to the
// reference's one-hot + cumsum.
//
// The TPU kernel carries a running per-expert histogram in VMEM across a
// sequential grid.  Here one block of 1024 threads owns one shard and walks
// its rows in tiles of 1024: the tile loop takes the place of the sequential
// grid, and the running histogram (`base`, E counters) stays in shared
// memory.  Per tile: one row per thread; __match_any_sync groups the lanes of
// a warp with the same expert, and a popcount of the lower peers gives the
// in-warp rank; the group's lowest lane writes the group size into the
// warp's row of a [32 warps][E] table; an exclusive scan over the 32 warps
// (one warp per expert, lane w holding warp w's count, five shuffles) plus
// `base` gives each warp's first rank, and the scan's total advances `base`.
// No atomics, so ranks keep arrival order exactly.  One launch covers every
// shard (grid = S).
//
// Bound: memory, and in practice launch latency.  The kernel reads 4 B and
// writes 4 B a row plus 4 * E bytes of counts per shard: at the decode shape
// (S=8, T=64) that is 6 KB, at the prefill shape (S=8, T=16,384) 1 MB, under
// a microsecond at 3.35 TB/s either way.  Not yet done: a shard spread over
// several blocks (a decoupled look-back scan over tiles); with S blocks only
// S of the 132 SMs work.
//
// The entry point returns cudaGetLastError() after the launch; it launches
// on the given stream, allocates nothing and does not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
dispatch_kernel(const int32_t* __restrict__ dest, int32_t* __restrict__ slot,
                int32_t* __restrict__ counts, int T, int num_experts,
                int capacity) {
  extern __shared__ int32_t smem[];
  int32_t* warp_counts = smem;                  // [kWarps][E]
  int32_t* base = smem + kWarps * num_experts;  // [E] rows before this tile
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t shard = blockIdx.x;
  const int32_t* d_in = dest + shard * T;
  int32_t* s_out = slot + shard * T;
  const int drop = num_experts * capacity;

  for (int e = tid; e < num_experts; e += kThreads) base[e] = 0;

  for (int t0 = 0; t0 < T; t0 += kThreads) {
    for (int i = tid; i < kWarps * num_experts; i += kThreads) warp_counts[i] = 0;
    const int t = t0 + tid;
    const bool active = t < T;
    const int d = active ? d_in[t] : -1;
    const bool counted = active && d >= 0 && d < num_experts;
    const int key = counted ? d : -1;  // -1 is never an expert

    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int warp_rank = __popc(peers & ((1u << lane) - 1u));
    __syncthreads();  // table zeroed; `base` set (first tile) or advanced
    if (counted && lane == __ffs(peers) - 1) {
      warp_counts[warp * num_experts + d] = __popc(peers);
    }
    __syncthreads();

    // Exclusive scan over the warps, one warp per expert: lane w holds warp
    // w's count; the result is the rank of warp w's first row of expert e.
    for (int e = warp; e < num_experts; e += kWarps) {
      const int c = warp_counts[lane * num_experts + e];
      const int before = base[e];
      int incl = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      warp_counts[lane * num_experts + e] = before + incl - c;
      __syncwarp();  // every lane has read base[e]
      if (lane == 31) base[e] = before + incl;
    }
    __syncthreads();

    if (active) {
      const int rank = counted ? warp_counts[warp * num_experts + d] + warp_rank : 0;
      s_out[t] = counted && rank < capacity ? d * capacity + rank : drop;
    }
    __syncthreads();  // the table is read before the next tile zeroes it
  }

  for (int e = tid; e < num_experts; e += kThreads) {
    counts[shard * num_experts + e] = min(base[e], capacity);
  }
}

}  // namespace

extern "C" {

// dest, slot: int32 [S, T]; counts: int32 [S, E].
int moe_dispatch_launch(const void* dest, void* slot, void* counts, int S,
                        int T, int num_experts, int capacity, void* stream) {
  const size_t smem = static_cast<size_t>(kWarps + 1) * num_experts * sizeof(int32_t);
  if (S > 0) {
    dispatch_kernel<<<S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(dest), static_cast<int32_t*>(slot),
        static_cast<int32_t*>(counts), T, num_experts, capacity);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
