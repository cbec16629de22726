// Exchange-operator pack metadata for Hopper (sm_90a): three kernels with a
// plain C interface, built with nvcc into a shared library and loaded with
// ctypes by ../hash_partition.py.
//
// Replaces (TPU kernels of the JAX reference package):
//   hash_partition_pack  <- src/repro/kernels/hash_partition.py,
//                           hash_partition_pack / _hash_partition_pack_kernel
//   partition_pack       <- src/repro/kernels/hash_partition.py,
//                           partition_pack / _partition_pack_kernel
//   hash_partition       <- src/repro/kernels/hash_partition.py,
//                           hash_partition / _hash_kernel
//
// What each computes, per block of `block` (<= 256) consecutive rows of one
// shard: the destination of every row (hash_partition_pack only: multiply-xor
// hash, pid = h % P, invalid rows -> overflow bin P), the row's rank among the
// earlier rows of its block with the same destination (arrival order), and the
// block's histogram over `num_bins` bins.  Destinations outside [0, num_bins)
// (the padding id) get rank 0 and are not counted.  Outputs are bit-identical
// to the reference's [T/block, bins] histograms and block-local ranks.
//
// Bound: memory.  hash_partition_pack reads 8 B a row (key, valid) and writes
// 8 B (dest, rank); partition_pack reads 4 B and writes 4 B; the histograms
// add 4 * bins bytes per block.  There is no arithmetic to speak of.
// Design against that bound: one thread per row, so each warp's loads and
// stores are 128 contiguous bytes; the rank and the histogram never leave
// registers and shared memory (8 warps x bins counters); no atomics, so the
// rank keeps arrival order.  The in-warp rank is one __match_any_sync plus a
// popcount; an exclusive scan over the 8 warps' counters gives each warp's
// base and the block histogram.  A grid of (T / block, S) launches every shard
// at once.  Not yet done: several rows per thread and vectorised 16-byte loads.
//
// hash_partition is the hash alone: pid = h % P for every row and the block's
// histogram over P bins, no rank and no mask.  It reads 4 B a row and writes
// 4 B; one thread per row, the peer group's leader adds the group's size to
// a shared counter (integer adds, so the order does not matter).
//
// Every entry point returns cudaGetLastError() after the launch; it launches
// on the given stream, allocates nothing and does not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t fibonacci_hash(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// kHash: compute the destination from (key, valid); else read it from `src`.
template <bool kHash>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ valid,
            int32_t* __restrict__ dest_out, int32_t* __restrict__ hist,
            int32_t* __restrict__ rank, int T, int block, int num_bins,
            int num_partitions) {
  extern __shared__ int32_t counts[];  // [kWarps][num_bins]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nblocks = gridDim.x;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * T +
                      static_cast<int64_t>(blockIdx.x) * block + tid;
  const bool active = tid < block;

  for (int i = tid; i < kWarps * num_bins; i += kThreads) counts[i] = 0;

  int d = -1;
  if (active) {
    if (kHash) {
      const uint32_t h = fibonacci_hash(static_cast<uint32_t>(src[row]));
      const int pid = static_cast<int>(h % static_cast<uint32_t>(num_partitions));
      d = valid[row] != 0 ? pid : num_partitions;
      dest_out[row] = d;
    } else {
      d = src[row];
    }
  }
  const bool counted = active && d >= 0 && d < num_bins;
  const int key = counted ? d : -1;  // -1 is never a bin

  // Lanes of this warp holding the same bin; the earlier ones rank first.
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int warp_rank = __popc(peers & ((1u << lane) - 1u));
  __syncthreads();  // counters zeroed
  if (counted && lane == __ffs(peers) - 1) {
    counts[warp * num_bins + d] = __popc(peers);
  }
  __syncthreads();

  // Exclusive scan over the warps, one thread per bin; the total is the
  // block's histogram entry.
  for (int b = tid; b < num_bins; b += kThreads) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = counts[w * num_bins + b];
      counts[w * num_bins + b] = run;
      run += c;
    }
    hist[(static_cast<int64_t>(blockIdx.y) * nblocks + blockIdx.x) * num_bins + b] = run;
  }
  __syncthreads();

  if (active) rank[row] = counted ? counts[warp * num_bins + d] + warp_rank : 0;
}

__global__ void __launch_bounds__(kThreads)
hash_kernel(const int32_t* __restrict__ keys, int32_t* __restrict__ pid_out,
            int32_t* __restrict__ hist, int T, int block, int num_partitions) {
  extern __shared__ int32_t counts[];  // [num_partitions]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * T +
                      static_cast<int64_t>(blockIdx.x) * block + tid;
  const bool active = tid < block;

  for (int i = tid; i < num_partitions; i += kThreads) counts[i] = 0;
  int p = -1;  // -1 is never a partition
  if (active) {
    const uint32_t h = fibonacci_hash(static_cast<uint32_t>(keys[row]));
    p = static_cast<int>(h % static_cast<uint32_t>(num_partitions));
    pid_out[row] = p;
  }
  const unsigned peers = __match_any_sync(0xffffffffu, p);
  __syncthreads();  // counters zeroed
  if (active && lane == __ffs(peers) - 1) atomicAdd(&counts[p], __popc(peers));
  __syncthreads();
  const int64_t out = (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) * num_partitions;
  for (int b = tid; b < num_partitions; b += kThreads) hist[out + b] = counts[b];
}

inline size_t smem_bytes(int num_bins) {
  return static_cast<size_t>(kWarps) * num_bins * sizeof(int32_t);
}

}  // namespace

extern "C" {

// keys, valid, dest, rank: int32 [S, T]; hist: int32 [S, T / block, P + 1].
int hash_partition_pack_launch(const void* keys, const void* valid, void* dest,
                               void* hist, void* rank, int S, int T, int block,
                               int num_partitions, void* stream) {
  const int num_bins = num_partitions + 1;
  const dim3 grid(T / block, S);
  if (grid.x > 0 && grid.y > 0) {
    pack_kernel<true><<<grid, kThreads, smem_bytes(num_bins),
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(keys), static_cast<const int32_t*>(valid),
        static_cast<int32_t*>(dest), static_cast<int32_t*>(hist),
        static_cast<int32_t*>(rank), T, block, num_bins, num_partitions);
  }
  return static_cast<int>(cudaGetLastError());
}

// dest, rank: int32 [S, T]; hist: int32 [S, T / block, num_bins].
int partition_pack_launch(const void* dest, void* hist, void* rank, int S,
                          int T, int block, int num_bins, void* stream) {
  const dim3 grid(T / block, S);
  if (grid.x > 0 && grid.y > 0) {
    pack_kernel<false><<<grid, kThreads, smem_bytes(num_bins),
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(dest), nullptr, nullptr,
        static_cast<int32_t*>(hist), static_cast<int32_t*>(rank), T, block,
        num_bins, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// keys, pid: int32 [S, T]; hist: int32 [S, T / block, P].
int hash_partition_launch(const void* keys, void* pid, void* hist, int S, int T,
                          int block, int num_partitions, void* stream) {
  const dim3 grid(T / block, S);
  if (grid.x > 0 && grid.y > 0) {
    hash_kernel<<<grid, kThreads, num_partitions * sizeof(int32_t),
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(keys), static_cast<int32_t*>(pid),
        static_cast<int32_t*>(hist), T, block, num_partitions);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
