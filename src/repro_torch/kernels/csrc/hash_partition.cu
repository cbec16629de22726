// Exchange-operator pack metadata for Hopper (sm_90a): three entry points
// over two kernel templates, with a plain C interface, built with nvcc into
// a shared library and loaded with ctypes by ../hash_partition.py.
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
// shard: the destination of every row (hash_partition_pack: multiply-xor
// hash, pid = h % P, invalid rows -> overflow bin P; hash_partition: pid =
// h % P; partition_pack: given), the row's rank among the earlier rows of its
// block with the same destination (arrival order; not hash_partition), and
// the block's histogram over `num_bins` bins.  Destinations outside
// [0, num_bins) (the padding id) get rank 0 and are not counted.  Outputs
// are bit-identical to the reference's [T/block, bins] histograms and
// block-local ranks.
//
// Bound: memory.  partition_pack and hash_partition read 4 B a row and write
// 4 B; hash_partition_pack reads 8 B (key, valid) and writes 8 B (dest,
// rank); the histograms add 4 * bins bytes a block.  At S=8 x T=750,080
// that is 48 MB (96 MB), 0.0144 ms (0.0289) at 3.35 TB/s.  The first port
// gave a thread one row and a 256-thread block one row-block: 23,440 blocks
// of one 4-byte load a thread, three __syncthreads and a serial scan (one
// thread a bin, over the 8 warps) each, at 45 % of the bound; its rank cost
// grew with the bins.
//
// This design:
//  - A warp owns a whole row-block, so a block's ranks and histogram need no
//    __syncthreads and no scan across warps.  At most 4 blocks of 8 warps
//    an SM; warp w of W takes row-blocks w, w + W, ... (a block index runs
//    over every shard at once, as T % block == 0), so the warps sweep one
//    window of memory together, and it loads its next row-block before it
//    ranks the current one.
//  - Packed path (up to 16 bins, block % 4 == 0, 16-byte aligned tensors:
//    every call of the main path, at 3, 8 and 9 bins).  A row-block is up
//    to two rounds of 128 rows; lane l holds rows 128 r + 4 l .. + 3 of
//    round r, one 16-byte load, so a warp's load or store is 512 contiguous
//    bytes.  Arrival order is round, lane, then row.  A lane counts its
//    rows' bins in 8-bit fields, four bins a 32-bit word; a row's local
//    rank is its field before the increment.  An exclusive scan of the
//    words over the lanes (5 shuffles a word) gives the rows of earlier
//    lanes, lane 31's prefix plus its counts the round's histogram, and the
//    round-0 histogram carries into round 1.  No field carries: round 0
//    leaves at most 128, a prefix over 31 lanes adds at most 124.  The work
//    a row is a few integer ops, with no ballot and no shuffle a row.
//  - Match path (more bins, up to the 1,536 that 8 warps' counters fit in
//    48 KB of shared memory; blocks that are not a multiple of 4; unaligned
//    tensors).  Row 32 r + lane in round r: coalesced 4-byte loads and
//    stores, arrival order round by round.  __match_any_sync gives a row's
//    peers in its round; the group's lowest lane reads and bumps the warp's
//    shared counter for the bin and shuffles the old value to its peers (no
//    atomics).  The counters are zeroed once a warp, then as each histogram
//    is written out.
//  - h % P is the high word of (magic * h mod 2^64) * P with magic =
//    2^64 / P rounded up, exact for every 32-bit h and P (Lemire, Kaser and
//    Kurz, "Faster remainder by direct computation", 2019): two multiplies
//    where a division by a runtime divisor costs a dozen instructions.
//
// What is left (PERF.md): at 3 and 8 bins the packed path takes ~0.001 ms
// more than Tensor.copy_ of the same bytes; at 9-16 bins (3-4 words, each
// scanned once a round) up to 0.007 ms more; hash_partition_pack sits at
// ~74 % of its bound, the rounds' scans and its 8-byte rows at 64 registers.
//
// Every entry point returns cudaGetLastError() after the launch; it launches
// on the given stream, allocates nothing and does not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;  // 64 registers a thread, at most 48 KB of shared memory
constexpr int kRows = 8;         // packed path: rows a lane holds, 4 in each of 2 rounds
constexpr int kRounds = 8;       // match path: a row-block of at most 256 rows, 32 a round
constexpr int kMaxWords = 4;     // packed path: 8-bit counts, 4 bins a word, up to 16 bins
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kPack, kHashPack, kHash };

__device__ __forceinline__ uint32_t fibonacci_hash(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// A row's destination.  h % P as the high word of (magic * h mod 2^64) * P,
// magic = 2^64 / P rounded up (exact for every 32-bit h and P: Lemire, Kaser
// and Kurz, "Faster remainder by direct computation", 2019).
template <int kMode>
__device__ __forceinline__ int destination(int32_t x, int32_t v, uint32_t num_partitions,
                                           uint64_t magic) {
  if (kMode == kPack) return x;
  const uint32_t h = fibonacci_hash(static_cast<uint32_t>(x));
  const int pid = static_cast<int>(__umul64hi(magic * h, num_partitions));
  return kMode == kHashPack && v == 0 ? static_cast<int>(num_partitions) : pid;
}

// Warp w of W takes row-blocks w, w + W, w + 2 W, ...: at any moment the
// warps work on one window of consecutive row-blocks.
__device__ __forceinline__ int64_t warp_index() {
  return static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
}
__device__ __forceinline__ int64_t warp_count() {
  return static_cast<int64_t>(gridDim.x) * kWarps;
}

__device__ __forceinline__ uint32_t pick(const uint32_t* words, int n, int w) {
  uint32_t word = words[0];
#pragma unroll
  for (int k = 1; k < kMaxWords; ++k)
    if (k < n && w == k) word = words[k];
  return word;
}

// ---- packed path: up to 16 bins, block % 4 == 0, 16-byte aligned tensors.
// A row-block is up to two rounds of 128 rows; lane l holds rows 128 r + 4 l
// .. 128 r + 4 l + 3 of round r, one 16-byte load (a warp's load is 512
// contiguous bytes).  Rows past the block's end are not touched.
template <int kMode>
__device__ __forceinline__ void load_lane(const int32_t* __restrict__ src,
                                          const int32_t* __restrict__ valid, int64_t base,
                                          int block, int lane, int32_t (&x)[kRows],
                                          int32_t (&v)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows / 4; ++r) {
    const int row = 128 * r + 4 * lane;
    if (row < block) {
      const int4 a = *reinterpret_cast<const int4*>(src + base + row);
      x[4 * r] = a.x, x[4 * r + 1] = a.y, x[4 * r + 2] = a.z, x[4 * r + 3] = a.w;
      if (kMode == kHashPack) {
        const int4 b = *reinterpret_cast<const int4*>(valid + base + row);
        v[4 * r] = b.x, v[4 * r + 1] = b.y, v[4 * r + 2] = b.z, v[4 * r + 3] = b.w;
      }
    }
  }
}

__device__ __forceinline__ void store_round(int32_t* __restrict__ out, int64_t at, bool in_block,
                                            const int (&y)[4]) {
  if (in_block) *reinterpret_cast<int4*>(out + at) = make_int4(y[0], y[1], y[2], y[3]);
}

__device__ __forceinline__ uint32_t field(uint32_t word, int bin) {
  return (word >> ((bin & 3) * 8)) & 0xffu;
}

// Arrival order is round order, then lane order, then row order within the
// lane.  In a round each lane counts its rows' bins into 8-bit fields, 4
// bins a 32-bit word (a row's local rank is its field before the
// increment); an exclusive scan over the lanes (5 shuffles a word) gives the
// rows of earlier lanes, and `carry` the rows of round 0; rank = the three.
// A field never carries: round 0 leaves at most 128 in one, a prefix over
// 31 lanes adds at most 124, a rank is at most 255.  Lane b < bins adds up
// bin b's rows round by round and writes the histogram.
template <int kMode, int kW>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
packed_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ valid,
              int32_t* __restrict__ dest_out, int32_t* __restrict__ hist,
              int32_t* __restrict__ rank_out, int64_t num_blocks, int block, int num_bins,
              uint32_t num_partitions, uint64_t magic) {
  const int64_t stride = warp_count();
  int64_t g = warp_index();
  if (g >= num_blocks) return;
  const int lane = threadIdx.x & 31;

  int32_t x[kRows] = {}, v[kRows] = {}, xn[kRows] = {}, vn[kRows] = {};
  load_lane<kMode>(src, valid, g * block, block, lane, x, v);
  for (; g < num_blocks; g += stride) {
    const int64_t base = g * block;
    if (g + stride < num_blocks) {
      load_lane<kMode>(src, valid, base + stride * block, block, lane, xn, vn);
    }
    uint32_t carry[kMaxWords] = {};  // round 0's rows, by bin
    int count = 0;                   // lane b < num_bins: bin b's rows
#pragma unroll
    for (int r = 0; r < kRows / 4; ++r) {
      const int row = 128 * r + 4 * lane;
      int d[4], local[4], rank[4];
      uint32_t counts[kMaxWords] = {};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        d[j] = destination<kMode>(x[4 * r + j], v[4 * r + j], num_partitions, magic);
        const bool counted = row + j < block && d[j] >= 0 && d[j] < num_bins;
        const int w = d[j] >> 2;
        local[j] = counted ? static_cast<int>(field(pick(counts, kW, w), d[j])) : -1;
#pragma unroll
        for (int k = 0; k < kW; ++k)
          if (counted && w == k) counts[k] += 1u << ((d[j] & 3) * 8);
      }
      uint32_t before[kMaxWords] = {};
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        uint32_t s = counts[k];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const uint32_t t = __shfl_up_sync(kFull, s, off);
          if (lane >= off) s += t;
        }
        before[k] = s - counts[k];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int w = d[j] >> 2;
        rank[j] = local[j] < 0
                      ? 0
                      : static_cast<int>(field(pick(carry, kW, w) + pick(before, kW, w), d[j])) +
                            local[j];
      }
      if (kMode != kHash) store_round(rank_out, base + row, row < block, rank);
      if (kMode != kPack) store_round(dest_out, base + row, row < block, d);
      uint32_t total[kMaxWords] = {};  // the round's rows, by bin: lane 31's prefix and counts
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        total[k] = __shfl_sync(kFull, before[k] + counts[k], 31);
        carry[k] += total[k];
      }
      count += static_cast<int>(field(pick(total, kW, lane >> 2), lane));
    }
    if (lane < num_bins) hist[g * num_bins + lane] = count;
#pragma unroll
    for (int j = 0; j < kRows; ++j) x[j] = xn[j], v[j] = vn[j];
  }
}

// ---- match path: any bins up to the shared-memory limit, any block.
// Row 32 r + lane in round r (coalesced 4-byte loads, all of a row-block's
// at once); arrival order is round order, then lane order.  __match_any_sync
// gives a row's peers in its round; the group's lowest lane reads and bumps
// the warp's shared counter for the bin and shuffles the old value to its
// peers.  The counters are zeroed once, then as each histogram is written.
template <int kMode>
__device__ __forceinline__ void load_rounds(const int32_t* __restrict__ src,
                                            const int32_t* __restrict__ valid, int64_t base,
                                            int block, int lane, int32_t (&x)[kRounds],
                                            int32_t (&v)[kRounds]) {
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = r * 32 + lane;
    if (i < block) {
      x[r] = src[base + i];
      if (kMode == kHashPack) v[r] = valid[base + i];
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
match_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ valid,
             int32_t* __restrict__ dest_out, int32_t* __restrict__ hist,
             int32_t* __restrict__ rank_out, int64_t num_blocks, int block, int num_bins,
             uint32_t num_partitions, uint64_t magic) {
  extern __shared__ int32_t counts_smem[];  // [kWarps][num_bins]
  const int64_t stride = warp_count();
  int64_t g = warp_index();
  if (g >= num_blocks) return;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  int32_t* counts = counts_smem + (threadIdx.x >> 5) * num_bins;
  for (int b = lane; b < num_bins; b += 32) counts[b] = 0;
  __syncwarp();

  int32_t x[kRounds] = {}, v[kRounds] = {}, xn[kRounds] = {}, vn[kRounds] = {};
  load_rounds<kMode>(src, valid, g * block, block, lane, x, v);
  for (; g < num_blocks; g += stride) {
    const int64_t base = g * block;
    if (g + stride < num_blocks) {
      load_rounds<kMode>(src, valid, base + stride * block, block, lane, xn, vn);
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int i = r * 32 + lane;
      const bool active = i < block;
      const int d = destination<kMode>(x[r], v[r], num_partitions, magic);
      if (kMode != kPack && active) dest_out[base + i] = d;
      const bool counted = active && d >= 0 && d < num_bins;
      const unsigned peers = __match_any_sync(kFull, counted ? d : -1);
      const int leader = __ffs(peers) - 1;
      int before = 0;
      if (counted && lane == leader) {
        before = counts[d];
        counts[d] = before + __popc(peers);
      }
      if (kMode != kHash) {
        before = __shfl_sync(kFull, before, leader);
        if (active) rank_out[base + i] = counted ? before + __popc(peers & lower) : 0;
      }
      __syncwarp();
    }
    int32_t* h = hist + g * num_bins;
    for (int b = lane; b < num_bins; b += 32) {
      h[b] = counts[b];
      counts[b] = 0;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRounds; ++r) x[r] = xn[r], v[r] = vn[r];
  }
}

int sm_count() {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) dev = 0;
  if (cached[dev] == 0) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev] > 0 ? cached[dev] : 1;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int kMode>
int launch(const void* src, const void* valid, void* dest, void* hist, void* rank, int S, int T,
           int block, int num_bins, int num_partitions, void* stream) {
  const int64_t num_blocks = static_cast<int64_t>(S) * (T / block);
  if (num_blocks > 0) {
    const int64_t grid_max = static_cast<int64_t>(sm_count()) * kBlocksPerSm;
    const int64_t need = (num_blocks + kWarps - 1) / kWarps;
    const int grid = static_cast<int>(need < grid_max ? need : grid_max);
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* s = static_cast<const int32_t*>(src);
    const auto* v = static_cast<const int32_t*>(valid);
    auto* d = static_cast<int32_t*>(dest);
    auto* h = static_cast<int32_t*>(hist);
    auto* r = static_cast<int32_t*>(rank);
    const auto np = static_cast<uint32_t>(num_partitions);
    const uint64_t magic = np ? ~0ull / np + 1 : 0;
    const bool packed = num_bins <= 4 * kMaxWords && block % 4 == 0 && aligned16(src) &&
                        aligned16(valid) && aligned16(dest) && aligned16(rank);
    const int words = num_bins > 4 ? (num_bins + 3) / 4 : 1;
#define PACKED(W)                                                                      \
  packed_kernel<kMode, W><<<grid, kThreads, 0, st>>>(s, v, d, h, r, num_blocks, block, \
                                                     num_bins, np, magic)
    if (packed && words == 1) PACKED(1);
    else if (packed && words == 2) PACKED(2);
    else if (packed && words == 3) PACKED(3);
    else if (packed) PACKED(4);
#undef PACKED
    else {
      const size_t smem = static_cast<size_t>(kWarps) * num_bins * sizeof(int32_t);
      match_kernel<kMode><<<grid, kThreads, smem, st>>>(s, v, d, h, r, num_blocks, block,
                                                        num_bins, np, magic);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// keys, valid, dest, rank: int32 [S, T]; hist: int32 [S, T / block, P + 1].
int hash_partition_pack_launch(const void* keys, const void* valid, void* dest, void* hist,
                               void* rank, int S, int T, int block, int num_partitions,
                               void* stream) {
  return launch<kHashPack>(keys, valid, dest, hist, rank, S, T, block, num_partitions + 1,
                           num_partitions, stream);
}

// dest, rank: int32 [S, T]; hist: int32 [S, T / block, num_bins].
int partition_pack_launch(const void* dest, void* hist, void* rank, int S, int T, int block,
                          int num_bins, void* stream) {
  return launch<kPack>(dest, nullptr, nullptr, hist, rank, S, T, block, num_bins, 0, stream);
}

// keys, pid: int32 [S, T]; hist: int32 [S, T / block, P].
int hash_partition_launch(const void* keys, void* pid, void* hist, int S, int T, int block,
                          int num_partitions, void* stream) {
  return launch<kHash>(keys, nullptr, pid, hist, nullptr, S, T, block, num_partitions,
                       num_partitions, stream);
}

}  // extern "C"
