// Capacity-bounded token -> expert slot assignment for Hopper (sm_90a), with a
// plain C interface, built with nvcc into a shared library and loaded with
// ctypes by ../moe_dispatch.py.
//
// Replaces (TPU kernel of the JAX reference package):
//   moe_dispatch  <- src/repro/kernels/moe_dispatch.py,
//                    moe_dispatch / _dispatch_kernel
//
// What it computes, for each shard s of dest [S, T] (expert ids, int32 or
// the router's int64, one per (token, choice) in arrival order): rank = the
// number of earlier rows of the shard with the same expert; slot = e * C +
// rank if rank < C, else the drop bin E * C; and counts[s, e] = min(rows of
// expert e, C).  Ids outside [0, E) match no expert: they land in the drop
// bin and are not counted.  The outputs are bit-identical to the
// reference's one-hot + cumsum.
//
// The TPU kernel carries a running per-expert histogram in VMEM across a
// sequential grid.  Here a shard is cut into tiles of one row a thread
// (1024 rows; a shard of at most 1024 rows is one tile of as many threads
// as it has rows, rounded up to a warp), and one launch runs a block per
// (tile, shard).  In a tile: __match_any_sync groups the lanes of a warp
// with the same expert, and a popcount of the lower peers gives the
// in-warp rank; the group's lowest lane writes the group size into the
// warp's row of a [warps][E] table; one thread per expert turns its column
// into an exclusive prefix over the warps and the tile's total.  No
// atomics, so ranks keep arrival order exactly.
//
// The rows of earlier tiles of the shard come from a decoupled look-back
// through global scratch: each tile publishes its per-expert total (flag
// AGG), then, once it knows the rows before it, its inclusive prefix (flag
// INCL); a tile reads its predecessors a window at a time (blockDim / E of
// them at once: one thread reads each flag, then E threads its values),
// nearest first, adding totals until it meets an inclusive prefix.  Tiles
// take their ids from an atomic ticket, so a tile waits only on tiles that
// have started, and blocks scheduled in any order cannot deadlock.  Each tile adds one to its
// shard's done count when it has finished reading; the last one clears the
// shard's flags, and the block that draws the last ticket clears the
// ticket, so the sync scratch (ticket, done counts, flags) is zero again
// for the next launch without a memset, whatever shape that launch has.
// The totals and prefixes live in a second scratch buffer that is never
// cleared: a value is read only after its flag is set.  Values are
// written, then __threadfence(), then the flag with st.release; readers
// poll with ld.acquire and read values through L2 (ld.cg).  A one-tile
// shard (decode) touches no scratch.
//
// Bound: memory, and in practice latency.  The kernel reads 8 B (int64; 4
// for int32) and writes 4 B a row plus 4 * E bytes of counts per shard: at
// the decode shape (S=8, T=64) that is 8 KB, at the prefill shape (S=8,
// T=16,384) 1.6 MB, under a microsecond at 3.35 TB/s either way.  The
// prefill shape runs 128 blocks where one block a shard ran 8; a decode
// call's time is the host's launch path, which the wrapper keeps short.
//
// Shared memory: a [warps][E] table, two [E] rows and the look-back window
// ((32 + 2 + window) E + window + 1 int32 at 1024 threads), above 48 KB
// (E > 332) opted into with cudaFuncSetAttribute, up to the 227 KB a block
// may have; E <= 1024 keeps a window of E values to a thread.
//
// The entry point returns the first CUDA error (the attribute call's, else
// cudaGetLastError() after the launch; cudaErrorInvalidValue for arguments
// it cannot take); it launches on the given stream, allocates nothing and
// does not synchronise.  Launches that may run at once (on two streams)
// need scratch of their own: the wrapper keeps one pair of buffers a stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 1024;  // rows (threads) of a tile of a multi-tile shard
constexpr int kAgg = 1;          // look-back flags: the tile's total is published
constexpr int kIncl = 2;         // the rows up to and including the tile are
constexpr int kSmemDefault = 48 * 1024;  // a block's shared memory without opting in
constexpr int kSmemLimit = 227 * 1024;   // the most a block may opt into
constexpr int kMaxExperts = kTileRows;   // a look-back window is at most a value a thread

__device__ __forceinline__ int load_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int32_t* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Scratch, int32.  sync: [0] ticket, [1, 1 + S) done counts, then flags
// [S][tiles]; vals: totals [S][tiles][E], then inclusive prefixes
// [S][tiles][E].  None when every shard is one tile.
inline int64_t sync_ints(int S, int tiles) {
  return tiles > 1 ? 1 + S + static_cast<int64_t>(S) * tiles : 0;
}

inline int64_t val_ints(int S, int tiles, int E) {
  return tiles > 1 ? 2 * static_cast<int64_t>(S) * tiles * E : 0;
}

template <typename Id>
__global__ void __launch_bounds__(kTileRows)
dispatch_kernel(const Id* __restrict__ dest, int32_t* __restrict__ slot,
                int32_t* __restrict__ counts, int32_t* __restrict__ sync,
                int32_t* __restrict__ vals, int S, int T, int tiles, int num_experts,
                int capacity) {
  extern __shared__ int32_t smem[];
  const int E = num_experts;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int window = max(1, nthreads / E);        // predecessors read at once
  int32_t* warp_counts = smem;                    // [nwarps][E]
  int32_t* base = warp_counts + nwarps * E;       // [E] rows of earlier tiles
  int32_t* total = base + E;                      // [E] rows of this tile
  int32_t* win_val = total + E;                   // [window][E]
  int32_t* win_state = win_val + window * E;      // [window]
  int32_t& ticket = win_state[window];            // this block's ticket
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  int shard = blockIdx.x;
  int tile = 0;
  if (tiles > 1) {
    if (tid == 0) {
      ticket = atomicAdd(sync, 1);
      if (ticket == S * tiles - 1) atomicExch(sync, 0);  // every ticket drawn
    }
    __syncthreads();
    shard = ticket / tiles;
    tile = ticket % tiles;
  }

  for (int i = tid; i < nwarps * E; i += nthreads) warp_counts[i] = 0;
  const int t = tile * nthreads + tid;
  const bool active = t < T;
  const Id d = active ? dest[static_cast<int64_t>(shard) * T + t] : Id(-1);
  const bool counted = active && d >= 0 && d < E;
  const int key = counted ? static_cast<int>(d) : -1;  // -1 is never an expert
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int warp_rank = __popc(peers & ((1u << lane) - 1u));
  __syncthreads();  // table zeroed
  if (counted && lane == __ffs(peers) - 1) warp_counts[warp * E + key] = __popc(peers);
  __syncthreads();

  // Per expert: exclusive prefix over the warps, the tile's total.
  for (int e = tid; e < E; e += nthreads) {
    int run = 0;
#pragma unroll 8
    for (int w = 0; w < nwarps; ++w) {
      const int c = warp_counts[w * E + e];
      warp_counts[w * E + e] = run;
      run += c;
    }
    total[e] = run;
    base[e] = 0;
  }

  if (tiles > 1) {
    int32_t* done = sync + 1;
    int32_t* flags = done + S + static_cast<int64_t>(shard) * tiles;
    int32_t* totals = vals + static_cast<int64_t>(shard) * tiles * E;
    int32_t* prefixes = totals + static_cast<int64_t>(S) * tiles * E;
    // Only later tiles read what a tile publishes: the last one publishes
    // nothing, and inclusive prefixes past tile 0 are read only when a
    // look-back can pass a whole window.
    const bool read_later = tile < tiles - 1;
    const bool read_incl = read_later && tile > 0 && tiles - 1 > window;
    if (read_later) {
      int32_t* published = tile == 0 ? prefixes : totals;  // tile 0's total is its prefix
      for (int e = tid; e < E; e += nthreads) {
        published[static_cast<int64_t>(tile) * E + e] = total[e];
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) store_release(flags + tile, tile == 0 ? kIncl : kAgg);
    }

    // Look back, nearest predecessor first, a window at a time.  One thread
    // a window entry reads its flag, so that every expert of the entry takes
    // the state that decides where the look-back stops.
    for (int hi = tile - 1; hi >= 0; hi -= window) {
      if (tid < window) {
        const int p = hi - tid;
        int state = kIncl;  // before the shard's first tile: nothing
        if (p >= 0) {
          do {
            state = load_acquire(flags + p);
          } while (state == 0);
        }
        win_state[tid] = state;
      }
      __syncthreads();
      int stop = window;  // the nearest entry holding an inclusive prefix
      for (int w = 0; w < window; ++w) {
        if (win_state[w] == kIncl) {
          stop = w;
          break;
        }
      }
      if (tid < window * E && tid / E <= stop) {
        const int w = tid / E;
        const int p = hi - w;
        win_val[tid] = p < 0 ? 0
                             : __ldcg((win_state[w] == kIncl ? prefixes : totals) +
                                      static_cast<int64_t>(p) * E + tid % E);
      }
      __syncthreads();
      for (int e = tid; e < E; e += nthreads) {
        int sum = 0;
        for (int w = 0; w < window && w <= stop; ++w) sum += win_val[w * E + e];
        base[e] += sum;
      }
      __syncthreads();
      if (stop < window) break;
    }

    if (read_incl) {
      for (int e = tid; e < E; e += nthreads) {
        prefixes[static_cast<int64_t>(tile) * E + e] = base[e] + total[e];
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) store_release(flags + tile, kIncl);
    }
    // Every read of this shard's flags by this tile is done: the last tile
    // of the shard to get here clears them for the next launch.
    if (tid == 0) {
      __threadfence();
      if (atomicAdd(done + shard, 1) == tiles - 1) {
        __threadfence();
        for (int p = 0; p < tiles; ++p) flags[p] = 0;
        done[shard] = 0;
      }
    }
  }
  __syncthreads();  // base and the table are final

  if (active) {
    const int rank = counted ? base[key] + warp_counts[warp * E + key] + warp_rank : 0;
    slot[static_cast<int64_t>(shard) * T + t] =
        counted && rank < capacity ? key * capacity + rank : E * capacity;
  }
  if (tile == tiles - 1) {
    for (int e = tid; e < E; e += nthreads) {
      counts[static_cast<int64_t>(shard) * E + e] = min(base[e] + total[e], capacity);
    }
  }
}

// Opt into the shared memory above 48 KB, then launch: the first CUDA error.
template <typename Id>
int launch(const Id* dest, int32_t* const out[4], unsigned blocks, int threads, size_t smem,
           cudaStream_t stream, int S, int T, int tiles, int num_experts, int capacity) {
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        dispatch_kernel<Id>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dispatch_kernel<Id><<<blocks, threads, smem, stream>>>(dest, out[0], out[1], out[2], out[3], S,
                                                         T, tiles, num_experts, capacity);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dest: [S, T] int32 (id_bytes 4) or int64 (id_bytes 8); slot: int32 [S, T];
// counts: int32 [S, E].
// A shard of more than 1024 rows needs sync (at least 1 + S + S * tiles
// int32, zero before the first launch; each launch leaves it zero) and vals
// (2 * S * tiles * E int32, any content), tiles = ceil(T / 1024).
int moe_dispatch_launch(const void* dest, int id_bytes, void* slot, void* counts, void* sync,
                        long long sync_len, void* vals, long long vals_len, int S, int T,
                        int num_experts, int capacity, void* stream) {
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = T > kTileRows ? kTileRows : (T > 32 ? (T + 31) / 32 * 32 : 32);
  const int tiles = T > kTileRows ? (T + kTileRows - 1) / kTileRows : 1;
  const int window = num_experts > 0 && threads / num_experts > 1 ? threads / num_experts : 1;
  const size_t smem =
      sizeof(int32_t) *
      ((static_cast<size_t>(threads / 32 + 2 + window)) * num_experts + window + 1);
  if (num_experts <= 0 || num_experts > kMaxExperts || capacity < 0 || T < 0 ||
      smem > kSmemLimit || (id_bytes != 4 && id_bytes != 8) || sync_len < sync_ints(S, tiles) ||
      vals_len < val_ints(S, tiles, num_experts) || static_cast<int64_t>(S) * tiles > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>(S) * tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* out[4] = {static_cast<int32_t*>(slot), static_cast<int32_t*>(counts),
                     static_cast<int32_t*>(sync), static_cast<int32_t*>(vals)};
  return id_bytes == 4
             ? launch(static_cast<const int32_t*>(dest), out, blocks, threads, smem, s, S, T,
                      tiles, num_experts, capacity)
             : launch(static_cast<const int64_t*>(dest), out, blocks, threads, smem, s, S, T,
                      tiles, num_experts, capacity);
}

}  // extern "C"
