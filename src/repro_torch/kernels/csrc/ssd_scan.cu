// The Mamba2 SSD chunk scan (state-space duality), for Hopper (sm_90a).  A
// plain C interface, built with nvcc into a shared library and loaded with
// ctypes by ../ssd_scan.py.
//
// Replaces (TPU kernel of the JAX reference package):
//   ssd_scan  <- src/repro/kernels/ssd_scan.py, ssd_scan / _ssd_kernel
//
// What it computes: x [B, L, H, P], dt [B, L, H] f32, A [H] f32, B and C
// [B, L, G, N], the entering state s0 [B, H, P, N] f32 (or none: zeros) ->
// y [B, L, H, P] in x's dtype and the final state [B, H, P, N] f32.  Head h
// reads group g = h / (H / G) of B and C.  The sequence is cut into chunks of
// Q rows; in chunk c, with a_cs the inclusive cumsum of dt * A over the chunk,
//   y_i = sum_{j <= i} (C_i . B_j) exp(a_cs_i - a_cs_j) dt_j x_j
//         + exp(a_cs_i) (C_i . S_c)
//   S_{c+1} = exp(a_cs_last) S_c + sum_j exp(a_cs_last - a_cs_j) dt_j x_j B_j^T
// with every product and sum in f32 (FMA on the CUDA cores; no tensor cores,
// whose bf16 or TF32 inputs would break the f32 parity the reference sets),
// the decay taken as the exponential of a difference of cumsums, as the plain
// version takes it (a product of exponentials would underflow), and y rounded
// to its type once, at the store.
//
// The TPU kernel walks (b, 8-head block, chunk) with the chunk axis
// sequential, the [hb, P, N] state in VMEM scratch and the scores C_i . B_j
// computed once per 8-head block.  A sequential chunk axis leaves most of the
// card idle at batch 1 (a grid of H blocks), so here the scan is cut where
// the recurrence is linear: ssd_scan_launch enqueues three kernels on one
// stream.
//   1. ssd_chunk_state_kernel, grid (chunk, G * pairs + H, b).  A head block
//      loads dt, sums dt * A into a_cs in row order (one thread: the plain
//      version's order; at |a_cs| ~ 100 one f32 rounding of a cumsum moves
//      exp(a_cs_i - a_cs_j) by ~1e-5 relative, more than the rest of the
//      arithmetic does), writes a_cs to the scratch `acs` [B, H, L], and
//      sums the chunk's own contribution sum_j w_j x_j B_j^T, w_j = exp(a_last
//      - a_cs_j) dt_j, into the scratch `states` [B, nc, H, N, P] (each
//      warp a 32 x 32 tile of the state, each lane 4 x 8).  A score block
//      computes one 64 x 64 tile (i, j <= i) of C_i . B_j for a group, once
//      for all its heads, into the scratch `scores` [B, nc, G, Q, Q], stored
//      [j][i].
//   2. ssd_state_pass_kernel, grid (P N / 1024, H, b): one thread per four
//      state elements walks the chunks in order, S = exp(a_last_c) S + local_c (the
//      plain version's update), overwriting each chunk's slot with the state
//      that enters it, and writes the final state; it loads eight chunks
//      ahead of its stores.
//   3. ssd_chunk_out_kernel, grid (64-row tile x chunk, G x head block, b):
//      a block keeps C_i^T in shared memory and, for each of up to 8 heads of
//      one group, reads the entering state (the inter term), then for each
//      column tile j <= i weighs the shared scores by exp(a_cs_i - a_cs_j)
//      dt_j and multiplies by x_j.
// The scratch layouts are chosen so that every per-head product is an outer
// product over operands stored k-major in shared memory: per k a
// lane reads one float4 of each (a warp's lanes share addresses, so each
// read is one shared-memory wavefront) for 16 or 32 FMAs.  Loads are plain
// global loads converted to f32 on the way to shared memory (cp.async
// cannot convert bf16); the copies of one resident block overlap the
// arithmetic of another (two stage-3 blocks an SM, three of stage 1).
//
// Limits (the wrapper checks them; anything else returns
// cudaErrorInvalidValue): P in {8, 16, 32, 64}, N in {16, 32, 64, 128},
// 1 <= Q <= 256 with L % Q == 0, G dividing H, B <= 65535.  Scratch (f32,
// allocated by the wrapper): states B nc H N P (134 MB at Mamba2-1.3B's B=8,
// L=2048, H=64, P=64, N=128), scores B nc G Q^2 (17 MB) and acs B H L.
//
// Bound: operations.  The least work counts the scores once per (b, g,
// chunk), Q^2 N flops, and per (b, h, chunk) Q^2 P for the intra term, 2 Q N P
// for the state read and 2 Q P N for the update: about 52 GFLOP at Mamba2-1.3B's
// prefill (0.78 ms at 67 TFLOP/s in f32) against 0.30 GB of inputs and
// outputs (0.09 ms at 3.35 TB/s).  The kernels do that work and no more, up
// to the full 64 x 64 diagonal tiles.
//
// The entry point returns the first CUDA error (an attribute call's, else
// cudaGetLastError() after each launch); it launches on the given stream,
// allocates nothing and does not synchronise.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;       // rows of a row tile and of a column tile
constexpr int kThreads = 256;
constexpr int kMaxChunk = 256;  // dt is loaded with one thread a row
constexpr int kHeadBlock = 8;   // heads of one group a stage-3 block serves
constexpr int kLdT = kTile + 4; // row stride of the [*, 64] tiles

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Row stride of the [*, N] tiles: a multiple of 4 (float4 loads) that is not
// a multiple of 32, so 8 lanes reading 8 rows 16 apart hit 8 bank groups.
__host__ __device__ constexpr int ld_n(int N) { return N + 4; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc += a . b over four consecutive k.
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc[r][q] += a_r b_q: one k of an outer-product tile.
__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 a, float4 b) {
  const float ar[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    acc[r][0] = fmaf(ar[r], b.x, acc[r][0]);
    acc[r][1] = fmaf(ar[r], b.y, acc[r][1]);
    acc[r][2] = fmaf(ar[r], b.z, acc[r][2]);
    acc[r][3] = fmaf(ar[r], b.w, acc[r][3]);
  }
}

// The first nr rows of a [*, N] operand (row stride `stride` elements) into
// a [64][ld_n(N)] f32 tile, zero past nr.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int64_t stride, int nr,
                                          int N) {
  const int LDN = ld_n(N);
  for (int e = threadIdx.x; e < kTile * N; e += kThreads) {
    const int r = e / N;
    const int n = e % N;
    dst[r * LDN + n] = r < nr ? to_f32(src[r * stride + n]) : 0.f;
  }
}

// s[r][c] = A_(ty + 16 r) . B_(tx + 16 c) over K (a multiple of 4), rows of
// both tiles LD floats apart; rows of B at or past nb read as zero.
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* As, const float* Bs,
                                         int LD, int K, int nb) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
  }
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 av[4];
    float4 bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = ld4(As + (ty + 16 * r) * LD + k);
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = tx + 16 * c < nb ? ld4(Bs + (tx + 16 * c) * LD + k) : zero4;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dot4(av[r], bv[c], s[r][c]);
    }
  }
}

size_t smem_state(int P, int N) {
  const size_t tile = static_cast<size_t>(kTile) * ld_n(N);
  return sizeof(float) * (tile + (tile > static_cast<size_t>(kTile) * P
                                      ? tile : static_cast<size_t>(kTile) * P) +
                          3 * kMaxChunk);
}

size_t smem_out(int P, int N) {
  const size_t u = static_cast<size_t>(N > kTile ? N : kTile) * (P + 4);
  return sizeof(float) * (static_cast<size_t>(N) * kLdT + u +
                          static_cast<size_t>(kTile) * kLdT + 2 * kMaxChunk);
}

// Stage 1: the chunk's local states (head blocks) and the shared scores
// (score blocks, one 64 x 64 tile each, first in the grid).
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const T* __restrict__ Bm,
                       const T* __restrict__ Cm, float* __restrict__ states,
                       float* __restrict__ scores, float* __restrict__ acs_out, int L,
                       int H, int G, int N, int Q, int npairs) {
  const int LDN = ld_n(N);
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);  // [kTile][LDN] B rows j
  float* Ws = Bs + kTile * LDN;       // score blocks: C rows i; head blocks: x_j w_j [kTile][P]
  const int tile = kTile * LDN;
  float* dts = Ws + (tile > kTile * P ? tile : kTile * P);  // [kMaxChunk]
  float* acs = dts + kMaxChunk;       // [kMaxChunk] inclusive cumsum of dt * A
  float* ws = acs + kMaxChunk;        // [kMaxChunk] exp(a_last - a_cs_j) dt_j

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int c = blockIdx.x;
  const int b = blockIdx.z;
  const int nc = gridDim.x;
  const int64_t l0 = static_cast<int64_t>(b) * L + static_cast<int64_t>(c) * Q;  // row of (b, c, 0)
  const int64_t brow = static_cast<int64_t>(G) * N;

  if (static_cast<int>(blockIdx.y) < G * npairs) {
    // one 64 x 64 tile (it, jt <= it) of the group's scores C_i . B_j
    const int g = blockIdx.y / npairs;
    int jt = blockIdx.y % npairs;
    int it = 0;
    while (jt > it) jt -= ++it;
    const int i0 = it * kTile;
    const int j0 = jt * kTile;
    const int ni = min(kTile, Q - i0);
    const int nj = min(kTile, Q - j0);
    load_rows(Ws, Cm + (l0 + i0) * brow + static_cast<int64_t>(g) * N, brow, ni, N);
    load_rows(Bs, Bm + (l0 + j0) * brow + static_cast<int64_t>(g) * N, brow, nj, N);
    __syncthreads();
    // s[r][q] = B_j . C_i for j = ty + 16 r, i = tx + 16 q: stored transposed,
    // [j][i], the layout stage 3 reads along i
    float s[4][4];
    tile_dot(s, Bs, Ws, LDN, N, ni);
    float* out = scores + ((static_cast<int64_t>(b) * nc + c) * G + g) * Q * Q;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 16 * r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = tx + 16 * q;
        if (i < ni && j < nj) out[static_cast<int64_t>(j0 + j) * Q + i0 + i] = s[r][q];
      }
    }
    return;
  }

  const int h = blockIdx.y - G * npairs;
  const int g = h / (H / G);
  if (tid < Q) {
    const float d = dt[(l0 + tid) * H + h];
    dts[tid] = d;
    acs[tid] = d * A[h];
  }
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int i = 0; i < Q; ++i) {
      run += acs[i];
      acs[i] = run;
    }
  }
  __syncthreads();
  const float a_last = acs[Q - 1];
  if (tid < Q) {
    acs_out[(static_cast<int64_t>(b) * H + h) * L + static_cast<int64_t>(c) * Q + tid] = acs[tid];
    ws[tid] = expf(a_last - acs[tid]) * dts[tid];
  }

  // Each warp owns a 32 x 32 tile of the [P, N] state: lane (lane / 4, lane
  // % 4) owns p0..p0+3 and n0..n0+3, n0+16..n0+19.  Per row j it reads one
  // float4 of x_j w_j (8 addresses a warp) and two of B_j (4 each): three
  // shared-memory wavefronts for 32 FMAs a lane.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int p0 = (warp & 1) * 32 + 4 * (lane >> 2);
  const int n0 = (warp >> 1) * 32 + 4 * (lane & 3);
  const bool p_ok = p0 < P;
  float acc[4][2][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][q][e] = 0.f;
    }
  }
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t xrow = static_cast<int64_t>(H) * P;
  for (int j0 = 0; j0 < Q; j0 += kTile) {
    const int nj = min(kTile, Q - j0);
    __syncthreads();  // ws stored (first tile); the last tile's readers done
    load_rows(Bs, Bm + (l0 + j0) * brow + static_cast<int64_t>(g) * N, brow, nj, N);
    const T* xs = x + (l0 + j0) * xrow + static_cast<int64_t>(h) * P;
    for (int e = tid; e < nj * P; e += kThreads) {
      const int r = e / P;
      Ws[e] = to_f32(xs[r * xrow + e % P]) * ws[j0 + r];
    }
    __syncthreads();
    // U_pn += sum_j (w_j x_jp) B_jn
    if (p_ok) {
#pragma unroll 4
      for (int j = 0; j < nj; ++j) {
        const float4 xv = ld4(Ws + j * P + p0);
        float4 bv[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = n0 + 16 * q;
          bv[q] = n < N ? ld4(Bs + j * LDN + n) : zero4;
        }
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            acc[r][q][0] = fmaf(xr[r], bv[q].x, acc[r][q][0]);
            acc[r][q][1] = fmaf(xr[r], bv[q].y, acc[r][q][1]);
            acc[r][q][2] = fmaf(xr[r], bv[q].z, acc[r][q][2]);
            acc[r][q][3] = fmaf(xr[r], bv[q].w, acc[r][q][3]);
          }
        }
      }
    }
  }
  // the chunk's state, transposed: [N][P], the layout stage 3 reads along p
  float* st = states + ((static_cast<int64_t>(b) * nc + c) * H + h) * P * N;
  if (!p_ok) return;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + 16 * q + e;
      if (n < N) {
        *reinterpret_cast<float4*>(st + n * P + p0) =
            make_float4(acc[0][q][e], acc[1][q][e], acc[2][q][e], acc[3][q][e]);
      }
    }
  }
}

// Stage 2: the states entering each chunk, in chunk order.  The chunk
// states are [N][P] (stage 1's layout), s0 and fin [P][N].  Each thread loads
// eight chunks' states and decays before it stores any, so eight loads are in
// flight at once instead of one a chunk.
constexpr int kPassBatch = 8;

__global__ void __launch_bounds__(kThreads)
ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ acs,
                      const float* __restrict__ s0, float* __restrict__ fin, int L, int H,
                      int P, int N, int Q, int nc) {
  const int PN = P * N;
  const int e = 4 * (blockIdx.x * kThreads + threadIdx.x);  // n * P + p, p % 4 == 0
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (e >= PN) return;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const int64_t pn = static_cast<int64_t>(e % P) * N + e / P;  // in s0 and fin
  float S[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) S[q] = s0 != nullptr ? s0[bh * PN + pn + q * N] : 0.f;
  const float* a_last = acs + bh * L + Q - 1;
  float* st = states + (static_cast<int64_t>(b) * nc * H + h) * PN + e;
  const int64_t chunk_stride = static_cast<int64_t>(H) * PN;
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float4 local[kPassBatch];
    float decay[kPassBatch];
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      if (c0 + k < nc) {
        local[k] = ld4(st + (c0 + k) * chunk_stride);
        decay[k] = a_last[static_cast<int64_t>(c0 + k) * Q];
      }
    }
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      if (c0 + k < nc) {
        *reinterpret_cast<float4*>(st + (c0 + k) * chunk_stride) =
            make_float4(S[0], S[1], S[2], S[3]);
        const float d = expf(decay[k]);
        S[0] = fmaf(S[0], d, local[k].x);
        S[1] = fmaf(S[1], d, local[k].y);
        S[2] = fmaf(S[2], d, local[k].z);
        S[3] = fmaf(S[3], d, local[k].w);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) fin[bh * PN + pn + q * N] = S[q];
}

// Stage 3: y for one 64-row tile of one chunk and up to kHeadBlock heads of
// one group.  Both products are outer products over k-major operands: the
// inter term over n with C_i^T [N][64] and the state [N][P], the intra term
// over j with the weighted scores M^T [64][64] and x_j [64][P].  Thread (ig,
// pg) owns rows 4 ig..4 ig+3 and head dims 4 pg..4 pg+3; a warp spans 4 ig by
// 8 pg, so per k it reads one float4 of each operand (4 and 8 addresses: one
// wavefront each) for 16 FMAs a lane.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const T* __restrict__ Cm, const float* __restrict__ states,
                     const float* __restrict__ scores, const float* __restrict__ acs,
                     T* __restrict__ y, int L, int H, int G, int N, int Q, int ntiles,
                     int nhb) {
  constexpr int kLdP = P + 4;         // row stride of the [*, P] tiles
  extern __shared__ float4 smem4[];
  float* CsT = reinterpret_cast<float*>(smem4);  // [N][kLdT] C rows i, transposed
  float* U = CsT + N * kLdT;          // the entering state [N][kLdP], then x_j [64][kLdP]
  float* MsT = U + (N > kTile ? N : kTile) * kLdP;  // [64 j][kLdT] weighted scores
  float* acs_s = MsT + kTile * kLdT;  // [kMaxChunk]
  float* dts = acs_s + kMaxChunk;     // [kMaxChunk]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ig = (warp & 3) * 4 + (lane & 3);
  const int pg = (warp >> 2) * 8 + (lane >> 2);
  const bool p_ok = 4 * pg < P;
  const int it = blockIdx.x % ntiles;
  const int c = blockIdx.x / ntiles;
  const int nc = L / Q;
  const int g = blockIdx.y / nhb;
  const int R = H / G;
  const int h_first = g * R + (blockIdx.y % nhb) * kHeadBlock;
  const int nh = min(kHeadBlock, g * R + R - h_first);
  const int b = blockIdx.z;
  const int i0 = it * kTile;
  const int ni = min(kTile, Q - i0);
  const int64_t l0 = static_cast<int64_t>(b) * L + static_cast<int64_t>(c) * Q;
  const int64_t brow = static_cast<int64_t>(G) * N;
  const int64_t xrow = static_cast<int64_t>(H) * P;
  const float* scT = scores + ((static_cast<int64_t>(b) * nc + c) * G + g) * Q * Q;

  const T* cs = Cm + (l0 + i0) * brow + static_cast<int64_t>(g) * N;
  for (int e = tid; e < kTile * N; e += kThreads) {
    const int i = e / N;
    const int n = e % N;
    CsT[n * kLdT + i] = i < ni ? to_f32(cs[i * brow + n]) : 0.f;
  }

  // A column tile of head h in registers: its x rows (zero past the chunk)
  // and its raw scores (element e: i = e % 64, j = e / 64).
  constexpr int kXPer = kTile * P / kThreads;
  constexpr int kMPer = kTile * kTile / kThreads;
  float xr[kXPer];
  float sr[kMPer];
  auto fetch = [&](int h, int jt) {
    const int j0 = jt * kTile;
    const int nj = min(kTile, Q - j0);
    const T* xs = x + (l0 + j0) * xrow + static_cast<int64_t>(h) * P;
#pragma unroll
    for (int k = 0; k < kXPer; ++k) {
      const int e = tid + k * kThreads;
      const int r = e / P;
      xr[k] = r < nj ? to_f32(xs[r * xrow + e % P]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kMPer; ++k) {
      const int e = tid + k * kThreads;
      const int i = e & (kTile - 1);
      const int j = e / kTile;
      sr[k] = i < ni && j < nj ? scT[static_cast<int64_t>(j0 + j) * Q + i0 + i] : 0.f;
    }
  };

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h_first + hh;
    __syncthreads();  // CsT stored (first head); the last head's readers done
    for (int r = tid; r < i0 + ni; r += kThreads) {
      acs_s[r] = acs[(static_cast<int64_t>(b) * H + h) * L + static_cast<int64_t>(c) * Q + r];
      dts[r] = dt[(l0 + r) * H + h];
    }
    const float* st = states + ((static_cast<int64_t>(b) * nc + c) * H + h) * P * N;
    for (int e = 4 * tid; e < P * N; e += 4 * kThreads) {
      *reinterpret_cast<float4*>(U + (e / P) * kLdP + e % P) = ld4(st + e);
    }
    fetch(h, 0);  // in flight during the state read
    __syncthreads();

    // the read of the entering state: exp(a_cs_i) (C_i . S_p)
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    }
    if (p_ok) {
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 a = ld4(CsT + n * kLdT + 4 * ig);
        const float4 v = ld4(U + n * kLdP + 4 * pg);
        outer4(acc, a, v);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * ig + r;
      const float e = i < ni ? expf(acs_s[i0 + i]) : 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] *= e;
    }

    // the intra-chunk quadratic over the column tiles j <= i; tile jt + 1's x
    // and scores are in flight (in registers) while tile jt is multiplied
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kTile;
      const int nj = min(kTile, Q - j0);
      __syncthreads();  // U's and MsT's last readers are done
#pragma unroll
      for (int k = 0; k < kMPer; ++k) {
        const int e = tid + k * kThreads;
        const int i = e & (kTile - 1);
        const int j = e / kTile;
        MsT[j * kLdT + i] = i < ni && j < nj && j0 + j <= i0 + i
            ? sr[k] * expf(acs_s[i0 + i] - acs_s[j0 + j]) * dts[j0 + j] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kXPer; ++k) {
        const int e = tid + k * kThreads;
        U[(e / P) * kLdP + e % P] = xr[k];
      }
      __syncthreads();
      if (jt < it) fetch(h, jt + 1);
      // y_i += sum_j M_ij x_j
      if (p_ok) {
#pragma unroll 4
        for (int j = 0; j < nj; ++j) {
          const float4 a = ld4(MsT + j * kLdT + 4 * ig);
          const float4 v = ld4(U + j * kLdP + 4 * pg);
          outer4(acc, a, v);
        }
      }
    }

    if (!p_ok) continue;
    T* yh = y + (l0 + i0) * xrow + static_cast<int64_t>(h) * P + 4 * pg;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * ig + r;
      if (i >= ni) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) yh[i * xrow + q] = from_f32<T>(acc[r][q]);
    }
  }
}

template <typename T, int P>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* s0, void* y, float* fin, float* states,
           float* scores, float* acs, int B, int L, int H, int G, int N, int Q,
           cudaStream_t stream) {
  const int nc = L / Q;
  const int ntiles = (Q + kTile - 1) / kTile;
  const int npairs = ntiles * (ntiles + 1) / 2;
  const int R = H / G;
  const int nhb = (R + kHeadBlock - 1) / kHeadBlock;
  if (nc > 0) {
    const size_t smem1 = smem_state(P, N);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_state_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem1));
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_chunk_state_kernel<T, P><<<dim3(nc, G * npairs + H, B), kThreads, smem1, stream>>>(
        static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), states, scores, acs, L, H, G, N, Q, npairs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_state_pass_kernel<<<dim3((P * N / 4 + kThreads - 1) / kThreads, H, B), kThreads, 0,
                          stream>>>(
      states, acs, s0, fin, L, H, P, N, Q, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nc == 0) return static_cast<int>(err);
  const size_t smem3 = smem_out(P, N);
  err = cudaFuncSetAttribute(ssd_chunk_out_kernel<T, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem3));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_out_kernel<T, P><<<dim3(ntiles * nc, G * nhb, B), kThreads, smem3, stream>>>(
      static_cast<const T*>(x), dt, static_cast<const T*>(Cm), states, scores, acs,
      static_cast<T*>(y), L, H, G, N, Q, ntiles, nhb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, const float* s0, void* y, float* fin, float* states,
             float* scores, float* acs, int B, int L, int H, int P, int G, int N, int Q,
             cudaStream_t s) {
#define SSD_CASE(PD) \
  case PD:           \
    return launch<T, PD>(x, dt, A, Bm, Cm, s0, y, fin, states, scores, acs, B, L, H, G, N, Q, s);
  switch (P) {
    SSD_CASE(8)
    SSD_CASE(16)
    SSD_CASE(32)
    SSD_CASE(64)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SSD_CASE
}

}  // namespace

extern "C" {

// x, y: [B, L, H, P]; dt: [B, L, H] f32; A: [H] f32; Bm, Cm: [B, L, G, N];
// s0 (may be null: a zero state) and fin: [B, H, P, N] f32; all contiguous.
// x, Bm, Cm and y share one dtype: 0 = float32, 1 = bfloat16.  Scratch, f32:
// states [B, L / chunk, H, N, P], scores [B, L / chunk, G, chunk, chunk],
// acs [B, H, L].  Needs P in {8, 16, 32, 64}, N in {16, 32, 64, 128},
// 1 <= chunk <= 256, L % chunk == 0, H % G == 0 and B <= 65535; anything
// else returns cudaErrorInvalidValue without launching.
int ssd_scan_launch(const void* x, const float* dt, const float* A,
                    const void* Bm, const void* Cm, const float* s0, void* y,
                    float* fin, float* states, float* scores, float* acs, int dtype,
                    int B, int L, int H, int P, int G, int N, int chunk, void* stream) {
  const bool n_ok = N == 16 || N == 32 || N == 64 || N == 128;
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || L < 0 || !n_ok ||
      chunk < 1 || chunk > kMaxChunk || L % chunk != 0 || B > 65535 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_p<float>(x, dt, A, Bm, Cm, s0, y, fin, states, scores, acs, B, L, H, P, G,
                           N, chunk, s);
  }
  return launch_p<__nv_bfloat16>(x, dt, A, Bm, Cm, s0, y, fin, states, scores, acs, B, L, H,
                                 P, G, N, chunk, s);
}

}  // extern "C"
