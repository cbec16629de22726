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
// Q rows; in each chunk, with a_cs the inclusive cumsum of dt * A,
//   y_i = sum_{j <= i} (C_i . B_j) exp(a_cs_i - a_cs_j) dt_j x_j
//         + exp(a_cs_i) (C_i . S)
//   S  <- exp(a_cs_last) S + sum_j exp(a_cs_last - a_cs_j) dt_j x_j B_j^T
// with every product and sum in f32 (FMA on the CUDA cores; no tensor cores),
// the decay taken as the exponential of a difference of cumsums, as the plain
// version takes it (a product of exponentials would underflow), and y rounded
// to its type once, at the store.
//
// The TPU kernel walks (b, 8-head block, chunk) with the chunk axis
// sequential, the [hb, P, N] state in VMEM scratch and a [Q, Q, hb] decay
// tile (2 MB at Q = 256) in VMEM.  Here one block of 256 threads owns one
// (b, h) and loops over the chunks in order: the loop takes the place of the
// sequential grid axis, and the f32 [P, N] state stays in shared memory
// across chunks.  Per chunk the block
//   1. loads dt, sums dt * A into a_cs in row order (one thread, the plain
//      version's order: at |a_cs| ~ 100 one f32 rounding of a cumsum moves
//      exp(a_cs_i - a_cs_j) by ~1e-5 relative, more than the rest of the
//      arithmetic does) and keeps a_cs and the update weights
//      exp(a_last - a_cs_j) dt_j;
//   2. for each 64-row tile of rows i: loads C_i, reads the entering state
//      (the inter term), then walks the 64-row tiles j <= i, building the
//      C_i . B_j^T scores on the fly, applying the decay and dt_j, and
//      accumulating (.) x_j into y in registers.  Tiles above the diagonal
//      are never loaded; on the diagonal tile j > i is skipped and j = i
//      kept.  Rows past the chunk's end (Q not a multiple of 64) are masked;
//   3. updates the state from the B_j and x_j tiles of the last row tile's
//      walk, which covers every j, after a __syncthreads() that follows every
//      row's read of the old state.
// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 r (r < 4) of a
// tile, score columns tx + 16 c (c < 4) and head dims tx + 16 c (c < P/16);
// in the update, state rows p = ty + 16 r and columns n = tx + 16 c.  Every
// product reads its operands along the contraction as float4 from shared
// memory: C, B and the state keep rows of N (padded to N + 4 floats, so the
// 8 lanes of a float4 phase, reading rows 16 apart, hit 8 bank groups), x is
// stored transposed [P][64 + 4] and the weighted scores [64][64 + 4].  Each
// thread keeps 16 (scores) or 4 P/16 (y) or P N / 256 (update) sums in
// registers: about one 16-byte load per 8 FMAs in the products, one 4-byte
// load per 4 FMAs in the update.
//
// Limits (the wrapper checks them; anything else returns
// cudaErrorInvalidValue): P in {8, 16, 32, 64}, N in {16, 32, 64, 128},
// 1 <= Q <= 256 with L % Q == 0, G dividing H, B <= 65535.  Shared memory:
// ((P + 128) (N + 4) + (P + 64) 68 + 3 * 256) floats, 139 KB at P = 64,
// N = 128 and 90 KB at N = 64: the launch opts in with cudaFuncSetAttribute
// and returns its error if that fails.
//
// Bound: operations.  The least work counts the scores once per (b, g,
// chunk), Q^2 N flops, and per (b, h, chunk) Q^2 P for the intra term, 2 Q N P
// for the state read and 2 Q P N for the update: about 52 GFLOP at Mamba2-1.3B's
// prefill (B=8, L=2048, H=64, P=64, N=128, Q=256; 0.78 ms at 67 TFLOP/s in
// f32) against 0.30 GB of inputs and outputs (0.09 ms at 3.35 TB/s).  This
// first version recomputes the scores for every head of a group, does the
// full 64 x 64 diagonal tiles, loads each tile only after the last one is
// used (no copy overlaps the arithmetic) and runs one or two 256-thread
// blocks per SM, so it sits well below the f32 peak.  At batch 1 the grid
// has only H blocks (64 for Mamba2), fewer than the card's 132 SMs.  Not yet
// done: tensor cores (wgmma), TMA loads, chunk-parallel state passing, and
// sharing the scores across the heads of a group.
//
// The entry point returns the first CUDA error (the attribute call's, else
// cudaGetLastError() after the launch); it launches on the given stream,
// allocates nothing and does not synchronise.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;       // rows of a row tile and of a column tile
constexpr int kThreads = 256;
constexpr int kMaxChunk = 256;  // dt is loaded with one thread a row
constexpr int kMaxN = 128;

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

constexpr int kLdT = kTile + 4;  // row stride of the [*, 64] tiles

// Row stride of the [*, N] tiles: a multiple of 4 (float4 loads) that is not
// a multiple of 32, so 8 lanes reading 8 rows 16 apart hit 8 bank groups.
__host__ __device__ constexpr int ld_n(int N) { return N + 4; }

size_t smem_bytes(int P, int N) {
  return sizeof(float) * (static_cast<size_t>(P + 2 * kTile) * ld_n(N) +
                          static_cast<size_t>(P + kTile) * kLdT + 3 * kMaxChunk);
}

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

__device__ __forceinline__ float comp(float4 v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ s0,
                T* __restrict__ y, float* __restrict__ fin, int L, int H, int G,
                int N, int Q) {
  constexpr int kPC = (P + 15) / 16;      // head dims p = tx + 16 c a thread owns
  constexpr int kNC = kMaxN / 16;         // state columns n = tx + 16 c (update)
  const int LDN = ld_n(N);
  extern __shared__ float4 smem4[];
  float* Ss = reinterpret_cast<float*>(smem4);  // [P][LDN] the carried state
  float* Cs = Ss + P * LDN;               // [kTile][LDN] C rows i
  float* Bs = Cs + kTile * LDN;           // [kTile][LDN] B rows j
  float* XsT = Bs + kTile * LDN;          // [P][kLdT] x rows j, transposed
  float* Ms = XsT + P * kLdT;             // [kTile][kLdT] weighted scores
  float* acs = Ms + kTile * kLdT;         // [kMaxChunk] inclusive cumsum of dt * A
  float* dts = acs + kMaxChunk;           // [kMaxChunk] dt
  float* ws = dts + kMaxChunk;            // [kMaxChunk] exp(a_last - a_cs_j) dt_j

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const float Ah = A[h];
  const int64_t xrow = static_cast<int64_t>(H) * P;  // x and y row stride
  const int64_t brow = static_cast<int64_t>(G) * N;  // B and C row stride
  const T* xb = x + static_cast<int64_t>(b) * L * xrow + static_cast<int64_t>(h) * P;
  T* yb = y + static_cast<int64_t>(b) * L * xrow + static_cast<int64_t>(h) * P;
  const float* dtb = dt + static_cast<int64_t>(b) * L * H + h;
  const T* Bb = Bm + static_cast<int64_t>(b) * L * brow + static_cast<int64_t>(g) * N;
  const T* Cb = Cm + static_cast<int64_t>(b) * L * brow + static_cast<int64_t>(g) * N;
  const int64_t state_off = (static_cast<int64_t>(b) * H + h) * P * N;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int e = tid; e < P * N; e += kThreads) {
    Ss[(e / N) * LDN + e % N] = s0 != nullptr ? s0[state_off + e] : 0.f;
  }

  const int ntiles = (Q + kTile - 1) / kTile;
  for (int c0 = 0; c0 < L; c0 += Q) {
    // 1. dt and the inclusive cumsum of dt * A over the chunk, added up in
    // row order by one thread: the order of the plain version's cumsum.
    __syncthreads();  // the last chunk's readers of acs, dts, ws and tiles are done
    if (tid < Q) {
      const float d = dtb[static_cast<int64_t>(c0 + tid) * H];
      dts[tid] = d;
      acs[tid] = d * Ah;
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
    // zero past the chunk: the update reads ws in groups of four rows
    ws[tid] = tid < Q ? expf(a_last - acs[tid]) * dts[tid] : 0.f;
    // ws is first read after the __syncthreads() that follows the C tile load.

    for (int it = 0; it < ntiles; ++it) {
      const int i0 = it * kTile;
      const int ni = min(kTile, Q - i0);
      const bool last = it == ntiles - 1;
      for (int e = tid; e < kTile * N; e += kThreads) {
        const int r = e / N;
        const int n = e % N;
        Cs[r * LDN + n] = r < ni ? to_f32(Cb[static_cast<int64_t>(c0 + i0 + r) * brow + n]) : 0.f;
      }
      __syncthreads();

      // 2a. the read of the entering state: exp(a_cs_i) (C_i . S_p), rows
      // i = ty + 16 r, head dims p = tx + 16 c
      float acc[4][kPC];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < kPC; ++c) acc[r][c] = 0.f;
      }
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 cv[4];
        float4 sv[kPC];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = ld4(Cs + (ty + 16 * r) * LDN + n);
#pragma unroll
        for (int c = 0; c < kPC; ++c) {
          const int p = tx + 16 * c;
          sv[c] = p < P ? ld4(Ss + p * LDN + n) : zero4;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < kPC; ++c) acc[r][c] = dot4(cv[r], sv[c], acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        const float e = i < ni ? expf(acs[i0 + i]) : 0.f;
#pragma unroll
        for (int c = 0; c < kPC; ++c) acc[r][c] *= e;
      }

      // 2b. the intra-chunk quadratic over the column tiles j <= i; on the
      // last row tile the same walk feeds the state update (3), whose
      // elements are p = ty + 16 r, n = tx + 16 c.
      float upd[kPC][kNC];
#pragma unroll
      for (int r = 0; r < kPC; ++r) {
#pragma unroll
        for (int c = 0; c < kNC; ++c) upd[r][c] = 0.f;
      }
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        const int nj = min(kTile, Q - j0);
        const int nj4 = (nj + 3) & ~3;  // rows nj..nj4-1 are zero in every tile
        __syncthreads();  // the last tile's readers of Bs, XsT and Ms are done
        for (int e = tid; e < kTile * N; e += kThreads) {
          const int r = e / N;
          const int n = e % N;
          Bs[r * LDN + n] = r < nj ? to_f32(Bb[static_cast<int64_t>(c0 + j0 + r) * brow + n]) : 0.f;
        }
        for (int e = tid; e < kTile * P; e += kThreads) {
          const int r = e / P;
          const int p = e % P;
          XsT[p * kLdT + r] =
              r < nj ? to_f32(xb[static_cast<int64_t>(c0 + j0 + r) * xrow + p]) : 0.f;
        }
        __syncthreads();

        // scores C_i . B_j for rows i = ty + 16 r, columns j = tx + 16 c
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
        }
#pragma unroll 2
        for (int n = 0; n < N; n += 4) {
          float4 cv[4];
          float4 bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = ld4(Cs + (ty + 16 * r) * LDN + n);
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = ld4(Bs + (tx + 16 * c) * LDN + n);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] = dot4(cv[r], bv[c], s[r][c]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            float m = 0.f;
            if (j <= i && tx + 16 * c < nj && ty + 16 * r < ni) {
              m = s[r][c] * expf(acs[i] - acs[j]) * dts[j];
            }
            Ms[(ty + 16 * r) * kLdT + tx + 16 * c] = m;
          }
        }
        __syncthreads();  // every weighted score stored

        // y_i += sum_j M_ij x_j
        for (int jj = 0; jj < nj4; jj += 4) {
          float4 mv[4];
          float4 xv[kPC];
#pragma unroll
          for (int r = 0; r < 4; ++r) mv[r] = ld4(Ms + (ty + 16 * r) * kLdT + jj);
#pragma unroll
          for (int c = 0; c < kPC; ++c) {
            const int p = tx + 16 * c;
            xv[c] = p < P ? ld4(XsT + p * kLdT + jj) : zero4;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int c = 0; c < kPC; ++c) acc[r][c] = dot4(mv[r], xv[c], acc[r][c]);
          }
        }
        if (last) {
          // U_pn += sum_j (w_j x_jp) B_jn
          for (int jj = 0; jj < nj4; jj += 4) {
            const float4 w = ld4(ws + j0 + jj);
            float4 xw[kPC];
#pragma unroll
            for (int r = 0; r < kPC; ++r) {
              const int p = ty + 16 * r;
              const float4 xv = p < P ? ld4(XsT + p * kLdT + jj) : zero4;
              xw[r] = make_float4(xv.x * w.x, xv.y * w.y, xv.z * w.z, xv.w * w.w);
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float* brow_s = Bs + (jj + q) * LDN;
#pragma unroll
              for (int c = 0; c < kNC; ++c) {
                const int n = tx + 16 * c;
                if (n < N) {
                  const float bv = brow_s[n];
#pragma unroll
                  for (int r = 0; r < kPC; ++r) upd[r][c] = fmaf(comp(xw[r], q), bv, upd[r][c]);
                }
              }
            }
          }
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i >= ni) continue;
#pragma unroll
        for (int c = 0; c < kPC; ++c) {
          const int p = tx + 16 * c;
          if (p < P) yb[static_cast<int64_t>(c0 + i0 + i) * xrow + p] = from_f32<T>(acc[r][c]);
        }
      }

      if (last) {
        // 3. the state update, after every row of the chunk read the old state
        __syncthreads();
        const float decay = expf(a_last);
#pragma unroll
        for (int r = 0; r < kPC; ++r) {
          const int p = ty + 16 * r;
#pragma unroll
          for (int c = 0; c < kNC; ++c) {
            const int n = tx + 16 * c;
            if (p < P && n < N) {
              float* sp = Ss + p * LDN + n;
              *sp = fmaf(*sp, decay, upd[r][c]);
            }
          }
        }
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads) {
    fin[state_off + e] = Ss[(e / N) * LDN + e % N];
  }
}

template <typename T, int P>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* s0, void* y, float* fin, int B, int L,
           int H, int G, int N, int Q, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B);
  ssd_scan_kernel<T, P><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), s0, static_cast<T*>(y), fin, L, H, G, N, Q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, const float* s0, void* y, float* fin, int B, int L,
             int H, int P, int G, int N, int Q, cudaStream_t stream) {
  switch (P) {
    case 8: return launch<T, 8>(x, dt, A, Bm, Cm, s0, y, fin, B, L, H, G, N, Q, stream);
    case 16: return launch<T, 16>(x, dt, A, Bm, Cm, s0, y, fin, B, L, H, G, N, Q, stream);
    case 32: return launch<T, 32>(x, dt, A, Bm, Cm, s0, y, fin, B, L, H, G, N, Q, stream);
    case 64: return launch<T, 64>(x, dt, A, Bm, Cm, s0, y, fin, B, L, H, G, N, Q, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// x, y: [B, L, H, P]; dt: [B, L, H] f32; A: [H] f32; Bm, Cm: [B, L, G, N];
// s0 (may be null: a zero state) and fin: [B, H, P, N] f32; all contiguous.
// x, Bm, Cm and y share one dtype: 0 = float32, 1 = bfloat16.  Needs P in
// {8, 16, 32, 64}, N in {16, 32, 64, 128}, 1 <= chunk <= 256, L % chunk == 0,
// H % G == 0 and B <= 65535; anything else returns cudaErrorInvalidValue
// without launching.
int ssd_scan_launch(const void* x, const float* dt, const float* A,
                    const void* Bm, const void* Cm, const float* s0, void* y,
                    float* fin, int dtype, int B, int L, int H, int P, int G,
                    int N, int chunk, void* stream) {
  const bool n_ok = N == 16 || N == 32 || N == 64 || N == 128;
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || L < 0 || !n_ok ||
      chunk < 1 || chunk > kMaxChunk || L % chunk != 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_p<float>(x, dt, A, Bm, Cm, s0, y, fin, B, L, H, P, G, N, chunk, s);
  if (dtype == 1) {
    return launch_p<__nv_bfloat16>(x, dt, A, Bm, Cm, s0, y, fin, B, L, H, P, G, N, chunk, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
