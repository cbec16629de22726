// Causal or non-causal GQA attention, forward pass, with an online softmax,
// for Hopper (sm_90a).  A plain C interface, built with nvcc into a shared
// library and loaded with ctypes by ../flash_attention.py.
//
// Replaces (TPU kernel of the JAX reference package):
//   flash_attention  <- src/repro/kernels/flash_attention.py,
//                       flash_attention / _flash_kernel
//
// What it computes: q [B, H, Sq, D], k and v [B, KH, Sk, D] -> o [B, H, Sq, D].
// Query head h reads KV head h / (H / KH).  s = (q . k) * scale in f32; with
// `causal`, key positions after the query position (both counted from 0: the
// top-left corner, also when Sq != Sk) are masked; the output is
// acc / max(l, 1e-30) in the input's dtype.
//
// The TPU kernel walks (b, h, q-block, kv-block) with the kv-block axis
// innermost and sequential, carrying max, denominator and accumulator in
// VMEM scratch.  Here one block owns one (b, h, q tile) and a loop over
// 64-row KV tiles takes the place of the sequential grid axis; the carried
// state lives in registers.  KV tiles wholly above the diagonal are never
// loaded; only a tile that crosses it is masked.  Blocks take q tiles from
// the last, so the longest causal rows start first.  One entry point,
// flash_attention_launch, dispatches on the dtype to one of two kernels.
//
// float32 (flash_fwd_f32_kernel): every product and sum in f32 FMA on the
// CUDA cores (no TF32), so it matches the plain version to rounding.  One
// block of 256 threads owns 64 query rows.  Thread (ty, tx) = (tid / 16,
// tid % 16) owns rows ty + 16 i (i < 4): score columns tx + 16 j (j < 4),
// output head dims tx + 16 j (j < D / 16).  A row's 64 scores sit in the 16
// lanes of a half-warp (max and sum: four xor-shuffles).  Q, K and V are
// f32 in shared memory (rows padded to D + 1), the probabilities go through
// shared memory to the P.V product.  Shared memory (3 * 64 * (D + 1) + 64 *
// 65) floats: 66 KB at D = 64, 209 KB at D = 256.  Bound: operations (0.77
// ms at 67 TFLOP/s for train100m's B=8, H=12, S=2048, D=64 causal); scalar
// shared-memory loads, one per two FMAs, cap it near a third of that.
//
// bfloat16 (flash_fwd_bf16_kernel): the tensor cores through
// mma.sync.m16n8k16 (bf16 inputs, f32 accumulators in registers), the
// FlashAttention-2 shape.  wgmma was the target; it was not built because
// its shared-memory descriptors and swizzled layouts could not be checked
// before a chip run, and mma.sync reaches the tensor cores with layouts
// that ldmatrix documents per lane.  Each warp owns 16 query rows; a block
// has 8 warps (128 rows) for D <= 128 and 4 warps (64 rows) at D = 256,
// within the register budget.  Per 64-row KV tile, a warp computes its
// 16 x 64 scores S = Q K^T (A = Q from ldmatrix, kept in registers for D <=
// 128; B = K rows via ldmatrix), scales them into the log2 domain, masks
// the diagonal tile, and updates the running max and sum in registers on
// the accumulator's fragment layout: a row lives in the four lanes of a
// quad, so its max takes two xor-shuffles (the sum is kept per lane and
// reduced once at the end).  P = exp2(s - m) is rounded to bf16 in
// registers and used directly as the A operand of O += P V, the C fragments
// of two n8 score tiles making one k16 A fragment; V comes in as B through
// ldmatrix.trans.  K and V tiles flow through a two-stage ring in shared
// memory, loaded with cp.async (16 bytes a thread), the next tile's copy in
// flight while the current one is used.  Rows are padded to D + 8 bf16, so
// the eight 16-byte rows of an ldmatrix hit eight bank groups.  Shared
// memory: (BQ + 4 * 64) (D + 8) bf16, 55 KB at D = 64, 169 KB at D = 256.
// Bound: operations, 0.052 ms at 989 TFLOP/s for train100m's shape; mma.sync
// cannot reach that peak (the rate that wgmma alone gives).
//
// Both kernels need Sq % 64 == 0, Sk % 64 == 0, H % KH == 0 and D in {32,
// 64, 128, 256}.  Shared memory above 48 KB is opted into with
// cudaFuncSetAttribute.  The entry point returns the first CUDA error (the
// attribute call's, else cudaGetLastError() after the launch); it launches
// on the given stream, allocates nothing and does not synchronise.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 64;  // key rows of a tile (both kernels)
constexpr float kMasked = -1e30f;

// ---------------------------------------------------------------------------
// float32: CUDA cores.
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;  // query rows of a block
constexpr int kThreads = 256;

template <int D>
constexpr size_t smem_bytes_f32() {
  return sizeof(float) * (2 * kBQ * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int H,
                     int KH, int Sq, int Sk, float scale, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kCols = D / 16;  // output head dims a thread owns
  extern __shared__ float smem[];
  float* Qs = smem;                 // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);   // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);   // [kBK][D]
  float* Ps = Vs + kBK * D;         // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const float* qb = q + ((static_cast<int64_t>(b) * H + h) * Sq + q0) * D;
  const float* kb = k + (static_cast<int64_t>(b) * KH + kh) * Sk * D;
  const float* vb = v + (static_cast<int64_t>(b) * KH + kh) * Sk * D;
  float* ob = o + ((static_cast<int64_t>(b) * H + h) * Sq + q0) * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    Qs[(e / D) * (D + 1) + e % D] = qb[e];
  }

  float acc[4][kCols];
  float m[4];
  float l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  // Causal: only tiles with a key at or before the tile's last query row.
  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // Qs stored (first tile); Ks, Vs, Ps free (later tiles)
    const float* kt = kb + static_cast<int64_t>(k0) * D;
    const float* vt = vb + static_cast<int64_t>(k0) * D;
    for (int e = tid; e < kBK * D; e += kThreads) {
      Ks[(e / D) * (D + 1) + e % D] = kt[e];
      Vs[e] = vt[e];
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4];
      float kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

    const bool crosses_diagonal = causal && k0 + kBK - 1 > q0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (crosses_diagonal && q0 + row < k0 + tx + 16 * j) x = kMasked;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[row * (kBK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      }
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // every row's probabilities stored

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv_den = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      ob[(ty + 16 * i) * D + tx + 16 * j] = acc[i][j] * inv_den;
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int KH, int Sq, int Sk, float scale, int causal,
               cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_f32<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Sq / kBQ, H, B);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, KH, Sq, Sk,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync.m16n8k16, ldmatrix, cp.async).
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

template <int D>
struct Bf16Tile {
  static constexpr int kWarps = D == 256 ? 4 : 8;  // 16 query rows a warp
  static constexpr int kBQ = 16 * kWarps;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kLd = D + 8;                 // padded smem row, bf16
  static constexpr size_t kSmem = sizeof(bf16) * static_cast<size_t>(kBQ + 4 * kBK) * kLd;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float minus_inf() { return __int_as_float(0xff800000); }

// Two f32 rounded to one bf16x2 register, `lo` in the low half (the lower
// column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(Bf16Tile<D>::kThreads, D <= 64 ? 2 : 1)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int H, int KH,
                      int Sq, int Sk, float scale_log2, int causal) {
  using Cfg = Bf16Tile<D>;
  constexpr int kBQb = Cfg::kBQ;
  constexpr int kThr = Cfg::kThreads;
  constexpr int kLd = Cfg::kLd;
  constexpr int kChunks = D / 8;       // 16-byte pieces of a row
  constexpr int kKS = D / 16;          // k16 steps of Q K^T
  constexpr int kST = kBK / 8;         // n8 tiles of a warp's scores
  constexpr int kOT = D / 8;           // n8 tiles of a warp's output
  constexpr bool kQRegs = D <= 128;    // Q fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQb][kLd]
  bf16* Ks = Qs + kBQb * kLd;                    // [2][kBK][kLd]
  bf16* Vs = Ks + 2 * kBK * kLd;                 // [2][kBK][kLd]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQb;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const bf16* qb = q + ((static_cast<int64_t>(b) * H + h) * Sq + q0) * D;
  const bf16* kb = k + (static_cast<int64_t>(b) * KH + kh) * Sk * D;
  const bf16* vb = v + (static_cast<int64_t>(b) * KH + kh) * Sk * D;
  bf16* ob = o + ((static_cast<int64_t>(b) * H + h) * Sq + q0) * D;
  const int q_rows = min(kBQb, Sq - q0);  // a multiple of 64, so of 16

  for (int c = tid; c < q_rows * kChunks; c += kThr) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    cp_async16(Qs + r * kLd + col, qb + static_cast<int64_t>(r) * D + col);
  }
  auto load_kv = [&](int stage, int k0) {
    bf16* kd = Ks + stage * kBK * kLd;
    bf16* vd = Vs + stage * kBK * kLd;
    const bf16* ks = kb + static_cast<int64_t>(k0) * D;
    const bf16* vs = vb + static_cast<int64_t>(k0) * D;
    for (int c = tid; c < kBK * kChunks; c += kThr) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 8;
      cp_async16(kd + r * kLd + col, ks + r * D + col);
      cp_async16(vd + r * kLd + col, vs + r * D + col);
    }
  };

  // Causal: only tiles with a key at or before the block's last query row.
  const int k_end = causal ? min(Sk, q0 + q_rows) : Sk;
  const int n_tiles = k_end / kBK;
  load_kv(0, 0);
  cp_async_commit();  // group 0: Q and the first KV tile

  const int row0 = q0 + warp * 16;  // the warp's first query row
  const bool active = warp * 16 < q_rows;
  float acc[kOT][4];
#pragma unroll
  for (int i = 0; i < kOT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }
  float m[2] = {kMasked, kMasked};  // rows g and g + 8, log2 domain
  float l[2] = {0.f, 0.f};          // this lane's part of the row sums
  uint32_t qf[kQRegs ? kKS : 1][4];
  const bf16* q_frag = Qs + (warp * 16 + (lane & 15)) * kLd + (lane >> 4) * 8;

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) load_kv(stage ^ 1, (j + 1) * kBK);
    cp_async_commit();  // possibly empty: keeps one group per tile
    cp_async_wait<1>();  // tile j (and Q) landed
    __syncthreads();
    const int k0 = j * kBK;
    if constexpr (kQRegs) {
      if (j == 0 && active) {
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk) ldsm_x4(qf[kk], q_frag + kk * 16);
      }
    }
    if (active && !(causal && k0 > row0 + 15)) {
      const bf16* Kt = Ks + stage * kBK * kLd;
      const bf16* Vt = Vs + stage * kBK * kLd;
      float s[kST][4];
#pragma unroll
      for (int i = 0; i < kST; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
      }
      // S = Q K^T: per k16 step, one A fragment and two n8 tiles of K per ldmatrix
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        uint32_t a[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
        } else {
          ldsm_x4(a, q_frag + kk * 16);
        }
#pragma unroll
        for (int np = 0; np < kST / 2; ++np) {
          uint32_t bk[4];
          ldsm_x4(bk, Kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kLd + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }
      // the online softmax on the fragment layout: s[i][e] is row g + 8 (e / 2),
      // column k0 + 8 i + 2 t + e % 2
      const bool crosses = causal && k0 + kBK - 1 > row0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + g + 8 * r;
        float mx = kMasked;
#pragma unroll
        for (int i = 0; i < kST; ++i) {
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            float x = s[i][e] * scale_log2;
            if (crosses && k0 + 8 * i + 2 * t + (e & 1) > row) x = minus_inf();
            s[i][e] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float alpha = exp2f(m[r] - m_new);
        m[r] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int i = 0; i < kST; ++i) {
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float p = exp2f(s[i][e] - m_new);
            s[i][e] = p;
            rs += p;
          }
        }
        l[r] = l[r] * alpha + rs;
#pragma unroll
        for (int i = 0; i < kOT; ++i) {
          acc[i][2 * r] *= alpha;
          acc[i][2 * r + 1] *= alpha;
        }
      }
      // O += P V: the C fragments of score tiles 2 kk and 2 kk + 1 are the A
      // fragment of k16 step kk
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < kOT / 2; ++dp) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                dp * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * dp], a, bv[0], bv[1]);
          mma_bf16(acc[2 * dp + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this stage is read; the next iteration refills it
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float den = l[r];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const float inv = 1.f / fmaxf(den, 1e-30f);
    bf16* orow = ob + static_cast<int64_t>(warp * 16 + g + 8 * r) * D + 2 * t;
#pragma unroll
    for (int i = 0; i < kOT; ++i) {
      *reinterpret_cast<uint32_t*>(orow + 8 * i) =
          pack_bf16(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int H, int KH, int Sq, int Sk, float scale, int causal,
                cudaStream_t stream) {
  using Cfg = Bf16Tile<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + Cfg::kBQ - 1) / Cfg::kBQ, H, B);
  flash_fwd_bf16_kernel<D><<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, KH, Sq, Sk,
      scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

int launch_dim(bool bf16_inputs, const void* q, const void* k, const void* v, void* o,
               int B, int H, int KH, int Sq, int Sk, int D, float scale, int causal,
               cudaStream_t s) {
#define FLASH_CASE(DIM)                                                        \
  case DIM:                                                                    \
    return bf16_inputs                                                         \
               ? launch_bf16<DIM>(q, k, v, o, B, H, KH, Sq, Sk, scale, causal, s) \
               : launch_f32<DIM>(q, k, v, o, B, H, KH, Sq, Sk, scale, causal, s);
  switch (D) {
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

}  // namespace

extern "C" {

// q, o: [B, H, Sq, D]; k, v: [B, KH, Sk, D]; contiguous, of one dtype:
// dtype 0 = float32, 1 = bfloat16.  Needs Sq % 64 == 0, Sk % 64 == 0,
// H % KH == 0 and D in {32, 64, 128, 256}; anything else returns
// cudaErrorInvalidValue without launching.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int H, int KH, int Sq,
                           int Sk, int D, float scale, int causal,
                           void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq % kBQ != 0 ||
      Sk % kBK != 0 || Sk <= 0 || H > 65535 || B > 65535 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Sq == 0) return 0;
  return launch_dim(dtype == 1, q, k, v, o, B, H, KH, Sq, Sk, D, scale, causal,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
