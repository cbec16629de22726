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
// loaded; only a tile that crosses it, or holds the last key, is masked.
// Blocks take q tiles from the last, so the longest causal rows start
// first.  One entry point, flash_attention_launch, dispatches on the dtype
// to one of two kernels.
//
// float32 (flash_fwd_f32_kernel): the tensor cores in 3xTF32, through
// mma.sync.m16n8k8 (tf32 inputs, f32 accumulators), on the skeleton of the
// bf16 kernel below (16 query rows a warp, 64-key tiles in a two-stage
// cp.async ring, the online softmax in the log2 domain on the accumulator's
// fragment layout, the diagonal and last tiles alone masked, q tiles from
// the last).
// Each f32 operand x is split in two tf32 values, hi = x rounded to nearest
// (ties away) at 10 mantissa bits and lo = x - hi rounded the same way,
// both by bit arithmetic with the low 13 bits cleared; a product is hi.hi +
// hi.lo + lo.hi, accumulated in f32 (small terms first).  The dropped lo.lo
// term and lo's rounding are each near 2^-22 relative, so the kernel keeps
// f32 accuracy (2e-5 against the plain version), where one tf32 pass would
// be near 1e-3.  The k index of a k8 step is permuted so that no fragment
// needs a shuffle: in Q K^T a lane's A columns {t, t + 4} are head dims
// {4t, 4t + 1} (the next step's {4t + 2, 4t + 3}), so A (Q) and B (K)
// fragments come as one float4 a row; in P V the A columns {t, t + 4} are
// keys {2t, 2t + 1}, which are the columns the score accumulator already
// holds, so P passes from C to A in registers, and B (V) is two scalars
// down a column.  ldmatrix moves 16-bit units and cannot transpose f32, so
// every shared load is a plain one: K rows are padded to D + 16 floats
// (the float4 reads of 8 lanes on two rows hit 32 banks), V rows to D + 4
// (the scalar reads of 4 rows x 8 columns hit 32 banks).  At D <= 64 Q's
// hi and lo fragments live in registers (64 at D = 64) and each landed K/V
// tile is split once per block, every thread splitting the 16-byte pieces
// it copied, into hi (in place) and lo planes; a block has 8 warps (128
// rows) and 151.6 KB of shared memory at D = 64.  Splitting per warp
// instead repeats the work in each of the 8 warps: on an H100 80GB HBM3 at
// 700 W it was 2-6 % slower at train100m's shape (PERF.md).  At D = 128
// and 256 the planes and Q's fragments do not fit: Q stays in shared
// memory, every fragment is split as it is read, a block has 4 warps, and
// D = 256 takes 32-key tiles (205.8 KB).  Bound: operations, 3 passes of
// tf32 products, 0.3126 ms at 494.7 TFLOP/s (dense TF32) for train100m's
// B=8, H=12, S=2048, D=64 causal; one f32 FMA pass on the CUDA cores would
// take 0.7696 ms at 67 TFLOP/s.  mma.sync does not reach the dense TF32
// rate (wgmma alone does), and at D <= 64 each warp reads 64 KB of split K
// and V a tile.
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
// Both kernels take any Sq >= 0 and Sk >= 1.  Each has two instances:
// lengths that are multiples of 64 take the one without partial tiles;
// any other length takes kRagged, which masks the last, partial q tile and
// key tile.  There, rows past Sq or Sk land in shared memory as zeros
// (cp.async with a source size of 0), so a masked P of 0 times V is 0,
// never 0 times a stale NaN; in the online softmax the key columns at or
// past Sk of the last tile are -inf, decided once a tile; rows past Sq are
// computed and not stored.  Keeping the masks out of the other instance
// keeps it at the unmasked kernel's registers and time: with them the
// full-length shapes lost 2-12 % on H100 80GB HBM3 at 700 W, and the bf16
// kernel at D = 64 spilled at its 128-register cap (PERF.md).  Both need
// H % KH == 0 and D in {32, 64, 128, 256} (the wrapper pads other head
// dims up to 256 with zeros).  Shared memory above 48 KB is opted into
// with cudaFuncSetAttribute.  The entry point returns the first CUDA error (the
// attribute call's, else cudaGetLastError() after the launch); it launches
// on the given stream, allocates nothing and does not synchronise.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 64;        // key rows of a bf16 tile
constexpr int kFullTile = 64;  // Sq and Sk multiples of this: no tile is partial
constexpr float kMasked = -1e30f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// 16 bytes from src, or 16 zero bytes when !full (a source size of 0: src is
// not read, but it must still be a valid, aligned address).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float minus_inf() { return __int_as_float(0xff800000); }

// ---------------------------------------------------------------------------
// float32: tensor cores in 3xTF32 (mma.sync.m16n8k8, cp.async).
// ---------------------------------------------------------------------------

template <int D>
struct F32Tile {
  static constexpr int kWarps = D <= 64 ? 8 : 4;      // 16 query rows a warp
  static constexpr int kBQ = 16 * kWarps;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBKt = D == 256 ? 32 : 64;     // key rows of a tile
  static constexpr bool kQRegs = D <= 64;             // Q's hi/lo fragments in registers
  static constexpr bool kPlanes = D <= 64;           // K/V split once a block
  static constexpr int kLdK = D + 16;                 // padded K (and Q) row, floats
  static constexpr int kLdV = D + 4;                  // padded V row, floats
  // one ring stage: K (hi in place), V (hi in place), then the lo planes
  static constexpr int kStage = kBKt * (kLdK + kLdV) * (kPlanes ? 2 : 1);
  static constexpr size_t kSmem = sizeof(float) * ((kQRegs ? 0 : kBQ * kLdK) + 2 * kStage);
};

// x rounded to tf32 (10 mantissa bits, to nearest, ties away from zero),
// the 13 low bits cleared: the exact value the tensor core multiplies.
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to within 2^-22 |x|, both exact tf32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split_tf32(const float4& x, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(x.x, hi[0], lo[0]);
  split_tf32(x.y, hi[1], lo[1]);
  split_tf32(x.z, hi[2], lo[2]);
  split_tf32(x.w, hi[3], lo[3]);
}

__device__ __forceinline__ void load_u4(uint32_t (&r)[4], const float* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}

// c (16 x 8, f32) += a (16 x 8, tf32, row) . b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32: the small products first, then hi . hi.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

template <int D, bool kRagged>
__global__ void __launch_bounds__(F32Tile<D>::kThreads, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int H, int KH,
                     int Sq, int Sk, float scale_log2, int causal) {
  using Cfg = F32Tile<D>;
  constexpr int kBQb = Cfg::kBQ;
  constexpr int kThr = Cfg::kThreads;
  constexpr int kBKt = Cfg::kBKt;
  constexpr int kLdK = Cfg::kLdK;
  constexpr int kLdV = Cfg::kLdV;
  constexpr int kChunks = D / 4;   // 16-byte pieces of a row
  constexpr int kKP = D / 16;      // pairs of k8 steps of Q K^T (one float4 a row)
  constexpr int kST = kBKt / 8;    // n8 tiles of a warp's scores = k8 steps of P V
  constexpr int kOT = D / 8;       // n8 tiles of a warp's output
  extern __shared__ __align__(16) float smem_f[];
  float* Qs = smem_f;                                           // [kBQb][kLdK], D >= 128
  float* ring = smem_f + (Cfg::kQRegs ? 0 : kBQb * kLdK);       // [2][kStage]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQb;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const float* qb = q + ((static_cast<int64_t>(b) * H + h) * Sq + q0) * D;
  const float* kb = k + (static_cast<int64_t>(b) * KH + kh) * Sk * D;
  const float* vb = v + (static_cast<int64_t>(b) * KH + kh) * Sk * D;
  float* ob = o + ((static_cast<int64_t>(b) * H + h) * Sq + q0) * D;
  const int q_rows = min(kBQb, Sq - q0);  // the last q tile may be partial

  if constexpr (!Cfg::kQRegs) {
    // kRagged: rows past Sq land as zeros
    for (int c = tid; c < (kRagged ? kBQb : q_rows) * kChunks; c += kThr) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 4;
      if constexpr (kRagged) {
        const bool in = r < q_rows;
        cp_async16_zfill(Qs + r * kLdK + col, qb + static_cast<int64_t>(in ? r : 0) * D + col,
                         in);
      } else {
        cp_async16(Qs + r * kLdK + col, qb + static_cast<int64_t>(r) * D + col);
      }
    }
  }
  // kRagged: key rows past Sk land as zeros (K and V: a masked P of 0 times
  // V is 0).
  auto load_kv = [&](int stage, int k0) {
    float* kd = ring + stage * Cfg::kStage;
    float* vd = kd + kBKt * kLdK;
    const float* ks = kb + static_cast<int64_t>(k0) * D;
    const float* vs = vb + static_cast<int64_t>(k0) * D;
    for (int c = tid; c < kBKt * kChunks; c += kThr) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 4;
      if constexpr (kRagged) {
        const bool in = r < Sk - k0;
        const int src = (in ? r : 0) * D + col;
        cp_async16_zfill(kd + r * kLdK + col, ks + src, in);
        cp_async16_zfill(vd + r * kLdV + col, vs + src, in);
      } else {
        cp_async16(kd + r * kLdK + col, ks + r * D + col);
        cp_async16(vd + r * kLdV + col, vs + r * D + col);
      }
    }
  };
  // The pieces this thread copied, visible to it after the wait: hi over
  // the raw values, lo into the stage's lo planes.
  auto split_kv = [&](int stage) {
    float* kd = ring + stage * Cfg::kStage;
    float* vd = kd + kBKt * kLdK;
    float* kl = vd + kBKt * kLdV;
    float* vl = kl + kBKt * kLdK;
    for (int c = tid; c < kBKt * kChunks; c += kThr) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 4;
      uint32_t hi[4], lo[4];
      split_tf32(*reinterpret_cast<const float4*>(kd + r * kLdK + col), hi, lo);
      *reinterpret_cast<uint4*>(kd + r * kLdK + col) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(kl + r * kLdK + col) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      split_tf32(*reinterpret_cast<const float4*>(vd + r * kLdV + col), hi, lo);
      *reinterpret_cast<uint4*>(vd + r * kLdV + col) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(vl + r * kLdV + col) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  };

  // Causal: only tiles with a key at or before the block's last query row.
  const int k_end = causal ? min(Sk, q0 + q_rows) : Sk;
  const int n_tiles = (k_end + kBKt - 1) / kBKt;
  load_kv(0, 0);
  cp_async_commit();  // group 0: (Q and) the first KV tile

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

  // A fragments of Q, k8 step 2 kp + u: a0 / a1 = rows g / g + 8 at head dim
  // 16 kp + 4 t + 2 u, a2 / a3 the same rows at the next dim.
  constexpr int kQF = Cfg::kQRegs ? 2 * kKP : 1;
  uint32_t qh[kQF][4], ql[kQF][4];
  const float* q_frag = Qs + (warp * 16 + g) * kLdK + 4 * t;
  auto q_pair = [&](const float4& r0, const float4& r1, uint32_t (&h0)[4], uint32_t (&l0)[4],
                    uint32_t (&h1)[4], uint32_t (&l1)[4]) {
    split_tf32(r0.x, h0[0], l0[0]);
    split_tf32(r1.x, h0[1], l0[1]);
    split_tf32(r0.y, h0[2], l0[2]);
    split_tf32(r1.y, h0[3], l0[3]);
    split_tf32(r0.z, h1[0], l1[0]);
    split_tf32(r1.z, h1[1], l1[1]);
    split_tf32(r0.w, h1[2], l1[2]);
    split_tf32(r1.w, h1[3], l1[3]);
  };
  if constexpr (Cfg::kQRegs) {
    if (active) {
      // rows g and g + 8 of the warp; a row past Sq reads as zeros
      const bool in0 = !kRagged || warp * 16 + g < q_rows;
      const bool in1 = !kRagged || warp * 16 + g + 8 < q_rows;
      const float* r0 = qb + static_cast<int64_t>(warp * 16 + g) * D + 4 * t;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int kp = 0; kp < kKP; ++kp) {
        const float4 x0 = in0 ? *reinterpret_cast<const float4*>(r0 + 16 * kp) : zero;
        const float4 x1 = in1 ? *reinterpret_cast<const float4*>(r0 + 8 * D + 16 * kp) : zero;
        q_pair(x0, x1, qh[2 * kp], ql[2 * kp], qh[2 * kp + 1], ql[2 * kp + 1]);
      }
    }
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) load_kv(stage ^ 1, (j + 1) * kBKt);
    cp_async_commit();   // possibly empty: keeps one group per tile
    cp_async_wait<1>();  // tile j (and Q) landed
    if constexpr (Cfg::kPlanes) split_kv(stage);
    __syncthreads();
    const int k0 = j * kBKt;
    if (active && !(causal && k0 > row0 + 15)) {
      const float* Kt = ring + stage * Cfg::kStage;
      const float* Vt = Kt + kBKt * kLdK;
      const float* Ktl = Vt + kBKt * kLdV;
      const float* Vtl = Ktl + kBKt * kLdK;
      float s[kST][4];
#pragma unroll
      for (int i = 0; i < kST; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
      }
      // S = Q K^T: per pair of k8 steps, one float4 of K a lane and n8 tile
      // (b0 / b1 = key 8 nt + g at head dims 16 kp + 4 t + 2 u and + 1)
#pragma unroll
      for (int kp = 0; kp < kKP; ++kp) {
        uint32_t ah[2][4], al[2][4];
        if constexpr (Cfg::kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[0][e] = qh[2 * kp][e];
            al[0][e] = ql[2 * kp][e];
            ah[1][e] = qh[2 * kp + 1][e];
            al[1][e] = ql[2 * kp + 1][e];
          }
        } else {
          const float4 x0 = *reinterpret_cast<const float4*>(q_frag + 16 * kp);
          const float4 x1 = *reinterpret_cast<const float4*>(q_frag + 8 * kLdK + 16 * kp);
          q_pair(x0, x1, ah[0], al[0], ah[1], al[1]);
        }
#pragma unroll
        for (int nt = 0; nt < kST; ++nt) {
          const int off = (nt * 8 + g) * kLdK + 16 * kp + 4 * t;
          uint32_t bh[4], bl[4];
          if constexpr (Cfg::kPlanes) {
            load_u4(bh, Kt + off);
            load_u4(bl, Ktl + off);
          } else {
            split_tf32(*reinterpret_cast<const float4*>(Kt + off), bh, bl);
          }
          mma_3xtf32(s[nt], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
          mma_3xtf32(s[nt], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
        }
      }
      // the online softmax on the fragment layout: s[i][e] is row g + 8 (e / 2),
      // key k0 + 8 i + 2 t + e % 2.  A tile that crosses the diagonal masks
      // the keys past the row; the last, partial tile also those at or past
      // Sk.
      const bool masked = (causal && k0 + kBKt - 1 > row0) || (kRagged && k0 + kBKt > Sk);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + g + 8 * r;
        const int last = !kRagged ? row : causal ? min(row, Sk - 1) : Sk - 1;
        float mx = kMasked;
#pragma unroll
        for (int i = 0; i < kST; ++i) {
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            float x = s[i][e] * scale_log2;
            if (masked && k0 + 8 * i + 2 * t + (e & 1) > last) x = minus_inf();
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
      // O += P V, k8 step nt over keys 8 nt + {2 t, 2 t + 1}: A is score tile
      // nt's C fragment (c0, c2, c1, c3); b0 / b1 = V rows 8 nt + 2 t and + 1
      // at head dim 8 dt + g
#pragma unroll
      for (int nt = 0; nt < kST; ++nt) {
        uint32_t ph[4], pl[4];
        split_tf32(s[nt][0], ph[0], pl[0]);
        split_tf32(s[nt][2], ph[1], pl[1]);
        split_tf32(s[nt][1], ph[2], pl[2]);
        split_tf32(s[nt][3], ph[3], pl[3]);
        const int off = (8 * nt + 2 * t) * kLdV + g;
#pragma unroll
        for (int dt = 0; dt < kOT; ++dt) {
          uint32_t bh0, bh1, bl0, bl1;
          if constexpr (Cfg::kPlanes) {
            bh0 = __float_as_uint(Vt[off + 8 * dt]);
            bh1 = __float_as_uint(Vt[off + kLdV + 8 * dt]);
            bl0 = __float_as_uint(Vtl[off + 8 * dt]);
            bl1 = __float_as_uint(Vtl[off + kLdV + 8 * dt]);
          } else {
            split_tf32(Vt[off + 8 * dt], bh0, bl0);
            split_tf32(Vt[off + kLdV + 8 * dt], bh1, bl1);
          }
          mma_3xtf32(acc[dt], ph, pl, bh0, bh1, bl0, bl1);
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
    if (kRagged && row0 + g + 8 * r >= Sq) continue;  // past Sq: computed, not stored
    float* orow = ob + static_cast<int64_t>(warp * 16 + g + 8 * r) * D + 2 * t;
#pragma unroll
    for (int i = 0; i < kOT; ++i) {
      *reinterpret_cast<float2*>(orow + 8 * i) =
          make_float2(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
    }
  }
}

template <int D, bool kRagged>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int KH, int Sq, int Sk, float scale, int causal,
               cudaStream_t stream) {
  using Cfg = F32Tile<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D, kRagged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + Cfg::kBQ - 1) / Cfg::kBQ, H, B);
  flash_fwd_f32_kernel<D, kRagged><<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, KH, Sq, Sk,
      scale * 1.4426950408889634f, causal);
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

// Two f32 rounded to one bf16x2 register, `lo` in the low half (the lower
// column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D, bool kRagged>
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
  const int q_rows = min(kBQb, Sq - q0);  // the last q tile may be partial

  // kRagged: rows past Sq land as zeros
  for (int c = tid; c < (kRagged ? kBQb : q_rows) * kChunks; c += kThr) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    if constexpr (kRagged) {
      const bool in = r < q_rows;
      cp_async16_zfill(Qs + r * kLd + col, qb + static_cast<int64_t>(in ? r : 0) * D + col, in);
    } else {
      cp_async16(Qs + r * kLd + col, qb + static_cast<int64_t>(r) * D + col);
    }
  }
  // kRagged: key rows past Sk land as zeros (K and V: a masked P of 0 times
  // V is 0).
  auto load_kv = [&](int stage, int k0) {
    bf16* kd = Ks + stage * kBK * kLd;
    bf16* vd = Vs + stage * kBK * kLd;
    const bf16* ks = kb + static_cast<int64_t>(k0) * D;
    const bf16* vs = vb + static_cast<int64_t>(k0) * D;
    for (int c = tid; c < kBK * kChunks; c += kThr) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 8;
      if constexpr (kRagged) {
        const bool in = r < Sk - k0;
        const int src = (in ? r : 0) * D + col;
        cp_async16_zfill(kd + r * kLd + col, ks + src, in);
        cp_async16_zfill(vd + r * kLd + col, vs + src, in);
      } else {
        cp_async16(kd + r * kLd + col, ks + r * D + col);
        cp_async16(vd + r * kLd + col, vs + r * D + col);
      }
    }
  };

  // Causal: only tiles with a key at or before the block's last query row.
  const int k_end = causal ? min(Sk, q0 + q_rows) : Sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;
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
      // column k0 + 8 i + 2 t + e % 2.  A tile that crosses the diagonal
      // masks the keys past the row; the last, partial tile also those at or
      // past Sk.
      const bool masked = (causal && k0 + kBK - 1 > row0) || (kRagged && k0 + kBK > Sk);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + g + 8 * r;
        const int last = !kRagged ? row : causal ? min(row, Sk - 1) : Sk - 1;
        float mx = kMasked;
#pragma unroll
        for (int i = 0; i < kST; ++i) {
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            float x = s[i][e] * scale_log2;
            if (masked && k0 + 8 * i + 2 * t + (e & 1) > last) x = minus_inf();
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
    if (kRagged && row0 + g + 8 * r >= Sq) continue;  // past Sq: computed, not stored
    bf16* orow = ob + static_cast<int64_t>(warp * 16 + g + 8 * r) * D + 2 * t;
#pragma unroll
    for (int i = 0; i < kOT; ++i) {
      *reinterpret_cast<uint32_t*>(orow + 8 * i) =
          pack_bf16(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
    }
  }
}

template <int D, bool kRagged>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int H, int KH, int Sq, int Sk, float scale, int causal,
                cudaStream_t stream) {
  using Cfg = Bf16Tile<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D, kRagged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + Cfg::kBQ - 1) / Cfg::kBQ, H, B);
  flash_fwd_bf16_kernel<D, kRagged><<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, KH, Sq, Sk,
      scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kRagged>
int launch(bool bf16_inputs, const void* q, const void* k, const void* v, void* o, int B,
           int H, int KH, int Sq, int Sk, float scale, int causal, cudaStream_t s) {
  return bf16_inputs ? launch_bf16<D, kRagged>(q, k, v, o, B, H, KH, Sq, Sk, scale, causal, s)
                     : launch_f32<D, kRagged>(q, k, v, o, B, H, KH, Sq, Sk, scale, causal, s);
}

// Lengths that are multiples of kFullTile take the instance without masked
// tiles; any other length the kRagged one.
int launch_dim(bool bf16_inputs, const void* q, const void* k, const void* v, void* o,
               int B, int H, int KH, int Sq, int Sk, int D, float scale, int causal,
               cudaStream_t s) {
  const bool ragged = Sq % kFullTile != 0 || Sk % kFullTile != 0;
#define FLASH_CASE(DIM)                                                              \
  case DIM:                                                                          \
    return ragged ? launch<DIM, true>(bf16_inputs, q, k, v, o, B, H, KH, Sq, Sk, scale, \
                                      causal, s)                                     \
                  : launch<DIM, false>(bf16_inputs, q, k, v, o, B, H, KH, Sq, Sk, scale, \
                                       causal, s);
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
// dtype 0 = float32, 1 = bfloat16.  Takes any Sq >= 0 and Sk >= 1; needs
// H % KH == 0 and D in {32, 64, 128, 256}; anything else returns
// cudaErrorInvalidValue without launching.  Sq == 0 launches nothing.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int H, int KH, int Sq,
                           int Sk, int D, float scale, int causal,
                           void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq < 0 || Sk <= 0 || H > 65535 ||
      B > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Sq == 0) return 0;
  return launch_dim(dtype == 1, q, k, v, o, B, H, KH, Sq, Sk, D, scale, causal,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
