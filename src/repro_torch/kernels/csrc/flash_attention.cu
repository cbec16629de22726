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
// `causal`, s = -1e30 where qpos < kpos, both counted from 0 (the top-left
// corner, also when Sq != Sk); the running max starts at -1e30; the output is
// acc / max(l, 1e-30) in the input's dtype.  Every product and sum is f32
// (FMA on the CUDA cores; no tensor cores, no TF32), so in f32 the kernel
// matches the plain version to rounding.
//
// The TPU kernel walks (b, h, q-block, kv-block) with the kv-block axis
// innermost and sequential, carrying max, denominator and accumulator in
// VMEM scratch.  Here one block of 256 threads owns one (b, h, 64-row q
// tile) and the loop over 64-row KV tiles takes the place of the sequential
// grid axis; the carried state lives in registers.  Thread (ty, tx) = (tid /
// 16, tid % 16) owns query rows ty + 16 i (i < 4) throughout: for the score
// tile it computes columns tx + 16 j (j < 4), for the output tile head dims
// tx + 16 j (j < D / 16).  A row's 64 scores thus sit in the 16 lanes of one
// half-warp, so its max and sum take four xor-shuffles, and the rescale of
// its accumulator by exp(m_old - m_new) needs nothing from another thread.
// Q, K and V tiles are converted to f32 in shared memory (rows padded to D + 1
// floats, so the 16 lanes reading 16 K rows hit 16 banks); the probabilities
// go through shared memory to the P.V product.  KV tiles wholly above the
// diagonal are never loaded; only a tile that crosses it is masked.  Blocks
// take q tiles from the last, so the longest causal rows start first.
//
// Shared memory: (3 * 64 * (D + 1) + 64 * 65) floats, 66 KB at D = 64 and
// 209 KB at D = 256, above the 48 KB a block gets by default: the launch
// opts in with cudaFuncSetAttribute and returns its error if it fails.
//
// Bound: operations.  The causal forward does 4 * B * H * D * S (S + 1) / 2
// flops (about 51.6 G at B=8, H=12, S=2048, D=64: 0.77 ms at 67 TFLOP/s in
// f32) against 134 MB of q, k, v and o (0.04 ms at 3.35 TB/s).  This first
// version does its FMAs on the CUDA cores from scalar shared-memory loads,
// one load for every two FMAs, so shared-memory bandwidth caps it near a
// quarter of the f32 peak.  Not yet done: tensor cores (wgmma) in bf16,
// TMA loads and a pipeline of KV tiles.
//
// The entry point returns the first CUDA error (the attribute call's, else
// cudaGetLastError() after the launch); it launches on the given stream,
// allocates nothing and does not synchronise.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;  // query rows of a block
constexpr int kBK = 64;  // key rows of a tile
constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;

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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBQ * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KH,
                 int Sq, int Sk, float scale, int causal) {
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
  const T* qb = q + ((static_cast<int64_t>(b) * H + h) * Sq + q0) * D;
  const T* kb = k + (static_cast<int64_t>(b) * KH + kh) * Sk * D;
  const T* vb = v + (static_cast<int64_t>(b) * KH + kh) * Sk * D;
  T* ob = o + ((static_cast<int64_t>(b) * H + h) * Sq + q0) * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    Qs[(e / D) * (D + 1) + e % D] = to_f32(qb[e]);
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
    const T* kt = kb + static_cast<int64_t>(k0) * D;
    const T* vt = vb + static_cast<int64_t>(k0) * D;
    for (int e = tid; e < kBK * D; e += kThreads) {
      Ks[(e / D) * (D + 1) + e % D] = to_f32(kt[e]);
      Vs[e] = to_f32(vt[e]);
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
      ob[(ty + 16 * i) * D + tx + 16 * j] = from_f32<T>(acc[i][j] * inv_den);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KH, int Sq, int Sk, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Sq / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, Sq, Sk, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* o, int B,
               int H, int KH, int Sq, int Sk, int D, float scale, int causal,
               cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, KH, Sq, Sk, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KH, Sq, Sk, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KH, Sq, Sk, scale, causal, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, H, KH, Sq, Sk, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
      Sk % kBK != 0 || Sk <= 0 || H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Sq == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(q, k, v, o, B, H, KH, Sq, Sk, D, scale, causal, s);
  if (dtype == 1) {
    return launch_dim<__nv_bfloat16>(q, k, v, o, B, H, KH, Sq, Sk, D, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
