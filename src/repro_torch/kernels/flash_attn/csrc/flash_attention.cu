// Flash attention forward for Hopper (sm_90a): fp32 or bf16 inputs, fp32
// math, output in the input type.
//
// Replaces the TPU kernel repro/kernels/flash_attn/flash.py::
// flash_attention_bhsd (Pallas body `_kernel`).  It computes the same
// function on head-major layouts:
//
//     q (B, Hq, Sq, hd), k (B, Hkv, Skv, hd), v (B, Hkv, Skv, hdv)
//     s = (scale * q) · kᵀ, then tanh softcap, then the mask
//         (kj < Skv, qi < Sq, causal kj <= qi, window kj > qi - window),
//     o = softmax(s) · v with an online (running max / running sum) softmax,
//
// query head h reading kv head h / (Hq / Hkv) (GQA).  As in the Pallas
// kernel, masked scores are -1e30 AND their probabilities are set to 0
// explicitly: a row whose running max is still -1e30 would otherwise give
// exp(0) = 1 to masked keys.  A row that sees no key divides by
// max(l, 1e-30) and comes out 0.
//
// Design.  One thread block per (64-row query tile, batch·query head); the
// grid's x runs over query tiles from the last to the first, so the causal
// tiles with the most key tiles start first.  The query tile is staged in
// shared memory once, scaled; each 64-row key/value tile is staged in
// shared memory (keys transposed), masked at Skv itself, so callers pass
// unpadded tensors of any length.  Key tiles wholly above the diagonal or
// wholly outside the window are skipped (exact: such a tile gives every
// row alpha = 1 and p = 0).  Each of the 256 threads owns 4 query rows and
// every 16th score column / output column: the row max and row sum are
// reduced over the 16 lanes of a half-warp with shuffles, the
// probabilities go through shared memory to the same half-warp only (a
// __syncwarp, not a block barrier), and the output accumulator stays in
// registers.  Any hd, hdv <= 256 and any group size work.
//
// Bound on this card: at the main path's shape (B=2, H=32, S=2048,
// hd=hdv=80, bf16, causal) the operations (2·(hd+hdv) per visible
// (query, key) pair, 4.3e10) bound it: 0.043 ms at the bf16 tensor-core
// peak, 0.64 ms at the fp32 CUDA-core peak; the bytes (q, k, v, o once)
// take 0.025 ms.  This first version does fp32 FMA on the CUDA cores (no
// tensor cores, no TMA), fed from shared memory, so it can at best reach
// the fp32 figure.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;             // query rows per block
constexpr int kBKV = 64;            // key rows per tile
constexpr int kThreads = 256;       // 16 row groups of 4 rows x 16 lanes
constexpr int kKtStride = kBKV + 1;  // transposed keys, padded (banks)
constexpr int kPStride = kBKV + 1;
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

size_t smem_bytes(int hd, int hdv) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (hd + 1) +
                          static_cast<size_t>(hd) * kKtStride +
                          static_cast<size_t>(kBKV) * hdv +
                          static_cast<size_t>(kBQ) * kPStride);
}

// NC = output columns per thread (columns lane, lane + 16, ...): hdv <= 16·NC.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
                 int sq, int skv, int hd, int hdv, float scale, int causal,
                 int window, float softcap) {
  extern __shared__ float smem[];
  const int qstride = hd + 1;
  float* qs = smem;                           // [kBQ][hd + 1]
  float* kt = qs + kBQ * qstride;             // [hd][kKtStride]
  float* vs = kt + hd * kKtStride;            // [kBKV][hdv]
  float* ps = vs + kBKV * hdv;                // [kBQ][kPStride]

  const int nq = (sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int hk = (bh % hq) / (hq / hkv);
  const T* qp = q + static_cast<long long>(bh) * sq * hd;
  const T* kp = k + static_cast<long long>(b * hkv + hk) * skv * hd;
  const T* vp = v + static_cast<long long>(b * hkv + hk) * skv * hdv;
  T* op = o + static_cast<long long>(bh) * sq * hdv;

  const int tid = threadIdx.x;
  const int r0 = (tid / 16) * 4;  // this thread's rows r0 .. r0 + 3
  const int cl = tid % 16;        // its columns cl, cl + 16, ...

  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int r = e / hd, c = e % hd;
    qs[r * qstride + c] =
        (q0 + r < sq) ? to_f32(qp[static_cast<long long>(q0 + r) * hd + c]) *
                            scale
                      : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // key tiles this query tile can see
  const int q_last = min(q0 + kBQ, sq) - 1;
  int j_hi = (skv + kBKV - 1) / kBKV - 1;
  if (causal) j_hi = min(j_hi, q_last / kBKV);
  int j_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) j_lo = (q0 - window + 1) / kBKV;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * kBKV;
    __syncthreads();  // the previous tile's kt, vs are no longer read
    for (int e = tid; e < kBKV * hd; e += kThreads) {
      const int r = e / hd, c = e % hd;
      kt[c * kKtStride + r] =
          (k0 + r < skv) ? to_f32(kp[static_cast<long long>(k0 + r) * hd + c])
                         : 0.f;
    }
    for (int e = tid; e < kBKV * hdv; e += kThreads) {
      const int r = e / hdv, c = e % hdv;
      vs[e] = (k0 + r < skv)
                  ? to_f32(vp[static_cast<long long>(k0 + r) * hdv + c])
                  : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(r0 + i) * qstride + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = kt[d * kKtStride + cl + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + r0 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kj = k0 + cl + 16 * jj;
        float x = s[i][jj];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool valid = kj < skv && qi < sq;
        if (causal) valid = valid && kj <= qi;
        if (window > 0) valid = valid && kj > qi - window;
        ok[jj] = valid;
        s[i][jj] = valid ? x : kNegInf;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = ok[jj] ? expf(s[i][jj] - m_new) : 0.f;
        ps[(r0 + i) * kPStride + cl + 16 * jj] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // rows r0..r0+3 of ps come from this half-warp only

    for (int kk = 0; kk < kBKV; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(r0 + i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = cl + 16 * c;
        const float vv = col < hdv ? vs[kk * hdv + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = cl + 16 * c;
      if (col < hdv)
        store_as(op + static_cast<long long>(qi) * hdv + col,
                 acc[i][c] / denom);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int skv, int hd, int hdv, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd, hdv);
  auto kernel = flash_fwd_kernel<T, NC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, skv, hd, hdv,
      scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hdv(const void* q, const void* k, const void* v, void* o, int b,
                 int hq, int hkv, int sq, int skv, int hd, int hdv,
                 float scale, int causal, int window, float softcap,
                 cudaStream_t stream) {
  const int nc = (hdv + 15) / 16;
#define REPRO_FLASH_CASE(NC)                                                 \
  if (nc <= NC)                                                              \
    return launch<T, NC>(q, k, v, o, b, hq, hkv, sq, skv, hd, hdv, scale,    \
                         causal, window, softcap, stream);
  REPRO_FLASH_CASE(1)
  REPRO_FLASH_CASE(2)
  REPRO_FLASH_CASE(4)
  REPRO_FLASH_CASE(5)
  REPRO_FLASH_CASE(8)
  REPRO_FLASH_CASE(16)
#undef REPRO_FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C interface, bound from Python with ctypes.  Pointers are device pointers
// of contiguous tensors of one type (dtype 0: float32, 1: bfloat16); the
// caller has checked shapes and devices and launches only for non-empty
// tensors.  window <= 0 means no window, softcap <= 0 no softcap.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int b,
                                   int hq, int hkv, int sq, int skv, int hd,
                                   int hdv, float scale, int causal,
                                   int window, float softcap, void* stream) {
  if (hd < 1 || hd > kMaxHeadDim || hdv < 1 || hdv > kMaxHeadDim ||
      hkv < 1 || hq % hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hdv<float>(q, k, v, o, b, hq, hkv, sq, skv, hd, hdv,
                               scale, causal, window, softcap, s);
  if (dtype == 1)
    return dispatch_hdv<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, skv, hd,
                                       hdv, scale, causal, window, softcap,
                                       s);
  return static_cast<int>(cudaErrorInvalidValue);
}
