// Flash attention forward on Hopper's tensor cores (sm_90a): bf16 inputs,
// fp32 accumulation and softmax, bf16 output.
//
// Replaces the TPU kernel repro/kernels/flash_attn/flash.py::
// flash_attention_bhsd (Pallas body `_kernel`) for bf16 inputs; fp32 inputs
// go to flash_attention_tf32x3.cu, which gives fp32 products on the tensor
// cores as three TF32 passes.  It computes the same function on head-major
// layouts:
//
//     q (B, Hq, Sq, hd), k (B, Hkv, Skv, hd), v (B, Hkv, Skv, hdv)
//     s = scale * (q . k), then tanh softcap, then the mask
//         (kj < Skv, causal kj <= qi, window kj > qi - window),
//     o = softmax(s) . v with an online (running max / running sum) softmax,
//
// query head h reading kv head h / (Hq / Hkv) (GQA).  Masked scores are
// -1e30 AND their probabilities are set to 0, as in the Pallas kernel; a
// row that sees no key divides by max(l, 1e-30) and comes out 0.
//
// Bound on this card.  At the main path's shape (B=2, H=32, S=2048,
// hd=hdv=80, causal) the operations bound it: 2 (hd + hdv) per visible
// (query, key) pair, 4.3e10 FLOP, 0.043 ms at the bf16 tensor-core peak;
// q, k, v and o in bf16 once are 83.9 MB, 0.025 ms.  The FMA kernel that ran before
// could at best reach the fp32 figure, 0.64 ms.
//
// Design (FlashAttention-2 on mma.sync).
//
// - One block of 8 warps per (128-row query tile, batch * query head); grid
//   x runs over query tiles from the last to the first, so causal tiles
//   with the most key tiles start first.  Each warp owns 16 query rows.
// - S = Q K^T and O += P V are mma.sync.m16n8k16 bf16 products with fp32
//   accumulators in registers; fragments come from shared memory by
//   ldmatrix (V by ldmatrix.trans).  Shared-memory rows are padded by 16
//   bytes, so ldmatrix reads hit 8 distinct 16-byte bank groups.
// - 64-row K/V tiles are double-buffered by cp.async: the next tile loads
//   while this one is multiplied, with one block barrier per tile.
// - scale and the softcap act on the fp32 S accumulator (products of bf16
//   inputs are exact in fp32, so S is the reference's up to the order of
//   the sum); without a softcap, scale is folded into the exponent, 2^x by
//   one MUFU instruction.  The running max and sum of each row live in the
//   4 lanes that hold it, reduced by shuffles; O is rescaled only when a
//   row maximum moved.
// - P is split into its top 16 bits (bf16 by truncation) and the bf16
//   rounding of the exact remainder, and both go through the PV product:
//   P then carries about 16 bits, so the output keeps the reference's fp32
//   softmax and is rounded to bf16 once.  One bf16 P alone is up to 2^-9
//   off per weight, which can miss the per-element bf16 hold where a
//   row's output is near 0.  Built with -DREPRO_FLASH_P_REMAINDER=0, P is
//   one round-to-nearest bf16 and the remainder product is dropped:
//   scripts/torch_flash_p_split.py builds both and compares their holds
//   and times.
// - Key tiles wholly above the diagonal or outside the window are skipped
//   per block, and per warp inside a block; masks are evaluated only on
//   tiles that cross an edge.
// - Head dims are padded with zeros in shared memory to D, a multiple of 16
//   (exact), with D bucketed in {32, 64, 80, 128, 256} so each
//   instantiation keeps its accumulators in registers.  Rows past Sq and
//   Skv are zero-filled, so callers pass unpadded tensors.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 128;            // query rows per block
constexpr int kBKV = 64;            // key rows per tile
constexpr int kStages = 2;          // K/V tiles in flight (a ring)
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = kBKV / 8;       // n8 tiles of S per warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

#ifndef REPRO_FLASH_P_REMAINDER
#define REPRO_FLASH_P_REMAINDER 1  // P through the PV product as two bf16s
#endif

template <int D>
__host__ __device__ constexpr int stride() { return D + 8; }  // bf16 per smem row

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * stride<D>() * (kBQ + 2 * kStages * kBKV);
}

// 2^x in one MUFU instruction (relative error about 2^-22; exp2f adds
// range handling around it, which costs issue slots on every score)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

#if REPRO_FLASH_P_REMAINDER
// P as two bf16 pairs (first value in the low half): the top 16 bits of
// each float (bf16 by truncation: one byte permute, no conversion), and
// the exact remainder x - top(x) rounded to bf16 (|remainder| < 2^-7 |x|,
// so the pair carries x to about 2^-16 |x|).
__device__ __forceinline__ void split2(float a, float b, uint32_t& top,
                                       uint32_t& rem) {
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  top = __byte_perm(ua, ub, 0x7632);
  __nv_bfloat162 r = __floats2bfloat162_rn(
      a - __uint_as_float(ua & 0xffff0000u),
      b - __uint_as_float(ub & 0xffff0000u));
  rem = *reinterpret_cast<uint32_t*>(&r);
}
#else
// P as one bf16 pair, each rounded to nearest (first value in the low half)
__device__ __forceinline__ uint32_t pack_rn(float a, float b) {
  __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&r);
}
#endif

// rows [r0, r0 + n) of a (rows, w) bf16 matrix into smem rows of D
// (stride<D>()), zero past `rows` and past column w.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int n, int rows, int w, bool vec) {
  constexpr int kChunks = D / 8;
  if (vec) {  // w % 8 == 0 and 16-byte aligned rows: cp.async, zero-fill
    for (int e = threadIdx.x; e < n * kChunks; e += kThreads) {
      const int r = e / kChunks, c = (e % kChunks) * 8;
      const bool in = r0 + r < rows && c < w;
      const __nv_bfloat16* g =
          in ? src + static_cast<long long>(r0 + r) * w + c : src;
      cp_async16(smem_u32(dst + r * stride<D>() + c), g, in);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int e = threadIdx.x; e < n * D; e += kThreads) {
      const int r = e / D, c = e % D;
      dst[r * stride<D>() + c] =
          (r0 + r < rows && c < w)
              ? src[static_cast<long long>(r0 + r) * w + c] : zero;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 80 ? 2 : 1)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int hq, int hkv, int sq,
                     int skv, int hd, int hdv, float scale, int causal,
                     int window, float softcap, int vec) {
  constexpr int S = stride<D>();
  constexpr int kKS = D / 16;   // k-steps of S = Q K^T
  constexpr int kDT = D / 8;    // n8 tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int kSt = kStages;
  __nv_bfloat16* ks = qs + kBQ * S;         // [kSt][kBKV][S]
  __nv_bfloat16* vs = ks + kSt * kBKV * S;  // [kSt][kBKV][S]

  const int nq = (sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int hk = (bh % hq) / (hq / hkv);
  const __nv_bfloat16* qp = q + static_cast<long long>(bh) * sq * hd;
  const __nv_bfloat16* kp = k + static_cast<long long>(b * hkv + hk) * skv * hd;
  const __nv_bfloat16* vp =
      v + static_cast<long long>(b * hkv + hk) * skv * hdv;
  __nv_bfloat16* op = o + static_cast<long long>(bh) * sq * hdv;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qa = q0 + 16 * warp;  // this warp's first row
  const int qb = qa + 15;         // and last

  // key tiles this query tile can see
  const int q_last = min(q0 + kBQ, sq) - 1;
  int j_hi = (skv + kBKV - 1) / kBKV - 1;
  if (causal) j_hi = min(j_hi, q_last / kBKV);
  int j_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) j_lo = (q0 - window + 1) / kBKV;

  // one cp.async group for Q, then one per K/V tile (empty past j_hi, so
  // that the count of groups in flight is the same in every iteration)
  load_tile<D>(qs, qp, q0, kBQ, sq, hd, vec);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < kSt - 1; ++st) {
    if (j_lo + st <= j_hi) {
      load_tile<D>(ks + st * kBKV * S, kp, (j_lo + st) * kBKV, kBKV, skv, hd,
                   vec);
      load_tile<D>(vs + st * kBKV * S, vp, (j_lo + st) * kBKV, kBKV, skv, hdv,
                   vec);
    }
    cp_async_commit();
  }

  float acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  // Without a softcap (and with scale > 0, which keeps the order of the
  // scores) the raw scores are kept and exp(scale (x - m)) is taken as
  // 2^(sl2 (x - m)); otherwise the scores are scaled and capped first.
  const bool raw = softcap <= 0.f && scale > 0.f;
  const float sl2 = (raw ? scale : 1.f) * kLog2e;
  float m[2] = {kNegInf, kNegInf};  // rows g and g + 8
  float l[2] = {0.f, 0.f};          // this lane's part of the row sums

  // ldmatrix lane offsets (elements): A from Q, B from K, B^T from V
  const int a_off = (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * S +
                    8 * (lane >> 4);
  const int k_off = ((lane & 7) + 8 * (lane >> 4)) * S + 8 * ((lane >> 3) & 1);
  const int v_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * S + 8 * (lane >> 4);

  for (int j = j_lo; j <= j_hi; ++j) {
    const int buf = (j - j_lo) % kSt;
    // tile j has landed; after the barrier every warp is done with tile
    // j - 1, whose buffer the load of tile j + kSt - 1 reuses
    cp_async_wait<kSt - 2>();
    __syncthreads();
    if (j + kSt - 1 <= j_hi) {
      const int nb = (j + kSt - 1 - j_lo) % kSt;
      load_tile<D>(ks + nb * kBKV * S, kp, (j + kSt - 1) * kBKV, kBKV, skv,
                   hd, vec);
      load_tile<D>(vs + nb * kBKV * S, vp, (j + kSt - 1) * kBKV, kBKV, skv,
                   hdv, vec);
    }
    cp_async_commit();

    const int k0 = j * kBKV;
    const bool all_masked = (causal && k0 > qb) ||
                            (window > 0 && k0 + kBKV - 1 <= qa - window);
    if (!all_masked) {
      const bool edge = (k0 + kBKV > skv) || (causal && k0 + kBKV - 1 > qa) ||
                        (window > 0 && k0 <= qb - window);
      const __nv_bfloat16* kt = ks + buf * kBKV * S;
      const __nv_bfloat16* vt = vs + buf * kBKV * S;

      float s[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        uint32_t a[4];
        ldsm_x4(smem_u32(qs + a_off + 16 * kk), a);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t bk[4];
          ldsm_x4(smem_u32(kt + k_off + 16 * np * S + 16 * kk), bk);
          mma(s[2 * np], a, bk[0], bk[1]);
          mma(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }

      if (!raw) {  // scaled and capped scores
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float x = s[n][i] * scale;
            if (softcap > 0.f) x = softcap * tanhf(x / softcap);
            s[n][i] = x;
          }
      }
      if (edge) {  // the keys this tile's edge cuts off
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qi = qa + g + 8 * (i >> 1);
            const int kj = k0 + 8 * n + 2 * t + (i & 1);
            bool ok = kj < skv;
            if (causal) ok = ok && kj <= qi;
            if (window > 0) ok = ok && kj > qi - window;
            if (!ok) s[n][i] = kNegInf;
          }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
      float alpha[2], mb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = ex2((m[r] - m_new) * sl2);
        m[r] = m_new;
        // masked scores give 2^(-huge) = 0; a row that has seen no key yet
        // (its max still -1e30) subtracts +inf, so all its p are 0 as well
        mb[r] = m_new == kNegInf ? __int_as_float(0x7f800000) : m_new * sl2;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = ex2(fmaf(s[n][i], sl2, -mb[i >> 1]));
          s[n][i] = p;
          l[i >> 1] += p;
        }
      // once the row maxima settle, most tiles leave every alpha at 1
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          acc[n][0] *= alpha[0];
          acc[n][1] *= alpha[0];
          acc[n][2] *= alpha[1];
          acc[n][3] *= alpha[1];
        }
      }

      // O += P V, P as bf16 plus its bf16 remainder
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        // the C fragments of S tiles 2kk, 2kk + 1 are P's A fragment
        uint32_t ph[4];
#if REPRO_FLASH_P_REMAINDER
        uint32_t pl[4];
        split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#else
        ph[0] = pack_rn(s[2 * kk][0], s[2 * kk][1]);
        ph[1] = pack_rn(s[2 * kk][2], s[2 * kk][3]);
        ph[2] = pack_rn(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        ph[3] = pack_rn(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#endif
#pragma unroll
        for (int dp = 0; dp < kDT / 2; ++dp) {
          uint32_t bv[4];
          ldsm_x4_t(smem_u32(vt + v_off + 16 * kk * S + 16 * dp), bv);
          mma(acc[2 * dp], ph, bv[0], bv[1]);
          mma(acc[2 * dp + 1], ph, bv[2], bv[3]);
#if REPRO_FLASH_P_REMAINDER
          mma(acc[2 * dp], pl, bv[0], bv[1]);
          mma(acc[2 * dp + 1], pl, bv[2], bv[3]);
#endif
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = qa + g + 8 * (i >> 1);
      const int col = 8 * n + 2 * t + (i & 1);
      if (qi < sq && col < hdv)
        op[static_cast<long long>(qi) * hdv + col] =
            __float2bfloat16_rn(acc[n][i] * l[i >> 1]);
    }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int skv, int hd, int hdv, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_mma_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec = hd % 8 == 0 && hdv % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      hq, hkv, sq, skv, hd, hdv, scale, causal, window, softcap,
      static_cast<int>(vec));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound from Python with ctypes.  Pointers are device pointers
// of contiguous bf16 tensors; the caller has checked shapes and devices and
// launches only for non-empty tensors.  window <= 0 means no window,
// softcap <= 0 no softcap.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd_bf16_mma(
    const void* q, const void* k, const void* v, void* o, int b, int hq,
    int hkv, int sq, int skv, int hd, int hdv, float scale, int causal,
    int window, float softcap, void* stream) {
  if (hd < 1 || hd > 256 || hdv < 1 || hdv > 256 || hkv < 1 || hq % hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dmax = hd > hdv ? hd : hdv;
#define REPRO_FLASH_MMA_CASE(D)                                             \
  if (dmax <= D)                                                            \
    return launch<D>(q, k, v, o, b, hq, hkv, sq, skv, hd, hdv, scale,       \
                     causal, window, softcap, s);
  REPRO_FLASH_MMA_CASE(32)
  REPRO_FLASH_MMA_CASE(64)
  REPRO_FLASH_MMA_CASE(80)
  REPRO_FLASH_MMA_CASE(128)
  REPRO_FLASH_MMA_CASE(256)
#undef REPRO_FLASH_MMA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
