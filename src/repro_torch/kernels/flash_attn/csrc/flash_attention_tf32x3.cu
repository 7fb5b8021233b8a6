// Flash attention forward on Hopper's tensor cores (sm_90a): fp32 inputs,
// fp32-accurate products as three TF32 passes, fp32 softmax and output.
//
// Replaces the TPU kernel repro/kernels/flash_attn/flash.py::
// flash_attention_bhsd (Pallas body `_kernel`) for fp32 inputs; bf16 inputs
// go to flash_attention_mma.cu.  It computes the same function on
// head-major layouts:
//
//     q (B, Hq, Sq, hd), k (B, Hkv, Skv, hd), v (B, Hkv, Skv, hdv)
//     s = scale * (q . k), then tanh softcap, then the mask
//         (kj < Skv, causal kj <= qi, window kj > qi - window),
//     o = softmax(s) . v with an online (running max / running sum) softmax,
//
// query head h reading kv head h / (Hq / Hkv) (GQA).  Masked scores are
// -1e30 AND their probabilities are 0, as in the Pallas kernel; a row that
// sees no key divides by max(l, 1e-30) and comes out 0.  Any hd, hdv <= 256,
// any group size, any Sq and Skv.
//
// Bound on this card.  2 (hd + hdv) operations per visible (query, key)
// pair and head, done as three TF32 passes at the 495 TFLOP/s tensor-core
// peak, against q, k, v and o in fp32 read and written once.  At the fp32
// cross-checks' (1, 32, 512, 80), causal: 1.345 GFLOP, three passes 0.0082
// ms, 21.0 MB 0.0063 ms, so the operations bound it at 0.0082 ms (0.0201 ms
// at the 67 TFLOP/s fp32 CUDA-core peak, the FMA kernel's best).  At
// Zamba2's (2, 32, 2048, 80): 42.97 GFLOP, 0.260 ms in three passes (0.641
// at the FMA peak), 167.8 MB 0.050 ms.
//
// Design (FlashAttention-2 on mma.sync.m16n8k8 TF32), point by point
// against the FMA kernel this one replaced:
//
// - Products on the tensor cores.  S = Q K^T and O += P V run on
//   mma.sync.m16n8k8 TF32 with fp32 accumulators.  Each operand v is split
//   into hi = tf32(v) and lo = tf32(v - hi), both rounded to nearest, and a
//   product is lo.hi + hi.lo + hi.hi, the small products first: about 2^-22
//   relative, where one TF32 pass (2^-11) misses fp32's 1e-5 hold
//   (tests/test_torch_flash_tf32x3.py emulates both on the CPU).  The split
//   is ssd_intra_chunk.cu's: a NaN keeps its place in hi, so a NaN in q or k
//   reaches the outputs it reaches in fp32.
// - Fragments, not shared-memory loads, pace the loops.  Each warp owns 16
//   query rows; S (16 x BKV) and O (16 x DV) stay in registers, the row max
//   and sum live in the 4 lanes that hold a row and are reduced by
//   shuffles, and O is rescaled only when a row's max moved.  The k index
//   of a slab is permuted (k = t and t + 4 are adjacent columns 2t, 2t + 1):
//   a thread's Q and K fragment pairs load as one 8-byte word, and the C
//   fragment of S tile n is P's A fragment for keys 8n .. 8n + 7 as it
//   stands in registers (no shuffle, no shared round trip), with V's rows
//   read in the same order.  Strides are padded (q, k: DK + 8, v: DV + 4) so
//   every fragment load hits distinct banks.
// - Staging is asynchronous.  Q and a double-buffered ring of K/V tiles
//   arrive by cp.async, 16 bytes a copy where hd and hdv are multiples of 4
//   and the pointers 16-byte aligned, else 4; the next tile loads while this
//   one is multiplied, with one block barrier a tile.  Rows past Sq and Skv
//   and columns past hd and hdv are zero-filled by the copies (exact), so
//   callers pass unpadded tensors.
// - Occupancy is chosen per head-dim bucket.  (DK, DV) round (hd, hdv) up
//   to a multiple of 8 in {(32, 32), (64, 64), (80, 80), (128, 128), (192,
//   128), (256, 256)}, the first that holds both, so the accumulators stay
//   in registers (140-253 of them, no spills).  Shared memory a block (Q +
//   two K/V stages) and the blocks an SM holds (228 KB of shared memory,
//   64 K registers):
//       (32, 32)    4 warps, 64-key tiles   48.0 KB  3
//       (64, 64)    4 warps, 64-key tiles   88.0 KB  2
//       (80, 80)    8 warps, 64-key tiles  130.0 KB  1
//       (128, 128)  4 warps, 32-key tiles  101.0 KB  2
//       (192, 128)  4 warps, 32-key tiles  133.0 KB  1
//       (256, 256)  8 warps, 16-key tiles  197.5 KB  1
//   At hd 256, Q of 64 rows plus two stages of 64-key K/V tiles would take
//   330 KB; 16-key tiles keep two stages, and 128 query rows a block share
//   each tile across 8 warps, with a second set of S accumulators for the
//   odd k slabs (two n8 tiles alone leave the mma chains waiting).  The
//   hd-80 and MLA buckets and the second S set were picked by
//   scripts/torch_flash_fp32.py --sweep at the shapes the fp32
//   cross-checks launch (PERF.md has the runs).
// - Key tiles wholly above the diagonal or outside the window are skipped
//   per block, and per warp inside a block; masks are evaluated only on
//   tiles that cross an edge.  scale and the softcap act on the fp32 S
//   accumulator; without a softcap, scale is folded into the exponent, 2^x
//   by one MUFU instruction.  Grid x runs over query tiles from the last
//   to the first, so causal tiles with the most key tiles start first.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStages = 2;  // K/V tiles in flight (a ring)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Built with -DREPRO_FLASH_TF32X3_S_SETS=1 or 2 (as
// scripts/torch_flash_fp32.py --sweep does), every bucket takes that many
// accumulator sets for S; by default tiles of fewer than 32 keys take two.
#ifndef REPRO_FLASH_TF32X3_S_SETS
#define REPRO_FLASH_TF32X3_S_SETS 0
#endif

// A head-dim bucket: DK and DV the padded head dims of q.k and of v, WARPS
// warps of 16 query rows, BKV keys a tile, MINB blocks an SM the
// registers are budgeted for (__launch_bounds__).
template <int DK_, int DV_, int WARPS_, int BKV_, int MINB_>
struct Cfg {
  static constexpr int DK = DK_, DV = DV_, WARPS = WARPS_, BKV = BKV_;
  static constexpr int MINB = MINB_;
  static constexpr int BQ = 16 * WARPS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int SQK = DK + 8;  // q, k row stride (≡ 8 mod 16)
  static constexpr int SV = DV + 4;   // v row stride (≡ 4 mod 8)
  static constexpr int NT = BKV / 8;  // n8 tiles of S a warp
  static constexpr int NO = DV / 8;   // n8 tiles of O a warp
  // S's accumulators: with few n8 tiles, the three passes of a k slab
  // wait on each other's results; a second set takes the odd slabs, so
  // twice as many mma chains are in flight
  static constexpr int SSETS = REPRO_FLASH_TF32X3_S_SETS
                                   ? REPRO_FLASH_TF32X3_S_SETS
                                   : (NT < 4 ? 2 : 1);
  static_assert((DK / 8) % SSETS == 0, "S's sets take whole k slabs");
  static constexpr int KTILE = BKV * SQK, VTILE = BKV * SV;
  static constexpr size_t SMEM =
      sizeof(float) * (BQ * SQK + kStages * (KTILE + VTILE));
};

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: what cvt.rna.tf32.f32 gives for every finite v, in two integer
// instructions.  Not for NaN: the add carries a NaN's mantissa into the
// sign bit when its top 11 mantissa bits are set (the card's canonical NaN
// 0x7fffffff among them), and the NaN comes out as ±0.
__device__ __forceinline__ uint32_t tf32_finite(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo + O(2^-22 |v|), hi and lo TF32 values.  A NaN keeps its
// place in hi, so it reaches the products as it would in fp32.  lo needs
// no such care: v − hi is NaN only where hi is NaN or inf (inf − inf),
// and then lo = 0 leaves the product to hi.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = isnan(v) ? 0x7fffffffu : tf32_finite(v);
  lo = tf32_finite(v - __uint_as_float(hi));
}

// c += a (16x8, row) * b (8x8, col), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b in 3xTF32, the small products first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(c, al, bh[0], bh[1]);
  mma(c, ah, bl[0], bl[1]);
  mma(c, ah, bh[0], bh[1]);
}

// 2^x in one MUFU instruction (relative error about 2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES from src to shared dst, or zeros where !full
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool full) {
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(full ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// rows [r0, r0 + N) of a (rows, w) row-major matrix into shared rows of
// COLS columns at stride ss, zero past `rows` and past column w, by
// cp.async (not committed)
template <int N, int COLS, int THREADS>
__device__ __forceinline__ void stage(float* dst, int ss, const float* src,
                                      int r0, int rows, int w, bool vec) {
  if (vec) {  // w % 4 == 0 and 16-byte aligned rows
    constexpr int V = COLS / 4;
    for (int e = threadIdx.x; e < N * V; e += THREADS) {
      const int r = e / V, c = 4 * (e % V);
      const bool in = r0 + r < rows && c < w;
      cp_async<16>(dst + r * ss + c,
                   in ? src + static_cast<long long>(r0 + r) * w + c : src,
                   in);
    }
  } else {
    for (int e = threadIdx.x; e < N * COLS; e += THREADS) {
      const int r = e / COLS, c = e % COLS;
      const bool in = r0 + r < rows && c < w;
      cp_async<4>(dst + r * ss + c,
                  in ? src + static_cast<long long>(r0 + r) * w + c : src,
                  in);
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
flash_fwd_tf32x3_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        int hq, int hkv, int sq, int skv, int hd, int hdv,
                        float scale, int causal, int window, float softcap,
                        int vec) {
  constexpr int NT = C::NT, NO = C::NO;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                         // [BQ][SQK]
  float* ks = qs + C::BQ * C::SQK;          // [kStages][BKV][SQK]
  float* vs = ks + kStages * C::KTILE;      // [kStages][BKV][SV]

  const int nq = (sq + C::BQ - 1) / C::BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * C::BQ;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int hk = (bh % hq) / (hq / hkv);
  const float* qp = q + static_cast<long long>(bh) * sq * hd;
  const float* kp = k + static_cast<long long>(b * hkv + hk) * skv * hd;
  const float* vp = v + static_cast<long long>(b * hkv + hk) * skv * hdv;
  float* op = o + static_cast<long long>(bh) * sq * hdv;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qa = q0 + 16 * warp;  // this warp's first row
  const int qb = qa + 15;         // and last

  // key tiles this query tile can see
  const int q_last = min(q0 + C::BQ, sq) - 1;
  int j_hi = (skv + C::BKV - 1) / C::BKV - 1;
  if (causal) j_hi = min(j_hi, q_last / C::BKV);
  int j_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) j_lo = (q0 - window + 1) / C::BKV;

  auto load_kv = [&](int j, int buf) {
    stage<C::BKV, C::DK, C::THREADS>(ks + buf * C::KTILE, C::SQK, kp,
                                     j * C::BKV, skv, hd, vec);
    stage<C::BKV, C::DV, C::THREADS>(vs + buf * C::VTILE, C::SV, vp,
                                     j * C::BKV, skv, hdv, vec);
  };
  // one cp.async group for Q and the first K/V tile, then one per tile
  stage<C::BQ, C::DK, C::THREADS>(qs, C::SQK, qp, q0, sq, hd, vec);
  if (j_lo <= j_hi) load_kv(j_lo, 0);
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  // Without a softcap (and with scale > 0, which keeps the order of the
  // scores) the raw scores are kept and exp(scale (x - m)) is taken as
  // 2^(sl2 (x - m)); otherwise the scores are scaled and capped first.
  const bool raw = softcap <= 0.f && scale > 0.f;
  const float sl2 = (raw ? scale : 1.f) * kLog2e;
  float m[2] = {kNegInf, kNegInf};  // rows g and g + 8
  float l[2] = {0.f, 0.f};          // this lane's part of the row sums
  // this lane's Q fragment pairs (row g; row g + 8 is 8 rows on), columns
  // 2t, 2t + 1 of each k slab
  const float* qf = qs + (16 * warp + g) * C::SQK + 2 * t;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int buf = (j - j_lo) & 1;
    // tile j has landed; after the barrier every warp is done with tile
    // j - 1, whose buffer the load of tile j + 1 reuses
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 <= j_hi) load_kv(j + 1, buf ^ 1);
    cp_async_commit();

    const int k0 = j * C::BKV;
    const bool all_masked = (causal && k0 > qb) ||
                            (window > 0 && k0 + C::BKV - 1 <= qa - window);
    if (all_masked) continue;
    const bool edge = (k0 + C::BKV > skv) ||
                      (causal && k0 + C::BKV - 1 > qa) ||
                      (window > 0 && k0 <= qb - window);
    const float* kt = ks + buf * C::KTILE;
    const float* vt = vs + buf * C::VTILE;

    // S = Q K^T: the k index t of slab kk is column 8kk + 2t, t + 4 is
    // 8kk + 2t + 1, in A (Q) and B (K) alike
    float sacc[C::SSETS][NT][4];
#pragma unroll
    for (int u = 0; u < C::SSETS; ++u)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sacc[u][n][i] = 0.f;
#pragma unroll 2
    for (int k8 = 0; k8 < C::DK / 8; k8 += C::SSETS) {
#pragma unroll
      for (int u = 0; u < C::SSETS; ++u) {
        const int kk = k8 + u;
        const float2 x0 = *reinterpret_cast<const float2*>(qf + 8 * kk);
        const float2 x1 =
            *reinterpret_cast<const float2*>(qf + 8 * C::SQK + 8 * kk);
        uint32_t ah[4], al[4];  // a0..a3 = (g, t), (g + 8, t), (g, t + 4), ..
        split(x0.x, ah[0], al[0]);
        split(x1.x, ah[1], al[1]);
        split(x0.y, ah[2], al[2]);
        split(x1.y, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 y = *reinterpret_cast<const float2*>(
              kt + (8 * n + g) * C::SQK + 8 * kk + 2 * t);
          uint32_t bh[2], bl[2];
          split(y.x, bh[0], bl[0]);
          split(y.y, bh[1], bl[1]);
          mma3(sacc[u][n], ah, al, bh, bl);
        }
      }
    }
    float(&s)[NT][4] = sacc[0];
#pragma unroll
    for (int u = 1; u < C::SSETS; ++u)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] += sacc[u][n][i];

    if (!raw) {  // scaled and capped scores
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = s[n][i] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          s[n][i] = x;
        }
    }
    if (edge) {  // the keys this tile's edge cuts off
#pragma unroll
      for (int n = 0; n < NT; ++n)
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
    for (int n = 0; n < NT; ++n)
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
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ex2(fmaf(s[n][i], sl2, -mb[i >> 1]));
        s[n][i] = p;
        l[i >> 1] += p;
      }
    // once the row maxima settle, most tiles leave every alpha at 1
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
    }

    // O += P V: S tile kk's C fragment (rows g, g + 8; keys 8kk + 2t,
    // 8kk + 2t + 1) is P's A fragment for k indices t, t + 4, and V's
    // rows 8kk + 2t, 8kk + 2t + 1 are B's
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ah[4], al[4];
      split(s[kk][0], ah[0], al[0]);
      split(s[kk][2], ah[1], al[1]);
      split(s[kk][1], ah[2], al[2]);
      split(s[kk][3], ah[3], al[3]);
      const float* vr = vt + (8 * kk + 2 * t) * C::SV + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bh[2], bl[2];
        split(vr[8 * n], bh[0], bl[0]);
        split(vr[C::SV + 8 * n], bh[1], bl[1]);
        mma3(acc[n], ah, al, bh, bl);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  const bool pairs = hdv % 2 == 0;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qa + g + 8 * r;
      const int col = 8 * n + 2 * t;
      if (qi >= sq || col >= hdv) continue;
      float* dst = op + static_cast<long long>(qi) * hdv + col;
      const float o0 = acc[n][2 * r] * l[r], o1 = acc[n][2 * r + 1] * l[r];
      if (pairs) {
        *reinterpret_cast<float2*>(dst) = make_float2(o0, o1);
      } else {
        dst[0] = o0;
        if (col + 1 < hdv) dst[1] = o1;
      }
    }
}

template <class C>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int skv, int hd, int hdv, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  auto kernel = flash_fwd_tf32x3_kernel<C>;
  if (C::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec = hd % 4 == 0 && hdv % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const dim3 grid((sq + C::BQ - 1) / C::BQ, b * hq);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, sq,
      skv, hd, hdv, scale, causal, window, softcap, static_cast<int>(vec));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound from Python with ctypes.  Pointers are device pointers
// of contiguous float32 tensors; the caller has checked shapes and devices
// and launches only for non-empty tensors.  window <= 0 means no window,
// softcap <= 0 no softcap.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int flash_attention_fwd_f32_tf32x3(
    const void* q, const void* k, const void* v, void* o, int b, int hq,
    int hkv, int sq, int skv, int hd, int hdv, float scale, int causal,
    int window, float softcap, void* stream) {
  if (hd < 1 || hd > 256 || hdv < 1 || hdv > 256 || hkv < 1 || hq % hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_TF32X3_CASE(DK, DV, WARPS, BKV, MINB)                   \
  if (hd <= DK && hdv <= DV)                                                 \
    return launch<Cfg<DK, DV, WARPS, BKV, MINB>>(q, k, v, o, b, hq, hkv, sq, \
                                                 skv, hd, hdv, scale,        \
                                                 causal, window, softcap, s);
  REPRO_FLASH_TF32X3_CASE(32, 32, 4, 64, 2)
  REPRO_FLASH_TF32X3_CASE(64, 64, 4, 64, 2)
  REPRO_FLASH_TF32X3_CASE(80, 80, 8, 64, 1)
  REPRO_FLASH_TF32X3_CASE(128, 128, 4, 32, 2)
  REPRO_FLASH_TF32X3_CASE(192, 128, 4, 32, 1)
  REPRO_FLASH_TF32X3_CASE(256, 256, 8, 16, 1)
#undef REPRO_FLASH_TF32X3_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
