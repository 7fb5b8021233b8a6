// Mamba2 SSD intra-chunk dual form for Hopper (sm_90a): fp32 in and out,
// the products on the tensor cores in 3xTF32.
//
// Replaces the TPU kernel repro/kernels/ssd/ssd.py::ssd_intra_chunk (Pallas
// body `_kernel`).  For every (batch b, chunk c, head h) it computes, with
// da = dt·a and cs the inclusive prefix sum of da over the chunk's Q rows,
//
//     y_intra[i, :] = Σ_{j<=i} (C_i · B_j) · exp(cs_i − cs_j) · dt_j · x[j, :]
//     state[p, n]   = Σ_k x[k, p] · B[k, n] · exp(cs_{Q−1} − cs_k) · dt_k
//
// on the sequence-major layouts the model keeps: x (B, S, H, P), dt
// (B, S, H), a (H,), B and C (B, S, N) shared by all heads, y_intra
// (B, S, H, P) and states (B, S/Q, H, P, N).  The inter-chunk recurrence
// stays in framework ops (kernels/ssd/ops.py), as in the reference.
//
// Bound on this card.  At the main path's shape (B=2, S=2048, H=80, P=64,
// N=64, Q=256) the bytes bound it: x and y_intra are 84 MB each and the
// states 21 MB, 0.057 ms at 3.35 TB/s.  The work the function needs (the
// lower-triangular M·x and the states per head, the scores C·Bᵀ once per
// chunk) is 8.1 GFLOP: 0.12 ms at the fp32 FMA peak, and 0.049 ms as three
// TF32 passes at the 495 TFLOP/s tensor-core peak.  This design does 11.1
// GFLOP (whole diagonal tiles, scores once per 4 heads), 33 GFLOP of TF32
// products in three passes; mma.sync reaches about 305 TFLOP/s of TF32 on
// an H100 with nothing else to do (scripts/torch_ssd_kernel.py measures
// it), so the products alone take about 0.11 ms.
//
// Design.
//
// - Work is cut into slots of one (b, c, group of kG = 4 heads): one slot
//   per 64-row tile I of the chunk's output, and one more for the group's
//   boundary states.  The slots of one (b, c) are adjacent in the grid, so
//   the blocks that read the same B, C and x rows run together and find
//   them in L2, and the heaviest go first: the last row tile, the states,
//   then the row tiles from last to first.
// - A row-tile block walks the column tiles J <= I.  For each it forms the
//   64x64 score tile S = C_I·B_Jᵀ once, in shared memory, and the group's
//   heads reuse it with their own decay and dt: M_h = S ∘ exp(cs_i − cs_j)
//   ∘ dt_j, the exponential evaluated only where j <= i (above the diagonal
//   cs_i − cs_j can overflow to inf, and inf·0 is NaN), then y_h += M_h·x_J.
//   Two warps per head each own 32 rows of the tile (two m16 tiles), with
//   their 32 x P accumulators in registers across J; M_h is formed and
//   split in the registers that feed the product, and each fragment of x_J
//   feeds both m16 tiles.
// - A state block takes the group's 4 heads at once (2 where N > 64, in two
//   passes), two warps per head, and accumulates (x_J ∘ w)ᵀ·B_J over the
//   chunk's column tiles, with the decay-to-end weights w_k = exp(cs_{Q−1}
//   − cs_k)·dt_k applied to x's fragments.
// - All three products run on mma.sync.m16n8k8 TF32 with fp32
//   accumulators.  Each operand v is split into hi = tf32(v) and lo =
//   tf32(v − hi), both rounded to nearest, and the product is lo·hi +
//   hi·lo + hi·hi: about 2^-22 relative per product, where one TF32 pass
//   (2^-11) misses the 1e-4 hold that the fp32 path is held to
//   (tests/test_torch_ssd_mamba2.py emulates both on the CPU).  The k
//   index of a slab is permuted (k = t and t + 4 are adjacent columns 2t, 2t + 1), so
//   a thread's fragment pairs are adjacent in S, cs, dt and w and load as
//   one 8-byte word; strides are padded so that every fragment load hits
//   32 distinct banks.
// - Tiles arrive by cp.async (16 bytes a thread where P and N are
//   multiples of 4 and the pointers 16-byte aligned, else 4), double-
//   buffered: the next column tile loads while this one is multiplied.
//   Where two stages do not fit in shared memory (wide N or long chunks),
//   the row tiles keep one and start each tile's copies at once.  dt comes
//   by cp.async too, ahead of the first tiles, so the prefix sums run while
//   those arrive.
// - The prefix sums cs (in units of log2 e, so that exp is one ex2) are a
//   block scan: two warps per head, consecutive rows per thread, a shuffle
//   scan, then the second warp adds the first one's total.  The order of
//   additions differs from torch.cumsum, so results agree to ~1e-5
//   relative where |cs| ~ 1e2.  Rows past Q are zero-filled (dt = 0, so cs
//   holds its last value), columns past P and N are zero-filled, and the
//   last group's heads past H are skipped: any Q <= 1024, P <= 64,
//   N <= 128 and H work.
#include <cuda_runtime.h>

#include <cstdint>

// Built with -DREPRO_SSD_PHASES=1 (as scripts/torch_ssd_kernel.py does),
// thread 0 of every block adds the clock64() cycles of its phases to
// ssd_phase_cycles[row blocks | state blocks][phase], which
// ssd_intra_chunk_phases reads back; by default the probes are empty.
// They are there for this kernel's next step, blocks that stay resident
// and prefetch their next work item (resident prefetching blocks, ROADMAP
// queue 2b), which is to hide the block start and the tile waits these
// counters measure.
#ifndef REPRO_SSD_PHASES
#define REPRO_SSD_PHASES 0
#endif
#if REPRO_SSD_PHASES
__device__ unsigned long long ssd_phase_cycles[2][8];
#define PHASE_CLOCK(t) const long long t = clock64()
#define PHASE_ADD(kind, i, t0, t1)                          \
  if (threadIdx.x == 0)                                     \
  atomicAdd(&ssd_phase_cycles[kind][i],                     \
            static_cast<unsigned long long>((t1) - (t0)))
#else
#define PHASE_CLOCK(t)
#define PHASE_ADD(kind, i, t0, t1)
#endif

namespace {

constexpr int kT = 64;               // rows of a row tile and a column tile
constexpr int kG = 4;                // heads that share one score tile
constexpr int kWarps = 2 * kG;       // two per head, 32 tile rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kSS = kT + 8;          // score tile stride (≡ 8 mod 32)
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxQ = 1024;
constexpr int kMaxSmem = 232448 - 1024;  // dynamic shared memory per block
constexpr float kLog2e = 1.4426950408889634f;

// NP: n8 tiles of P (4 for P <= 32, 8 for P <= 64); NN: N is padded to
// NS = 16·NN columns (NN = 2, 4 or 8 for N <= 32, 64, 128).
template <int NP, int NN>
struct Dims {
  static constexpr int PW = 8 * NP;     // padded P
  static constexpr int NS = 16 * NN;    // padded N (32, 64 or 128)
  static constexpr int XS = PW + 4;     // x tile stride (≡ 4 mod 32)
  static constexpr int CS = NS + 4;     // C_I, B_J stride (≡ 4 mod 32)
  // the state product of one head over 2 warps (4 heads at once), or over
  // 4 where N > 64 (2 heads at once), so a warp holds at most 32 x 64
  static constexpr int kStateWarpsPerHead = NN == 8 ? 4 : 2;
  // floats of one row-tile stage (B_J, the kG heads' x_J), of the fixed
  // row-tile part (C_I, S) and of one state stage (B_J, x_J of the heads
  // taken at once)
  static constexpr int kRowStage = kT * CS + kG * kT * XS;
  static constexpr int kRowFixed = kT * CS + kT * kSS;
  static constexpr int kStateStage =
      kT * CS + (kWarps / kStateWarpsPerHead) * kT * XS;
  static size_t smem_bytes(int qp, int row_stages) {
    const int row = kRowFixed + row_stages * kRowStage;
    const int state = 2 * kStateStage;
    return sizeof(float) *
           (2 * static_cast<size_t>(kG) * qp + (row > state ? row : state));
  }
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Args {
  const float* x;
  const float* dt;
  const float* a;
  const float* bm;
  const float* cm;
  float* y;
  float* st;
  int seq, nh, hp, nst, q, nc, nt, ngroups;
  int vec;         // 16-byte copies
  int row_stages;  // 1 or 2
};

// rows [r0, r0 + kT) of a row-major matrix with row stride `ld` into a
// shared tile of COLS columns and stride `ss`, zero past `nrows` rows and
// `width` columns, by cp.async (not committed)
template <int COLS>
__device__ __forceinline__ void stage(float* dst, int ss, const float* src,
                                      long long ld, int r0, int nrows,
                                      int width, bool vec) {
  if (vec) {
    constexpr int V = COLS / 4;
    for (int e = threadIdx.x; e < kT * V; e += kThreads) {
      const int r = e / V, col = 4 * (e % V);
      const bool in = r0 + r < nrows && col < width;
      cp_async<16>(dst + r * ss + col, in ? src + (r0 + r) * ld + col : src,
                   in);
    }
  } else {
    for (int e = threadIdx.x; e < kT * COLS; e += kThreads) {
      const int r = e / COLS, col = e % COLS;
      const bool in = r0 + r < nrows && col < width;
      cp_async<4>(dst + r * ss + col, in ? src + (r0 + r) * ld + col : src,
                  in);
    }
  }
}

// dt of the group's heads h0 .. h0 + kG − 1, rows [0, qp), into dt_s[k][i]
// by cp.async (not committed); zero past Q and past H
__device__ __forceinline__ void load_dt(const Args& p, long long row0, int h0,
                                        float* dt_s, int qp) {
  for (int e = threadIdx.x; e < kG * qp; e += kThreads) {
    const int i = e / kG, k = e % kG;
    const bool in = i < p.q && h0 + k < p.nh;
    cp_async<4>(dt_s + k * qp + i,
                in ? p.dt + (row0 + i) * p.nh + h0 + k : p.dt, in);
  }
}

// the prefix sum cs of dt·a·log2(e) over the chunk for the group's heads
// (so exp(cs_i − cs_j) is one ex2), from dt_s: two warps scan each head.
// A thread adds its qp/64 consecutive rows, a shuffle scan joins the
// threads of a warp, and the second warp adds the first one's total.
// Padded rows and heads past H have dt = 0, so cs holds its last value.
__device__ void prefix_sums(const Args& p, int h0, float* cs_s,
                            const float* dt_s, int qp) {
  static_assert(kThreads == 64 * kG, "two warps scan each head");
  __shared__ float warp_total[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k = threadIdx.x / 64, rows = qp / 64;
  const int i0 = (threadIdx.x % 64) * rows;
  const float av = h0 + k < p.nh ? p.a[h0 + k] * kLog2e : 0.f;
  float* cs = cs_s + k * qp + i0;
  const float* d = dt_s + k * qp + i0;
  float run = 0.f;
  for (int i = 0; i < rows; ++i) {
    run += d[i] * av;
    cs[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  const float excl = incl - run + (warp & 1 ? warp_total[warp - 1] : 0.f);
  for (int i = 0; i < rows; ++i) cs[i] += excl;
}

template <int NP, int NN>
__device__ void row_tile(const Args& p, int b, int c, int h0, int it,
                         float* cs_s, float* dt_s, float* sm, int qp) {
  using D = Dims<NP, NN>;
  float* ct = sm;                 // [kT][CS]   C rows of tile I
  float* s = ct + kT * D::CS;     // [kT][kSS]  scores C_I·B_Jᵀ
  float* stages = s + kT * kSS;   // per stage: B_J [kT][CS], x_J [kG][kT][XS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int gh = warp % kG;       // head h0 + gh; score columns 16·gh ..
  const int r0 = 32 * (warp / kG);  // tile rows r0 .. r0 + 31
  const bool live = h0 + gh < p.nh;
  const long long row0 = static_cast<long long>(b) * p.seq + c * p.q;
  const long long xrow = static_cast<long long>(p.nh) * p.hp;
  const int i0 = it * kT;
  const bool vec = p.vec;
  PHASE_CLOCK(t_start);

  auto load = [&](int jt, int buf) {
    float* bt = stages + buf * D::kRowStage;
    float* xs = bt + kT * D::CS;
    stage<D::NS>(bt, D::CS, p.bm + row0 * p.nst, p.nst, jt * kT, p.q, p.nst,
                 vec);
    for (int k = 0; k < kG; ++k) {
      const bool on = h0 + k < p.nh;
      stage<D::PW>(xs + k * kT * D::XS, D::XS,
                   on ? p.x + row0 * xrow + static_cast<long long>(h0 + k) *
                                                p.hp
                      : p.x,
                   xrow, jt * kT, on ? p.q : 0, p.hp, vec);
    }
  };
  load_dt(p, row0, h0, dt_s, qp);
  cp_async_commit();
  stage<D::NS>(ct, D::CS, p.cm + row0 * p.nst, p.nst, i0, p.q, p.nst, vec);
  load(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // dt; the tiles may still be on their way
  __syncthreads();
  prefix_sums(p, h0, cs_s, dt_s, qp);
  __syncthreads();
  PHASE_CLOCK(t_prologue);
  PHASE_ADD(0, 0, t_start, t_prologue);

  float acc[2][NP][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][n][k] = 0.f;
  // this thread's rows: (m16 tile, upper / lower 8) -> tile row, cs
  int rows[2][2];
  float csr[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      rows[mt][u] = r0 + 16 * mt + g + 8 * u;
      csr[mt][u] = cs_s[gh * qp + i0 + rows[mt][u]];
    }
  const float* csh = cs_s + gh * qp;
  const float* dth = dt_s + gh * qp;
  const int nk = (p.nst + 7) / 8;

  for (int jt = 0; jt <= it; ++jt) {
    PHASE_CLOCK(t_step);
    const int buf = p.row_stages == 2 ? jt & 1 : 0;
    if (p.row_stages == 2 && jt < it) {
      load(jt + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    PHASE_CLOCK(t_ready);
    PHASE_ADD(0, 1, t_step, t_ready);
    const float* bt = stages + buf * D::kRowStage;
    const float* xh = bt + kT * D::CS + gh * kT * D::XS;
    const int j0 = jt * kT;

    // S = C_I·B_Jᵀ: this warp's row tiles, columns 16·gh .. (two n8 tiles)
    {
      float sc[2][2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int k = 0; k < 4; ++k) sc[mt][n][k] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < nk; ++kk) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* ca = ct + rows[mt][0] * D::CS + 8 * kk + t;
          split(ca[0], ah[mt][0], al[mt][0]);
          split(ca[8 * D::CS], ah[mt][1], al[mt][1]);
          split(ca[4], ah[mt][2], al[mt][2]);
          split(ca[8 * D::CS + 4], ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float* bb = bt + (16 * gh + 8 * n + g) * D::CS + 8 * kk + t;
          uint32_t bh[2], bl[2];
          split(bb[0], bh[0], bl[0]);
          split(bb[4], bh[1], bl[1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma3(sc[mt][n], ah[mt], al[mt], bh, bl);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float* sp = s + rows[mt][0] * kSS + 16 * gh + 8 * n + 2 * t;
          *reinterpret_cast<float2*>(sp) =
              make_float2(sc[mt][n][0], sc[mt][n][1]);
          *reinterpret_cast<float2*>(sp + 8 * kSS) =
              make_float2(sc[mt][n][2], sc[mt][n][3]);
        }
    }
    __syncthreads();
    PHASE_CLOCK(t_scores);
    PHASE_ADD(0, 2, t_ready, t_scores);

    // y_h += M_h·x_J for this warp's head and 32 rows
    if (live) {
      const bool diag = jt == it;
#pragma unroll 2
      for (int kk = 0; kk < kT / 8; ++kk) {
        // the k index t of a slab is tile column jl, k index t + 4 is
        // jl + 1 (any order of k serves, if A and B agree): a0/a2 and
        // a1/a3 are then adjacent in S, and cs, dt pairs too
        const int jl = 8 * kk + 2 * t;
        const float2 csj = *reinterpret_cast<const float2*>(csh + j0 + jl);
        const float2 dtj = *reinterpret_cast<const float2*>(dth + j0 + jl);
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            // a0..a3 = rows (g, g + 8, g, g + 8), columns (jl, jl, jl + 1,
            // jl + 1)
            const int r = rows[mt][u];
            const float2 sv =
                *reinterpret_cast<const float2*>(s + r * kSS + jl);
            const float m0 = (diag && jl > r)
                                 ? 0.f
                                 : sv.x * (ex2(csr[mt][u] - csj.x) * dtj.x);
            const float m1 = (diag && jl + 1 > r)
                                 ? 0.f
                                 : sv.y * (ex2(csr[mt][u] - csj.y) * dtj.y);
            split(m0, ah[mt][u], al[mt][u]);
            split(m1, ah[mt][2 + u], al[mt][2 + u]);
          }
        const float* xb = xh + jl * D::XS + g;
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          uint32_t bh[2], bl[2];
          split(xb[8 * n], bh[0], bl[0]);
          split(xb[D::XS + 8 * n], bh[1], bl[1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma3(acc[mt][n], ah[mt], al[mt], bh, bl);
        }
      }
    }
    PHASE_CLOCK(t_mx);
    PHASE_ADD(0, 3, t_scores, t_mx);
    __syncthreads();  // this stage and s are no longer read
    PHASE_CLOCK(t_end);
    PHASE_ADD(0, 4, t_mx, t_end);
    if (p.row_stages == 1 && jt < it) {
      load(jt + 1, 0);
      cp_async_commit();
    }
  }

  PHASE_CLOCK(t_done);
  PHASE_ADD(0, 5, t_start, t_done);
  PHASE_ADD(0, 6, 0, 1);
  if (!live) return;
  float* yh = p.y + row0 * xrow + static_cast<long long>(h0 + gh) * p.hp;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + rows[mt][u];
      if (i >= p.q) continue;
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        const int pc = 8 * n + 2 * t;
        float* yp = yh + i * xrow + pc;
        const float v0 = acc[mt][n][2 * u], v1 = acc[mt][n][2 * u + 1];
        if (pc + 1 < p.hp && p.hp % 2 == 0) {
          *reinterpret_cast<float2*>(yp) = make_float2(v0, v1);
        } else {
          if (pc < p.hp) yp[0] = v0;
          if (pc + 1 < p.hp) yp[1] = v1;
        }
      }
    }
}

template <int NP, int NN>
__device__ void state_tile(const Args& p, int b, int c, int h0, float* cs_s,
                           float* w_s, float* sm, int qp) {
  using D = Dims<NP, NN>;
  constexpr int WPH = D::kStateWarpsPerHead;
  constexpr int HPP = kWarps / WPH;            // heads per pass
  constexpr int NCOL = D::NS / (WPH / 2);      // state columns per warp
  constexpr int NT = NCOL / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int hw = warp / WPH;                   // head of the pass
  const int p0 = 32 * (warp % 2);              // state rows p = p0 .. p0 + 31
  const int n0 = NCOL * (warp % WPH / 2);      // state columns n = n0 ..
  const long long row0 = static_cast<long long>(b) * p.seq + c * p.q;
  const long long xrow = static_cast<long long>(p.nh) * p.hp;
  const int heads = min(kG, p.nh - h0);
  const int passes = (heads + HPP - 1) / HPP;
  PHASE_CLOCK(t_start);

  // item = (pass, column tile): B_J and x_J of the pass's heads
  auto load = [&](int item, int buf) {
    float* bs = sm + buf * D::kStateStage;
    float* xs = bs + kT * D::CS;
    const int j0 = item % p.nt * kT, hp0 = h0 + item / p.nt * HPP;
    stage<D::NS>(bs, D::CS, p.bm + row0 * p.nst, p.nst, j0, p.q, p.nst,
                 p.vec);
    for (int k = 0; k < HPP; ++k) {
      const bool on = hp0 + k < p.nh;
      stage<D::PW>(xs + k * kT * D::XS, D::XS,
                   on ? p.x + row0 * xrow +
                            static_cast<long long>(hp0 + k) * p.hp
                      : p.x,
                   xrow, j0, on ? p.q : 0, p.hp, p.vec);
    }
  };
  const int items = passes * p.nt;
  load_dt(p, row0, h0, w_s, qp);
  cp_async_commit();
  load(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // dt; the tiles may still be on their way
  __syncthreads();
  prefix_sums(p, h0, cs_s, w_s, qp);
  __syncthreads();
  // dt -> the decay-to-end weights w_k = exp(cs_{Q−1} − cs_k)·dt_k, in place
  for (int i = threadIdx.x; i < kG * qp; i += kThreads) {
    const float* cs = cs_s + (i / qp) * qp;
    w_s[i] = ex2(cs[p.q - 1] - cs_s[i]) * w_s[i];
  }
  PHASE_CLOCK(t_prologue);
  PHASE_ADD(1, 0, t_start, t_prologue);

  float sacc[2][NT][4];
  for (int item = 0; item < items; ++item) {
    PHASE_CLOCK(t_step);
    const int pass = item / p.nt, jt = item % p.nt;
    const int gh = pass * HPP + hw;            // head h0 + gh
    const bool live = p0 < D::PW && h0 + gh < p.nh;
    if (jt == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[mt][n][e] = 0.f;
    }
    if (item + 1 < items) {
      load(item + 1, (item + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // (the first time, also the weights)
    PHASE_CLOCK(t_ready);
    PHASE_ADD(1, 1, t_step, t_ready);
    if (live) {
      const float* bs = sm + (item & 1) * D::kStateStage;
      const float* xs = bs + kT * D::CS + hw * kT * D::XS;
      const float* w = w_s + gh * qp + jt * kT;
#pragma unroll 2
      for (int kk = 0; kk < kT / 8; ++kk) {
        // A = (x_J ∘ w)ᵀ (rows p, columns k), B = B_J (rows k, columns n);
        // k indices t, t + 4 are tile rows jl, jl + 1, as in M·x
        const int jl = 8 * kk + 2 * t;
        const float2 wj = *reinterpret_cast<const float2*>(w + jl);
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* xa = xs + jl * D::XS + p0 + 16 * mt + g;
          split(xa[0] * wj.x, ah[mt][0], al[mt][0]);
          split(xa[8] * wj.x, ah[mt][1], al[mt][1]);
          split(xa[D::XS] * wj.y, ah[mt][2], al[mt][2]);
          split(xa[D::XS + 8] * wj.y, ah[mt][3], al[mt][3]);
        }
        const float* bb = bs + jl * D::CS + n0 + g;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bh[2], bl[2];
          split(bb[8 * n], bh[0], bl[0]);
          split(bb[D::CS + 8 * n], bh[1], bl[1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma3(sacc[mt][n], ah[mt], al[mt], bh, bl);
        }
      }
    }
    PHASE_CLOCK(t_mma);
    PHASE_ADD(1, 2, t_ready, t_mma);
    __syncthreads();  // this stage is no longer read
    PHASE_CLOCK(t_end);
    PHASE_ADD(1, 3, t_mma, t_end);

    if (jt == p.nt - 1 && live) {
      float* sp = p.st + ((static_cast<long long>(b) * p.nc + c) * p.nh +
                          h0 + gh) * static_cast<long long>(p.hp) * p.nst;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int pr = p0 + 16 * mt + g + (e < 2 ? 0 : 8);
            const int pc = n0 + 8 * n + 2 * t + (e & 1);
            if (pr < p.hp && pc < p.nst)
              sp[static_cast<long long>(pr) * p.nst + pc] = sacc[mt][n][e];
          }
    }
  }
  PHASE_CLOCK(t_done);
  PHASE_ADD(1, 5, t_start, t_done);
  PHASE_ADD(1, 6, 0, 1);
}

template <int NP, int NN>
__global__ void __launch_bounds__(kThreads, 1)
ssd_intra_chunk_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  const int qp = p.nt * kT;
  float* cs_s = smem;             // [kG][qp] prefix sums of dt·a
  float* dt_s = cs_s + kG * qp;   // [kG][qp] dt (state blocks: weights)
  float* rest = dt_s + kG * qp;

  // the slots of one (b, c) are adjacent, heaviest first: rank 0 the last
  // row tile, 1 the states, r >= 2 row tile nt − r; groups fastest
  const int per_bc = (p.nt + 1) * p.ngroups;
  const int bc = blockIdx.x / per_bc;
  const int rank = blockIdx.x % per_bc / p.ngroups;
  const int grp = blockIdx.x % p.ngroups;
  const int c = bc % p.nc, b = bc / p.nc;
  const int h0 = grp * kG;

  if (rank == 1)
    state_tile<NP, NN>(p, b, c, h0, cs_s, dt_s, rest, qp);
  else
    row_tile<NP, NN>(p, b, c, h0, rank == 0 ? p.nt - 1 : p.nt - rank, cs_s,
                     dt_s, rest, qp);
}

template <int NP, int NN>
int launch(Args p, int bsz, cudaStream_t stream) {
  using D = Dims<NP, NN>;
  const int qp = p.nt * kT;
  p.row_stages = D::smem_bytes(qp, 2) <= kMaxSmem ? 2 : 1;
  const size_t smem = D::smem_bytes(qp, p.row_stages);
  auto kernel = ssd_intra_chunk_kernel<NP, NN>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks =
      static_cast<long long>(p.nt + 1) * bsz * p.nc * p.ngroups;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// C interface, bound from Python with ctypes.  Pointers are device pointers
// of contiguous float32 tensors; the caller has checked shapes and devices,
// seq % q == 0, and launches only for non-empty tensors.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ssd_intra_chunk_f32(const float* x, const float* dt,
                                   const float* a, const float* bm,
                                   const float* cm, float* y, float* st,
                                   int bsz, int seq, int nh, int hp, int nst,
                                   int q, void* stream) {
  if (q < 1 || q > kMaxQ || seq % q || hp < 1 || hp > kMaxP || nst < 1 ||
      nst > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{x, dt, a, bm, cm, y, st, seq, nh, hp, nst, q};
  p.nc = seq / q;
  p.nt = (q + kT - 1) / kT;
  p.ngroups = (nh + kG - 1) / kG;
  p.vec = hp % 4 == 0 && nst % 4 == 0 && aligned16(x) && aligned16(bm) &&
          aligned16(cm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool p32 = hp <= 32;
  const int nn = nst <= 32 ? 2 : (nst <= 64 ? 4 : 8);
#define REPRO_SSD_CASE(NP, NN)      \
  if ((NP == 4) == p32 && nn == NN) \
    return launch<NP, NN>(p, bsz, s);
  REPRO_SSD_CASE(4, 2)
  REPRO_SSD_CASE(4, 4)
  REPRO_SSD_CASE(4, 8)
  REPRO_SSD_CASE(8, 2)
  REPRO_SSD_CASE(8, 4)
  REPRO_SSD_CASE(8, 8)
#undef REPRO_SSD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

#if REPRO_SSD_PHASES
// the phase counters into cycles[2][8], or zeroes them (reset != 0)
extern "C" int ssd_intra_chunk_phases(unsigned long long* cycles, int reset) {
  if (reset) {
    const unsigned long long zero[2][8] = {};
    return static_cast<int>(
        cudaMemcpyToSymbol(ssd_phase_cycles, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(cycles, ssd_phase_cycles,
                                               sizeof(ssd_phase_cycles)));
}
#endif
