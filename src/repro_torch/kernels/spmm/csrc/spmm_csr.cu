// Nonzero-balanced SpMM for full-graph GNN aggregation, written for Hopper
// (sm_90a): fp32 values, h and out in fp32 or bf16, fp32 sums.
//
// Replaces the TPU kernel repro/kernels/spmm/spmm.py::spmm_block_sparse
// (Pallas body `_kernel`).  It computes the same function,
//
//     out[r] = sum over k with block_rows[k] == r of  blocks[k] @ h[block_cols[k]]
//
// but reads the tiles in a compressed form that kernels/spmm/ops.py derives
// from them once, at upload time: per destination row a range of
// (global source index, value) pairs holding exactly the tiles' nonzero
// entries (row_ptr / col_idx / vals).  Skipping a zero entry is exact, so
// the sum is the tiles' sum; all-zero padding tiles contribute no entry.
//
// Bound on this card.  At the GCN path's shape (a chunk of 5 760 rows over
// 23 040 sources, about 250 000 nonzeros, d = 41) the work is 0.02 GFLOP
// and the bytes are the nonzeros (8 B each), the row pointers, h read once
// and out written once: about 6.7 MB, 2 us at 3.35 TB/s.  The dense tiles
// the TPU kernel reads are 99.8 % zeros (535.6 MB a chunk at bs = 128), so
// the earlier tile kernel could not get under 0.16 ms whatever its code.
// Tensor cores and TMA buy nothing at that fill: each nonzero is one
// multiply-add per feature column, and the cost is the gather of its
// source row, which comes from the 50 MB L2 (h is 3.8 MB).  The default
// GCN path (core/agg.py::csr_plan, rows derived from the chunked edge
// lists) runs it at Reddit's size: a chunk of 58 244 rows over 232 976
// sources, 28.8 M nonzeros, 279 MB at d = 41, 0.083 ms at 3.35 TB/s; the
// kernel takes about 2 ms there, bound by the latency of its row gathers
// (PERF.md has the times).
//
// Design.  The degree skew is large (in-degree 43 on average, 3 712 at the
// most), so a warp per destination row would leave one warp walking 3 712
// gathers while the card idles.  The work is split by nonzeros instead:
// warp s owns the segment [s*kSeg, (s+1)*kSeg) of the nonzeros and the
// rows that start inside it (an empty row belongs to the segment that holds
// its start; rows starting at nnz to the last segment).  The lanes load the
// segment's (index, value) pairs once, coalesced, and pass them by
// shuffle.  The warp walks the segment's nonzeros as one stream, kUnroll
// source rows in flight at a time whatever the row lengths; for each one
// the 32 lanes read its columns (lane, lane + 32, ...) from L2 and add them
// into registers, closing a row wherever its end pointer (read 32 at a
// time, coalesced) is reached.  A row that ends inside the segment is
// stored directly.  A row that runs past the segment's end leaves its
// partial sum in carry[s] and raises flag[s]; at most one row does per
// segment.  The segment in which such a row ends adds, after its own work,
// carry[s0] + ... + carry[s - 1] + its own part, in that order, and stores
// the row.  There is no float atomic: the result is bitwise the same from
// run to run, and a 3 712-entry row costs 3 712 / kSeg warps spread across
// the card.  A segment waits only on lower-numbered ones, and blocks take
// their numbers from an atomic counter in the order they start, so every
// segment waited on has started and cannot be waiting itself (its flag
// does not depend on any wait).  The closing segment checks 32 flags a
// round and then reads the parts with independent loads, so the longest
// row's closer waits about one flag round trip, not one per part.  The C
// entry point zeroes the counter and the flags on the launch's stream
// before every launch, so no launch depends on what an earlier one left.
// Columns >= d are masked, so any d works; y-tiles of 32 * NC columns
// cover wider d.
//
// Narrow rows.  Tensor parallelism hands each rank a slice of the
// feature columns (11 of 44 on four cards), and with one lane a column
// two thirds of every gather's lanes would idle.  For d <= 16 the warp
// is cut into G = 32 / L groups of L lanes, L the power of two >= d, and
// each group gathers its own nonzero of the stream, so a warp has G
// source rows in flight per load.  Each group keeps a partial sum of the
// row being summed; where a row ends, the groups whose nonzeros belong to
// it add theirs in, and a butterfly of shuffles over the groups (a fixed
// order) gives every lane the row's sum, which group 0 stores or hands on
// as above.  The segments, the carry and the flags are the wide path's,
// so the result is as deterministic; for d > 16 the instructions are the
// ones the kernel had before.
//
// Types.  The kernel is a template on the element type T of h and out:
// float, or __nv_bfloat16 (the one-shot entry point's bf16 features).  A
// bf16 element is widened to fp32 exactly as it is loaded, every sum (the
// carried parts of straddling rows too) is fp32, and a row is rounded to T
// once, to nearest even, as it is stored.  The TPU kernel rounds its
// output block after each tile's product; one rounding of the whole sum is
// at least as close to the exact sum.  At T = float the instructions are
// the ones the fp32-only kernel had.  A bf16 h halves the gathered bytes
// but, the gathers being latency-bound, is no faster than fp32 on the card
// (PERF.md has the times).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 64;            // nonzeros per warp segment
constexpr int kPer = kSeg / 32;     // nonzeros each lane loads
constexpr int kWarps = 8;           // segments per thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;          // source rows loaded before adding
constexpr unsigned kFull = 0xffffffffu;

// First index i in [0, n) with a[i] >= v (n if none), a non-decreasing:
// the warp tests 32 evenly spaced points a round, so 23 040 rows take
// three rounds and a final one instead of 15 dependent loads.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a,
                                                int n, int v, int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int idx = lo + lane * step;
    const int cnt =
        __popc(__ballot_sync(kFull, idx < hi && __ldg(a + idx) < v));
    if (cnt == 0) return lo;
    const int new_hi = min(lo + cnt * step, hi);
    lo += (cnt - 1) * step + 1;
    hi = new_hi;
  }
  const int idx = lo + lane;
  return lo + __popc(__ballot_sync(kFull, idx < hi && __ldg(a + idx) < v));
}

// an element of h as fp32: a bf16 value's 16 bits are the top half of its
// fp32 value, so the widening is exact.  The bf16 element is a plain
// 16-bit load: of the forms tried on the card (this one, through the
// read-only path, as an L2-only load, and as the aligned 32-bit word
// holding it), it was the fastest
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  const unsigned short bits = *reinterpret_cast<const unsigned short*>(p);
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int NC, typename T>
__device__ __forceinline__ void store_row(T* dst, int d, int c0, int lane,
                                          const float (&acc)[NC]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = c0 + lane + 32 * c;
    if (col < d) put(dst + col, acc[c]);
  }
}

template <int NC, typename T>
__global__ void __launch_bounds__(kThreads)
spmm_csr_kernel(const int* __restrict__ row_ptr,
                const int* __restrict__ col_idx,
                const float* __restrict__ vals, int n_rows,
                const T* __restrict__ h, int d, T* __restrict__ out,
                float* carry, int* flags, int n_seg_cap, int n_xblocks) {
  __shared__ int vblock;
  if (threadIdx.x == 0) vblock = atomicAdd(flags, 1);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int y = vblock / n_xblocks;
  const int s = (vblock % n_xblocks) * kWarps + (threadIdx.x >> 5);
  const int c0 = y * 32 * NC;
  const int nnz = __ldg(row_ptr + n_rows);
  const int n_seg = max((nnz + kSeg - 1) / kSeg, 1);
  if (s >= n_seg) return;
  const int seg0 = s * kSeg;
  const int seg1 = min(seg0 + kSeg, nnz);
  const bool last = s == n_seg - 1;
  float* my_carry = carry + (static_cast<long long>(y) * n_seg_cap) * d;
  int* my_flag = flags + 1 + y * n_seg_cap;

  int col_r[kPer];
  float val_r[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int e = seg0 + 32 * p + lane;
    col_r[p] = e < seg1 ? __ldg(col_idx + e) : 0;
    val_r[p] = e < seg1 ? __ldg(vals + e) : 0.f;
  }

  // the first row starting in the segment; the row before it (r0 - 1) is
  // the one the segment's leading nonzeros belong to, if any
  const int r0 = warp_lower_bound(row_ptr, n_rows, seg0, lane);
  int base = r0;  // rp holds row_ptr[base + lane]
  int rp = base + lane <= n_rows ? __ldg(row_ptr + base + lane) : nnz;
  int cur = r0 - 1;                      // the row being summed
  int end = __shfl_sync(kFull, rp, 0);   // where its nonzeros end
  float acc[NC], pre[NC];
  bool has_pre = false;  // the leading row ends here: pre is its last part
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = pre[c] = 0.f;

  // close the rows that end at nonzero e: store each, move to the next
  auto close_at = [&](int e) {
    while (end == e) {
      if (cur == r0 - 1) {
        if (e > seg0) {
          has_pre = true;
#pragma unroll
          for (int c = 0; c < NC; ++c) pre[c] = acc[c];
        }
      } else {
        store_row<NC>(out + static_cast<long long>(cur) * d, d, c0, lane,
                      acc);
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = 0.f;
      if (++cur >= n_rows || (!last && e == seg1)) break;
      int idx = cur + 1 - base;
      if (idx > 31) {
        base = cur;
        rp = base + lane <= n_rows ? __ldg(row_ptr + base + lane) : nnz;
        idx = 1;
      }
      end = __shfl_sync(kFull, rp, idx);
    }
  };

  for (int e = seg0; e < seg1; e += kUnroll) {
    float w[kUnroll], x[kUnroll][NC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int slot = min(e + u, seg1 - 1) - seg0;
      int cv = col_r[0];
      float vv = val_r[0];
#pragma unroll
      for (int p = 1; p < kPer; ++p)
        if ((slot >> 5) == p) { cv = col_r[p]; vv = val_r[p]; }
      const int src = __shfl_sync(kFull, cv, slot & 31);
      w[u] = __shfl_sync(kFull, vv, slot & 31);
      const T* hr = h + src * d + c0 + lane;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        x[u][c] = (e + u < seg1 && c0 + lane + 32 * c < d)
                      ? load(hr + 32 * c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (e + u < seg1) {
        close_at(e + u);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] = fmaf(w[u], x[u][c], acc[c]);
      }
    }
  }
  if (end == seg1) {
    close_at(seg1);  // in the last segment also every row left, all empty
  } else {           // row cur runs past the segment: hand its part on
    store_row<NC>(my_carry + static_cast<long long>(s) * d, d, c0, lane,
                  acc);
    __threadfence();
    __syncwarp();
    if (lane == 0) atomicExch(my_flag + s, 1);
  }

  if (has_pre) {  // the leading row ends in this segment: add its parts
    const int r = r0 - 1;
    const int s0 = __ldg(row_ptr + r) / kSeg;
    // wait until segments s0 .. s - 1 have handed on their parts, 32
    // flags at a time (none of them waits on anything)
    for (int t0 = s0; t0 < s; t0 += 32) {
      const int t = t0 + lane;
      bool ready = t >= s;
      while (!__all_sync(kFull, ready)) {
        if (!ready) {
          int f;
          asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
                       : "=r"(f) : "l"(my_flag + t) : "memory");
          ready = f != 0;
        }
      }
    }
    __syncwarp();
    __threadfence();
    float tot[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) tot[c] = 0.f;
#pragma unroll 4
    for (int t = s0; t < s; ++t) {
      const float* ct = my_carry + static_cast<long long>(t) * d + c0 + lane;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (c0 + lane + 32 * c < d) tot[c] += __ldcg(ct + 32 * c);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) tot[c] += pre[c];
    store_row<NC>(out + static_cast<long long>(r) * d, d, c0, lane, tot);
  }
}

// The narrow kernel (d <= 16, header): L lanes a row, G = 32 / L nonzeros
// gathered at once; one column a lane, scratch carry (n_seg, d).
template <int L, typename T>
__global__ void __launch_bounds__(kThreads)
spmm_csr_narrow_kernel(const int* __restrict__ row_ptr,
                       const int* __restrict__ col_idx,
                       const float* __restrict__ vals, int n_rows,
                       const T* __restrict__ h, int d, T* __restrict__ out,
                       float* carry, int* flags) {
  constexpr int G = 32 / L;
  constexpr int kStep = kUnroll * G;  // nonzeros an unrolled round covers
  __shared__ int vblock;
  if (threadIdx.x == 0) vblock = atomicAdd(flags, 1);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int grp = lane / L, col = lane % L;
  const bool col_ok = col < d;
  const int s = vblock * kWarps + (threadIdx.x >> 5);
  const int nnz = __ldg(row_ptr + n_rows);
  const int n_seg = max((nnz + kSeg - 1) / kSeg, 1);
  if (s >= n_seg) return;
  const int seg0 = s * kSeg;
  const int seg1 = min(seg0 + kSeg, nnz);
  const bool last = s == n_seg - 1;
  int* my_flag = flags + 1;

  int col_r[kPer];
  float val_r[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int e = seg0 + 32 * p + lane;
    col_r[p] = e < seg1 ? __ldg(col_idx + e) : 0;
    val_r[p] = e < seg1 ? __ldg(vals + e) : 0.f;
  }

  const int r0 = warp_lower_bound(row_ptr, n_rows, seg0, lane);
  int base = r0;  // rp holds row_ptr[base + lane]
  int rp = base + lane <= n_rows ? __ldg(row_ptr + base + lane) : nnz;
  int cur = r0 - 1;                      // the row being summed
  int end = __shfl_sync(kFull, rp, 0);   // where its nonzeros end
  float acc = 0.f, pre = 0.f;            // this group's part of row cur
  bool has_pre = false;

  // the row's sum over the groups, the same in every lane
  auto group_sum = [&]() {
    float v = acc;
#pragma unroll
    for (int o = L; o < 32; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
  };
  // close row cur, which ends at `end`: store its sum (or keep it as the
  // leading row's last part) and move to the next row; false where no
  // further row is this segment's
  auto close = [&]() -> bool {
    const float tot = group_sum();
    if (cur == r0 - 1) {
      if (end > seg0) {
        has_pre = true;
        pre = tot;
      }
    } else if (grp == 0 && col_ok) {
      put(out + static_cast<long long>(cur) * d + col, tot);
    }
    acc = 0.f;
    if (++cur >= n_rows || (!last && end == seg1)) return false;
    int idx = cur + 1 - base;
    if (idx > 31) {
      base = cur;
      rp = base + lane <= n_rows ? __ldg(row_ptr + base + lane) : nnz;
      idx = 1;
    }
    end = __shfl_sync(kFull, rp, idx);
    return true;
  };

  for (int e0 = seg0; e0 < seg1; e0 += kStep) {
    float w[kUnroll], x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // the step's G slots lie in one 32-slot block of the loaded pairs
      const int step0 = e0 - seg0 + u * G;
      const int slot = step0 + grp;
      int cv = col_r[0];
      float vv = val_r[0];
#pragma unroll
      for (int p = 1; p < kPer; ++p)
        if ((step0 >> 5) == p) { cv = col_r[p]; vv = val_r[p]; }
      const int src = __shfl_sync(kFull, cv, slot & 31);
      w[u] = __shfl_sync(kFull, vv, slot & 31);
      x[u] = (seg0 + slot < seg1 && col_ok) ? load(h + src * d + col) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int b = e0 + u * G;  // the step's nonzeros are [b, b2)
      if (b < seg1) {
        const int b2 = min(b + G, seg1);
        int lo = 0;  // the step's groups before lo are summed already
        while (end < b2) {  // row cur ends inside the step
          const int hi = end - b;
          if (grp >= lo && grp < hi) acc = fmaf(w[u], x[u], acc);
          lo = hi;
          if (!close()) break;
        }
        if (grp >= lo && b + grp < b2) acc = fmaf(w[u], x[u], acc);
      }
    }
  }
  if (end == seg1) {
    // in the last segment also every row left, all empty
    while (end == seg1 && close()) {
    }
  } else {  // row cur runs past the segment: hand its part on
    const float part = group_sum();
    if (grp == 0 && col_ok) carry[static_cast<long long>(s) * d + col] = part;
    __threadfence();
    __syncwarp();
    if (lane == 0) atomicExch(my_flag + s, 1);
  }

  if (has_pre) {  // the leading row ends in this segment: add its parts
    const int r = r0 - 1;
    const int s0 = __ldg(row_ptr + r) / kSeg;
    for (int t0 = s0; t0 < s; t0 += 32) {
      const int t = t0 + lane;
      bool ready = t >= s;
      while (!__all_sync(kFull, ready)) {
        if (!ready) {
          int f;
          asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
                       : "=r"(f) : "l"(my_flag + t) : "memory");
          ready = f != 0;
        }
      }
    }
    __syncwarp();
    __threadfence();
    float tot = 0.f;
    if (col_ok) {
#pragma unroll 4
      for (int t = s0; t < s; ++t)
        tot += __ldcg(carry + static_cast<long long>(t) * d + col);
    }
    tot += pre;
    if (grp == 0 && col_ok) put(out + static_cast<long long>(r) * d + col, tot);
  }
}

template <int NC, typename T>
int launch(const int* row_ptr, const int* col_idx, const float* vals,
           int n_rows, const T* h, int d, T* out, float* carry, int* flags,
           int n_seg, cudaStream_t s) {
  const int ny = (d + 32 * NC - 1) / (32 * NC);
  const int nbx = (n_seg + kWarps - 1) / kWarps;
  const cudaError_t err = cudaMemsetAsync(
      flags, 0, sizeof(int) * (1 + static_cast<size_t>(ny) * n_seg), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  spmm_csr_kernel<NC, T><<<nbx * ny, kThreads, 0, s>>>(
      row_ptr, col_idx, vals, n_rows, h, d, out, carry, flags, n_seg, nbx);
  return static_cast<int>(cudaGetLastError());
}

template <int L, typename T>
int launch_narrow(const int* row_ptr, const int* col_idx, const float* vals,
                  int n_rows, const T* h, int d, T* out, float* carry,
                  int* flags, int n_seg, cudaStream_t s) {
  const int nbx = (n_seg + kWarps - 1) / kWarps;
  const cudaError_t err = cudaMemsetAsync(
      flags, 0, sizeof(int) * (1 + static_cast<size_t>(n_seg)), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  spmm_csr_narrow_kernel<L, T><<<nbx, kThreads, 0, s>>>(
      row_ptr, col_idx, vals, n_rows, h, d, out, carry, flags);
  return static_cast<int>(cudaGetLastError());
}

// the launch for d: the narrow kernel up to 16 columns, else the y-tile
// width
template <typename T>
int launch_for(const int* row_ptr, const int* col_idx, const float* vals,
               int n_rows, const void* h, int d, void* out, float* carry,
               int* flags, int n_seg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* ht = static_cast<const T*>(h);
  T* ot = static_cast<T*>(out);
  if (d <= 1)
    return launch_narrow<1>(row_ptr, col_idx, vals, n_rows, ht, d, ot, carry,
                            flags, n_seg, s);
  if (d <= 2)
    return launch_narrow<2>(row_ptr, col_idx, vals, n_rows, ht, d, ot, carry,
                            flags, n_seg, s);
  if (d <= 4)
    return launch_narrow<4>(row_ptr, col_idx, vals, n_rows, ht, d, ot, carry,
                            flags, n_seg, s);
  if (d <= 8)
    return launch_narrow<8>(row_ptr, col_idx, vals, n_rows, ht, d, ot, carry,
                            flags, n_seg, s);
  if (d <= 16)
    return launch_narrow<16>(row_ptr, col_idx, vals, n_rows, ht, d, ot,
                             carry, flags, n_seg, s);
  if (d <= 32)
    return launch<1>(row_ptr, col_idx, vals, n_rows, ht, d, ot, carry, flags,
                     n_seg, s);
  if (d <= 64)
    return launch<2>(row_ptr, col_idx, vals, n_rows, ht, d, ot, carry, flags,
                     n_seg, s);
  return launch<4>(row_ptr, col_idx, vals, n_rows, ht, d, ot, carry, flags,
                   n_seg, s);
}

}  // namespace

// Nonzeros per segment and columns per y-tile at width d: the wrapper sizes
// the scratch buffers with them.
extern "C" int spmm_csr_segment() { return kSeg; }
extern "C" int spmm_csr_tile_cols(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : 128;
}

// C interface, bound from Python with ctypes.  Pointers are device pointers
// of contiguous tensors: row_ptr (n_rows + 1) int32 with row_ptr[0] = 0 and
// row_ptr[n_rows] = nnz <= cap; col_idx, vals (cap) int32 / float32, entries
// past nnz ignored; h (n_in, d) with n_in * d < 2^31 and out (n_rows, d),
// both float32 (spmm_csr_f32) or both bfloat16 (spmm_csr_bf16).  Scratch:
// carry (ny, n_seg, d) float32 and flags (1 + ny * n_seg) int32, with n_seg
// = max(ceil(cap / kSeg), 1) and ny = ceil(d / spmm_csr_tile_cols(d)), so
// the launch needs no count from the device.  Both may hold anything: the
// flags are zeroed on the stream before the kernel starts.  The caller has
// checked shapes, types and devices and launches only for n_rows, d > 0.
// Returns the cudaError_t of the memset or the launch.
extern "C" int spmm_csr_f32(const int* row_ptr, const int* col_idx,
                            const float* vals, int n_rows, const void* h,
                            int d, void* out, float* carry, int* flags,
                            int n_seg, void* stream) {
  return launch_for<float>(row_ptr, col_idx, vals, n_rows, h, d, out, carry,
                           flags, n_seg, stream);
}

extern "C" int spmm_csr_bf16(const int* row_ptr, const int* col_idx,
                             const float* vals, int n_rows, const void* h,
                             int d, void* out, float* carry, int* flags,
                             int n_seg, void* stream) {
  return launch_for<__nv_bfloat16>(row_ptr, col_idx, vals, n_rows, h, d, out,
                                   carry, flags, n_seg, stream);
}
