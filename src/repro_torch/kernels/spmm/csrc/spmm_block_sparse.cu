// Block-sparse SpMM for full-graph GNN aggregation, written for Hopper
// (sm_90a), fp32.
//
// Replaces the TPU kernel repro/kernels/spmm/spmm.py::spmm_block_sparse
// (Pallas body `_kernel`).  It computes the same function:
//
//     out[r] = sum over k with block_rows[k] == r of  blocks[k] @ h[block_cols[k]]
//
// over nnzb dense (bs x bs) adjacency tiles sorted by destination row block,
// with h read and out written in (bs, d) row blocks.
//
// Design.  The Pallas grid (d_tiles, nnzb) visits the tiles in order on one
// core and keeps one output block resident while it accumulates.  Here the
// blocks of a grid run in parallel, so a grid over k would race on shared
// output rows.  Instead one thread block owns one (destination row block,
// 32-column d-tile) pair: it finds its tile range [k_lo, k_hi) by binary
// search over the sorted block_rows, walks it, accumulates in fp32
// registers and stores once.  An empty range stores zeros, so every output
// row is written without a separate fill; the all-zero padding tiles that
// stack_plans appends to the last row add nothing.  row_first is not
// needed: for a plan sorted by row, the sum over the row's range is what
// the TPU kernel's init-then-accumulate sequence computes.
//
// Per tile, A is staged in shared memory in (bs x 32) column slices beside
// the matching 32 source rows of h; each of the 8 warps owns rows
// warp, warp + 8, ... of the output block and each lane one feature column,
// so A is read by broadcast and h without bank conflicts.  Columns beyond d
// are masked, so any d works.
//
// Bound on this card: at bs = 128 the tiles dominate the bytes (bs*bs*4 per
// tile, read once) and the dense tile work dominates the operations
// (2*bs*bs*d per tile), both close to 0.16 ms per launch at the main path's
// shape.  This first version uses plain fp32 FMA (no TF32, no tensor cores,
// no TMA); it is compute-bound on the CUDA cores and the shared-memory
// loads that feed them.
#include <cuda_runtime.h>

namespace {

constexpr int kDt = 32;        // feature columns per thread block (one per lane)
constexpr int kKc = 32;        // reduction slice staged in shared memory
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <int BS>
__global__ void __launch_bounds__(kThreads)
spmm_block_sparse_kernel(const float* __restrict__ blocks,
                         const int* __restrict__ rows,
                         const int* __restrict__ cols, int nnzb,
                         const float* __restrict__ h, int d,
                         float* __restrict__ out) {
  constexpr int kRpt = BS / kWarps;  // output rows per thread
  __shared__ float a_s[BS][kKc + 1];
  __shared__ float h_s[kKc][kDt];

  const int r = blockIdx.x;
  const int c0 = blockIdx.y * kDt;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k_lo = lower_bound(rows, nnzb, r);
  const int k_hi = lower_bound(rows, nnzb, r + 1);

  float acc[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) acc[i] = 0.f;

  for (int k = k_lo; k < k_hi; ++k) {
    const float* a = blocks + static_cast<long long>(k) * BS * BS;
    const float* hb = h + static_cast<long long>(cols[k]) * BS * d;
    for (int kk = 0; kk < BS; kk += kKc) {
      for (int e = threadIdx.x; e < BS * kKc; e += kThreads) {
        const int i = e / kKc, j = e % kKc;
        a_s[i][j] = a[i * BS + kk + j];
      }
      for (int e = threadIdx.x; e < kKc * kDt; e += kThreads) {
        const int i = e / kDt, j = e % kDt;
        h_s[i][j] = (c0 + j < d)
            ? hb[static_cast<long long>(kk + i) * d + c0 + j] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kKc; ++j) {
        const float x = h_s[j][lane];
#pragma unroll
        for (int i = 0; i < kRpt; ++i)
          acc[i] = fmaf(a_s[warp + kWarps * i][j], x, acc[i]);
      }
      __syncthreads();
    }
  }

  const int col = c0 + lane;
  if (col < d) {
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
      out[static_cast<long long>(r * BS + warp + kWarps * i) * d + col] =
          acc[i];
  }
}

}  // namespace

// C interface, bound from Python with ctypes.  Pointers are device pointers
// of contiguous tensors; the caller has checked shapes, types and devices
// and launches only when nnzb, n_out_blocks and d are all positive.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int spmm_block_sparse_f32(const float* blocks, const int* rows,
                                     const int* cols, int nnzb, int bs,
                                     const float* h, int d, float* out,
                                     int n_out_blocks, void* stream) {
  const dim3 grid(n_out_blocks, (d + kDt - 1) / kDt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bs) {
    case 32:
      spmm_block_sparse_kernel<32><<<grid, kThreads, 0, s>>>(
          blocks, rows, cols, nnzb, h, d, out);
      break;
    case 64:
      spmm_block_sparse_kernel<64><<<grid, kThreads, 0, s>>>(
          blocks, rows, cols, nnzb, h, d, out);
      break;
    case 128:
      spmm_block_sparse_kernel<128><<<grid, kThreads, 0, s>>>(
          blocks, rows, cols, nnzb, h, d, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
