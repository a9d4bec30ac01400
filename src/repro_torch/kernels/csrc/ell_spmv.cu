// Sparse stage of the hybrid degree-split backend for Hopper (sm_90a): a
// semiring SpMV over the remainder's CSR in-edge rows,
//
//   y[q, v] = (+)_{slots s of row v} x[q, col[s]] (x) val[s]
//
// in three semirings: plus_times (PageRank, BC), min_plus (SSSP) and min
// (BFS, CC; val is not read).  An empty row gives the (+)-identity.
//
// Replaces repro/kernels/ell_spmv.py::ell_spmv (the Pallas kernel, reached
// through repro/kernels/ops.py::ell_spmv_op).  The TPU kernel reads an ELL
// block [V, kmax] padded with sentinel slots, kmax the widest row.  At
// RMAT20 the widest remainder row holds ~50k slots, so that block would
// need hundreds of GB; here the rows are CSR with no padding, and the work
// of a row is split by its length:
//
//   * rows of up to kShort slots: one thread each;
//   * rows of up to kWarpMax slots: one warp each (the long rows of a
//     block are taken in turn by the warp, as in bottomup.cu);
//   * longer rows (hubs): one block of kHubThreads threads each.  The
//     first kernel appends them to a list (scratch); the second launches
//     one block per possible hub and exits the blocks beyond the count.
//
// Each pass handles kQ queries with one accumulator each in registers, so
// a row's col/val are read once per kQ queries.
//
// Summation order (plus_times) is fixed by the row's length alone: a thread
// adds at most kRun products in slot order, then a warp butterfly (5
// levels) and, for hubs, a tree over the block's warps (4 levels) and a
// sequential sum over segments of kHubThreads * kRun slots.  No float
// atomics: results are bit-identical run to run, and the rounding depth of
// a row of n slots is at most kRun + 9 + ceil(n / (kHubThreads * kRun)),
// plus one for the product.  A min is exact in any order, so min and
// min_plus are bit-equal to the plain PyTorch version.  Built without
// fast-math and with -fmad=false; products and sums use the _rn
// intrinsics.
//
// Bound on the card: bytes.  One launch reads row_ptr, col (and val) once,
// each query's x row once and writes y once; a multiply-add (or an add and
// a compare) per slot and query is far below the f32 peak.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;        // rows per block of the first kernel
constexpr int kShort = 32;           // rows up to this long: one thread each
constexpr int kRun = 128;            // longest sequential run of one sum
constexpr int kWarpMax = 32 * kRun;  // rows up to this long: one warp each
constexpr int kHubThreads = 512;     // threads of a hub row's block
constexpr int kHubWarps = kHubThreads / 32;
constexpr int kQ = 8;                // queries per pass
constexpr unsigned kFullMask = 0xffffffffu;

enum Mode { kPlusTimes = 0, kMinPlus = 1, kMin = 2 };

template <int MODE>
__device__ __forceinline__ float identity() {
  return MODE == kPlusTimes ? 0.0f : CUDART_INF_F;
}

template <int MODE>
__device__ __forceinline__ float combine(float a, float b) {
  return MODE == kPlusTimes ? __fadd_rn(a, b) : fminf(a, b);
}

template <int MODE>
__device__ __forceinline__ float edge(float xv, float w) {
  if constexpr (MODE == kPlusTimes) return __fmul_rn(xv, w);
  if constexpr (MODE == kMinPlus) return __fadd_rn(xv, w);
  return xv;
}

// acc[j] (+)= x[q0 + j, c] (x) w for the queries of this pass.
template <int MODE>
__device__ __forceinline__ void accumulate(float (&acc)[kQ], const float* x,
                                           int64_t x_len, int q0, int Q,
                                           int c, float w) {
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    if (q0 + j < Q) {
      acc[j] = combine<MODE>(
          acc[j], edge<MODE>(x[static_cast<int64_t>(q0 + j) * x_len + c], w));
    }
  }
}

template <int MODE>
__device__ __forceinline__ void warp_tree(float (&acc)[kQ]) {
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      acc[j] = combine<MODE>(acc[j], __shfl_xor_sync(kFullMask, acc[j], d));
    }
  }
}

// Grid ceil(V / kThreads): thread t of a block owns row
// blockIdx.x * kThreads + t.  Short rows are summed by their thread, warp
// rows by the warp; hub rows are listed for ell_hub_kernel.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
ell_rows_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                const float* __restrict__ val, const float* __restrict__ x,
                float* __restrict__ y, int* __restrict__ hubs,
                int* __restrict__ num_hubs, int Q, int V, int64_t x_len) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  int start = 0;
  int n = 0;
  if (r < V) {
    start = row_ptr[r];
    n = row_ptr[r + 1] - start;
  }
  if (r < V && n > kWarpMax) hubs[atomicAdd(num_hubs, 1)] = r;

  if (r < V && n <= kShort) {
    for (int q0 = 0; q0 < Q; q0 += kQ) {
      float acc[kQ];
#pragma unroll
      for (int j = 0; j < kQ; ++j) acc[j] = identity<MODE>();
      for (int k = 0; k < n; ++k) {
        const float w = MODE == kMin ? 0.0f : val[start + k];
        accumulate<MODE>(acc, x, x_len, q0, Q, col[start + k], w);
      }
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        if (q0 + j < Q) y[static_cast<int64_t>(q0 + j) * V + r] = acc[j];
      }
    }
  }

  unsigned pending =
      __ballot_sync(kFullMask, r < V && n > kShort && n <= kWarpMax);
  while (pending) {
    const int owner = __ffs(pending) - 1;
    pending &= pending - 1;
    const int s = __shfl_sync(kFullMask, start, owner);
    const int m = __shfl_sync(kFullMask, n, owner);
    const int row = r - lane + owner;
    for (int q0 = 0; q0 < Q; q0 += kQ) {
      float acc[kQ];
#pragma unroll
      for (int j = 0; j < kQ; ++j) acc[j] = identity<MODE>();
      for (int k = lane; k < m; k += 32) {   // at most kRun per lane
        const float w = MODE == kMin ? 0.0f : val[s + k];
        accumulate<MODE>(acc, x, x_len, q0, Q, col[s + k], w);
      }
      warp_tree<MODE>(acc);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          if (q0 + j < Q) y[static_cast<int64_t>(q0 + j) * V + row] = acc[j];
        }
      }
    }
  }
}

// Grid = the most hub rows the CSR can hold; block b sums hubs[b] if the
// first kernel listed that many.
template <int MODE>
__global__ void __launch_bounds__(kHubThreads)
ell_hub_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
               const float* __restrict__ val, const float* __restrict__ x,
               float* __restrict__ y, const int* __restrict__ hubs,
               const int* __restrict__ num_hubs, int Q, int V,
               int64_t x_len) {
  if (static_cast<int>(blockIdx.x) >= *num_hubs) return;
  __shared__ float part[kHubWarps][kQ];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = hubs[blockIdx.x];
  const int s = row_ptr[r];
  const int m = row_ptr[r + 1] - s;
  for (int q0 = 0; q0 < Q; q0 += kQ) {
    float total[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) total[j] = identity<MODE>();
    for (int seg = 0; seg < m; seg += kHubThreads * kRun) {
      const int end = min(m, seg + kHubThreads * kRun);
      float acc[kQ];
#pragma unroll
      for (int j = 0; j < kQ; ++j) acc[j] = identity<MODE>();
      for (int k = seg + threadIdx.x; k < end; k += kHubThreads) {
        const float w = MODE == kMin ? 0.0f : val[s + k];
        accumulate<MODE>(acc, x, x_len, q0, Q, col[s + k], w);
      }
      warp_tree<MODE>(acc);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kQ; ++j) part[warp][j] = acc[j];
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          float v = lane < kHubWarps ? part[lane][j] : identity<MODE>();
#pragma unroll
          for (int d = kHubWarps / 2; d > 0; d >>= 1) {
            v = combine<MODE>(v, __shfl_xor_sync(kFullMask, v, d));
          }
          total[j] = combine<MODE>(total[j], v);   // segments in order
        }
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        if (q0 + j < Q) y[static_cast<int64_t>(q0 + j) * V + r] = total[j];
      }
    }
  }
}

template <int MODE>
int launch(const int* row_ptr, const int* col, const float* val,
           const float* x, float* y, int* scratch, int max_hubs, int Q, int V,
           int64_t x_len, cudaStream_t st) {
  const int blocks = (V + kThreads - 1) / kThreads;
  ell_rows_kernel<MODE><<<blocks, kThreads, 0, st>>>(
      row_ptr, col, val, x, y, scratch + 1, scratch, Q, V, x_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || max_hubs == 0) return static_cast<int>(err);
  ell_hub_kernel<MODE><<<max_hubs, kHubThreads, 0, st>>>(
      row_ptr, col, val, x, y, scratch + 1, scratch, Q, V, x_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: int32 [1 + max_hubs], scratch[0] zeroed by the caller (the hub
// count); max_hubs = the most rows longer than ell_spmv_warp_max() that
// the CSR can hold (0 launches only the first kernel).
extern "C" int ell_spmv_launch(int mode, const int* row_ptr, const int* col,
                               const float* val, const float* x, float* y,
                               int* scratch, int max_hubs, int Q, int V,
                               long long x_len, void* stream) {
  if (Q <= 0 || V <= 0 || x_len <= 0 || max_hubs < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode != kMin && val == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kPlusTimes:
      return launch<kPlusTimes>(row_ptr, col, val, x, y, scratch, max_hubs, Q,
                                V, x_len, st);
    case kMinPlus:
      return launch<kMinPlus>(row_ptr, col, val, x, y, scratch, max_hubs, Q,
                              V, x_len, st);
    case kMin:
      return launch<kMin>(row_ptr, col, val, x, y, scratch, max_hubs, Q, V,
                          x_len, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int ell_spmv_warp_max() { return kWarpMax; }

extern "C" const char* ell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
