// Bottom-up (pull) scan of direction-optimized traversal for Hopper (sm_90a):
// every destination row scans its in-neighbours' messages and keeps the
// minimum, and reports how many slots a sequential scan of the row examines.
//
// Replaces repro/kernels/bottomup.py::bottomup_scan (the Pallas kernel,
// reached through repro/kernels/ops.py::bottomup_scan_op).  The TPU kernel
// reads a dense ELL block [V, kmax] whose width is the largest in-degree,
// gathers the whole block with jnp.take and reduces every slot.  Here:
//
//   * layout: CSR rows (row_ptr, col[, val]) with no padding slots, since on
//     a scale-free graph one hub's in-degree would set the width of every
//     row of an ELL block;
//   * rows of up to kShort slots are scanned by one thread each; longer rows
//     (hubs) by the whole warp, kUnroll * 32 slots per step with the loads
//     issued before they are used;
//   * early exit (MODE kMinEarly): for frontier-uniform programs (BFS) every
//     live message of a superstep holds the same value, so the first live
//     slot of a row IS the row minimum and the scan stops there.  The TPU
//     kernel reduces the whole row and only counts the early-exit scan;
//     here the early exit is real work saved, and y is unchanged under the
//     caller's uniformity licence (ops.bottomup_scan_op states it).
//
// Outputs per (query, row): y = min over the row's slots of x[col] (plus
// val for min_plus), +inf for an empty row; scanned = slots up to and
// including the first live one (early exit), else the row's length.  A min
// is exact in any order, so y is bit-equal to the plain PyTorch version.
// Built without fast-math and with -fmad=false.
//
// Bound on the card: bytes.  One launch reads row_ptr once, the col (and
// val) slots the scans reach, each query's message row x, and writes y and
// scanned; a compare (and an add) per slot is far below the f32 peak.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kShort = 32;   // rows up to this long: one thread each
constexpr int kUnroll = 4;   // a warp scans kUnroll * 32 slots of a hub per step
constexpr unsigned kFullMask = 0xffffffffu;

enum Mode { kMin = 0, kMinEarly = 1, kMinPlus = 2 };

// Grid (ceil(V / kThreads), Q): thread t of a block owns row
// blockIdx.x * kThreads + t for query blockIdx.y.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
bottomup_scan_kernel(const int* __restrict__ row_ptr,
                     const int* __restrict__ col,
                     const float* __restrict__ val,
                     const float* __restrict__ x,
                     float* __restrict__ y, int* __restrict__ scanned, int V,
                     int64_t x_len) {
  constexpr bool kPlus = MODE == kMinPlus;
  constexpr bool kEarly = MODE == kMinEarly;
  const int q = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const float* xq = x + static_cast<int64_t>(q) * x_len;
  const int64_t out = static_cast<int64_t>(q) * V + r;

  int start = 0;
  int n = 0;
  if (r < V) {
    start = row_ptr[r];
    n = row_ptr[r + 1] - start;
  }
  const bool is_long = n > kShort;

  // Short rows: this thread scans its own row.
  if (r < V && !is_long) {
    float best = CUDART_INF_F;
    int count = n;
    for (int k = 0; k < n; ++k) {
      const float g = xq[col[start + k]];
      if constexpr (kEarly) {
        if (g < CUDART_INF_F) {
          best = g;
          count = k + 1;
          break;
        }
      } else if constexpr (kPlus) {
        best = fminf(best, __fadd_rn(g, val[start + k]));
      } else {
        best = fminf(best, g);
      }
    }
    y[out] = best;
    scanned[out] = count;
  }

  // Long rows: the warp scans each in turn.
  unsigned pending = __ballot_sync(kFullMask, r < V && is_long);
  while (pending) {
    const int owner = __ffs(pending) - 1;
    pending &= pending - 1;
    const int s = __shfl_sync(kFullMask, start, owner);
    const int m = __shfl_sync(kFullMask, n, owner);
    float best = CUDART_INF_F;
    int first = m;  // first live slot; m when there is none
    for (int base = 0; base < m; base += kUnroll * 32) {
      float g[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int k = base + j * 32 + lane;
        if (k < m) {
          g[j] = kPlus ? __fadd_rn(xq[col[s + k]], val[s + k]) : xq[col[s + k]];
        } else {
          g[j] = CUDART_INF_F;
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) best = fminf(best, g[j]);
      if constexpr (kEarly) {
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          const unsigned hit = __ballot_sync(kFullMask, g[j] < CUDART_INF_F);
          if (hit != 0u && first == m) first = base + j * 32 + __ffs(hit) - 1;
        }
        if (first < m) break;  // warp-uniform: first comes from a ballot
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      best = fminf(best, __shfl_xor_sync(kFullMask, best, d));
    }
    if (lane == owner) {
      y[out] = best;
      scanned[out] = kEarly ? min(first + 1, m) : m;
    }
  }
}

}  // namespace

extern "C" int bottomup_scan_launch(int mode, const int* row_ptr,
                                    const int* col, const float* val,
                                    const float* x, float* y, int* scanned,
                                    int Q, int V, long long x_len,
                                    void* stream) {
  if (Q <= 0 || Q > 65535 || V <= 0 || x_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((V + kThreads - 1) / kThreads, Q);
  switch (mode) {
    case kMin:
      bottomup_scan_kernel<kMin><<<grid, kThreads, 0, st>>>(
          row_ptr, col, val, x, y, scanned, V, x_len);
      break;
    case kMinEarly:
      bottomup_scan_kernel<kMinEarly><<<grid, kThreads, 0, st>>>(
          row_ptr, col, val, x, y, scanned, V, x_len);
      break;
    case kMinPlus:
      bottomup_scan_kernel<kMinPlus><<<grid, kThreads, 0, st>>>(
          row_ptr, col, val, x, y, scanned, V, x_len);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bottomup_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
