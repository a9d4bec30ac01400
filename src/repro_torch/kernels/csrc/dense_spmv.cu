// Dense stage of the hybrid degree-split backend for Hopper (sm_90a): the
// product of the query batch with the H x H block of the top-degree
// vertices,
//
//   dense_spmv:          y[m, n] = sum_k x[m, k] * a[k, n]
//   dense_spmv_minplus:  y[m, n] = min_k x[m, k] + a[k, n]
//
// x [M, K] (M = the queries, small), a [K, N], y [M, N], all f32 and
// row-major; K and N are ragged (any size).
//
// Replaces repro/kernels/dense_spmv.py::dense_spmv and ::dense_spmv_minplus
// (the Pallas kernels, reached through repro/kernels/ops.py's
// dense_spmv_op / dense_spmv_minplus_op).  The TPU kernels tile (N/bn,
// K/bk) with a revolving accumulator over the sequential K axis and run
// the product on the matrix unit.  Here blocks run in no order, so:
//
//   * block (bx, s) owns kCols columns and the K slice [s * kSlice,
//     (s + 1) * kSlice); a thread owns one column and keeps kQ queries'
//     accumulators in registers, the x slice sits in shared memory, and
//     a is staged through shared memory kStage rows at a time (each
//     thread's loads of a stage issued before any is used);
//   * each slice writes a partial [S, M, N]; a second kernel combines the
//     S partials of each output in a fixed pairwise tree.
//
// CUDA cores in f32, not tensor cores: TF32 would round x to a 10-bit
// mantissa.  No float atomics: the sum's order is fixed by K alone, so
// results are bit-identical run to run, with a rounding depth of at most
// kSlice + ceil(log2(S)) adds plus one for the product.  A min is exact,
// so the min-plus kernel is bit-equal to the plain PyTorch version.  Built
// without fast-math and with -fmad=false; _rn intrinsics throughout.
//
// Bound on the card: bytes.  a is read once (K * N * 4 bytes: 31.7 MB at
// |H| = 2816), against 2 * M * K * N operations, far below the f32 peak at
// M <= 8; the partials are M * N * S floats (a few MB, in L2).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kCols = 256;    // columns per block, one per thread
constexpr int kSlice = 128;   // K rows per block: the longest sequential run
constexpr int kStage = 32;    // rows of a staged in shared memory at a time
constexpr int kQ = 8;         // queries per pass
constexpr int kTreeThreads = 256;

enum Mode { kPlusTimes = 0, kMinPlus = 1 };

template <int MODE>
__device__ __forceinline__ float identity() {
  return MODE == kPlusTimes ? 0.0f : CUDART_INF_F;
}

template <int MODE>
__device__ __forceinline__ float combine(float a, float b) {
  return MODE == kPlusTimes ? __fadd_rn(a, b) : fminf(a, b);
}

template <int MODE>
__device__ __forceinline__ float edge(float xv, float av) {
  return MODE == kPlusTimes ? __fmul_rn(xv, av) : __fadd_rn(xv, av);
}

// Grid (ceil(N / kCols), S): partial[s, m, n] over the K slice s.
template <int MODE>
__global__ void __launch_bounds__(kCols)
dense_partial_kernel(const float* __restrict__ x, const float* __restrict__ a,
                     float* __restrict__ part, int M, int K, int N) {
  __shared__ float xs[kQ][kSlice];
  __shared__ float as[kStage][kCols];
  const int t = threadIdx.x;
  const int n = blockIdx.x * kCols + t;
  const int s = blockIdx.y;
  const int k0 = s * kSlice;
  const int kn = min(kSlice, K - k0);
  for (int m0 = 0; m0 < M; m0 += kQ) {
    __syncthreads();   // the previous pass is done with xs
    for (int i = t; i < kQ * kSlice; i += kCols) {
      const int j = i / kSlice;
      const int kk = i % kSlice;
      xs[j][kk] = (m0 + j < M && kk < kn)
                      ? x[static_cast<int64_t>(m0 + j) * K + k0 + kk]
                      : identity<MODE>();
    }
    float acc[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) acc[j] = identity<MODE>();
    for (int st = 0; st < kn; st += kStage) {
      const int rows = min(kStage, kn - st);
      __syncthreads();   // xs written; the previous stage consumed
#pragma unroll
      for (int i = 0; i < kStage; ++i) {
        if (i < rows && n < N) {
          as[i][t] = a[static_cast<int64_t>(k0 + st + i) * N + n];
        }
      }
      __syncthreads();
      if (n < N) {
        for (int i = 0; i < rows; ++i) {
          const float av = as[i][t];
#pragma unroll
          for (int j = 0; j < kQ; ++j) {
            acc[j] = combine<MODE>(acc[j], edge<MODE>(xs[j][st + i], av));
          }
        }
      }
    }
    if (n < N) {
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        if (m0 + j < M) {
          part[(static_cast<int64_t>(s) * M + m0 + j) * N + n] = acc[j];
        }
      }
    }
  }
}

// One thread per output: y[i] = the pairwise tree over the S partials.
template <int MODE>
__global__ void __launch_bounds__(kTreeThreads)
dense_tree_kernel(float* __restrict__ part, float* __restrict__ y, int S,
                  int64_t MN) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTreeThreads +
                    threadIdx.x;
  if (i >= MN) return;
  for (int w = 1; w < S; w *= 2) {
    for (int s = 0; s + w < S; s += 2 * w) {
      part[s * MN + i] = combine<MODE>(part[s * MN + i],
                                       part[(s + w) * MN + i]);
    }
  }
  y[i] = part[i];
}

template <int MODE>
int launch(const float* x, const float* a, float* part, float* y, int M,
           int K, int N, cudaStream_t st) {
  const int S = (K + kSlice - 1) / kSlice;
  const dim3 grid((N + kCols - 1) / kCols, S);
  dense_partial_kernel<MODE><<<grid, kCols, 0, st>>>(x, a, part, M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t mn = static_cast<int64_t>(M) * N;
  const int64_t blocks = (mn + kTreeThreads - 1) / kTreeThreads;
  dense_tree_kernel<MODE><<<static_cast<unsigned>(blocks), kTreeThreads, 0,
                            st>>>(part, y, S, mn);
  return static_cast<int>(cudaGetLastError());
}

int check(int M, int K, int N) {
  if (M <= 0 || K <= 0 || N <= 0 || (K + kSlice - 1) / kSlice > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// part: f32 scratch [dense_spmv_slices(K), M, N].
extern "C" int dense_spmv_launch(const float* x, const float* a, float* part,
                                 float* y, int M, int K, int N,
                                 void* stream) {
  if (int rc = check(M, K, N)) return rc;
  return launch<kPlusTimes>(x, a, part, y, M, K, N,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int dense_spmv_minplus_launch(const float* x, const float* a,
                                         float* part, float* y, int M, int K,
                                         int N, void* stream) {
  if (int rc = check(M, K, N)) return rc;
  return launch<kMinPlus>(x, a, part, y, M, K, N,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int dense_spmv_slices(int K) { return (K + kSlice - 1) / kSlice; }

extern "C" const char* dense_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
