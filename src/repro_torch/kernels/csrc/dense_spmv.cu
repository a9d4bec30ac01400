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
// the product on the matrix unit.  Here blocks run in no order.
//
// Bound on the card: bytes.  a is read once (K * N * 4 bytes: 31.7 MB at
// |H| = 2816), against 2 * M * K * N operations, far below the f32 peak at
// M <= 8.  By Little's law the card needs some 3.3 MB of loads in flight
// (3.35 TB/s at about 1 us), 25 KB per SM.
//
// dense_spmv (dense_spmv_kernel):
//
//   * a goes straight to registers with 16-byte loads: a warp reads one row
//     of a column tile, each lane four neighbouring columns (kTileCols =
//     128 columns, 512 contiguous bytes a row).  No shared-memory staging;
//   * block (tile, s) owns a column tile and the K slice [s * kSlice, (s +
//     1) * kSlice); its 8 warps split the slice into kWarpRows rows each,
//     and a lane issues kInFlight rows' loads before it uses any.  At K = N
//     = 2816 that is 22 x 11 = 242 blocks of 256 threads, two per SM (116-124
//     registers): one wave on 132 SMs, 128 bytes in flight per lane, 64 KB
//     per SM.  Slices of 128 or 384 rows (kWarpRows 16, 48) ran slower
//     there (scripts/dense_ablation.py): 484 blocks take two waves, 176
//     leave SMs idle;
//   * x's slice sits in shared memory (broadcast reads); each lane keeps
//     kQ (8) queries x 4 columns of accumulators in registers, looping over
//     query groups of 8 when M > 8;
//   * the block adds its warps' sums in warp order through shared memory
//     and writes one partial per slice; the last block of a column tile to
//     finish (an integer ticket per tile, after __threadfence) adds the
//     tile's partials in slice order and writes y, then resets its ticket
//     for the next launch.  One launch, no float atomics;
//   * N % 4 != 0 (every row of a misaligned) or an unaligned a or y takes
//     the same kernel with scalar loads and stores (kVec = false); the
//     ragged last columns are masked either way.
//
//   Sum order, fixed by K alone: kWarpRows products in a lane, the 8 warps
//   in order, the slices in order: at most kWarpRows + kWarps + S
//   roundings with the product (S = ceil(K / kSlice)).
//
// dense_spmv_minplus (dense_partial_kernel, dense_tree_kernel; the first
// design, kept until the min-plus product moves to the one above):
//
//   * block (bx, s) owns kCols columns and the K slice [s * kMpSlice, (s +
//     1) * kMpSlice); a thread owns one column and keeps kQ queries'
//     accumulators in registers, the x slice sits in shared memory, and a
//     is staged through shared memory kStage rows at a time;
//   * each slice writes a partial [S, M, N]; a second kernel combines the
//     S partials of each output in a fixed pairwise tree.  A min is exact,
//     so it is bit-equal to the plain PyTorch version.
//
// CUDA cores in f32, not tensor cores: TF32 would round x to a 10-bit
// mantissa.  Results are bit-identical run to run.  Built without
// fast-math and with -fmad=false; _rn intrinsics throughout.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kQ = 8;         // queries per pass

// dense_spmv
constexpr int kWarps = 8;                      // warps of a block
constexpr int kTileCols = 128;                 // columns: 32 lanes x 4
constexpr int kWarpRows = 32;                  // rows a warp adds in a lane
constexpr int kSlice = kWarps * kWarpRows;     // K rows of a block
constexpr int kInFlight = 8;                   // rows a lane loads at once
static_assert(kWarps == kQ, "warp j adds query j's sums over the warps");

// dense_spmv_minplus
constexpr int kCols = 256;    // columns per block, one per thread
constexpr int kMpSlice = 128;  // K rows per block: the longest sequential run
constexpr int kStage = 32;    // rows of a staged in shared memory at a time
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

// Four columns [n0, n0 + 4) of one row of a: one 16-byte load (kVec: N % 4
// == 0 and a aligned, so the four lie in the row or past its end
// together), else four masked scalar loads; 0 past the row's end.
template <bool kVec>
__device__ __forceinline__ float4 load_cols(const float* __restrict__ row,
                                            int n0, int N) {
  if constexpr (kVec) {
    return n0 < N ? __ldg(reinterpret_cast<const float4*>(row + n0))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    return make_float4(n0 < N ? __ldg(row + n0) : 0.f,
                       n0 + 1 < N ? __ldg(row + n0 + 1) : 0.f,
                       n0 + 2 < N ? __ldg(row + n0 + 2) : 0.f,
                       n0 + 3 < N ? __ldg(row + n0 + 3) : 0.f);
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// Grid (ceil(N / kTileCols), S = ceil(K / kSlice)), kWarps * 32 threads.
// part [S, M, tiles * kTileCols] holds each slice's sums (padded columns
// included); tickets [tiles] are 0 between launches.
template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32, 2)
dense_spmv_kernel(const float* __restrict__ x, const float* __restrict__ a,
                  float* __restrict__ part, unsigned* __restrict__ tickets,
                  float* __restrict__ y, int M, int K, int N) {
  __shared__ float xs[kQ][kSlice];
  __shared__ __align__(16) float red[kWarps][kQ][kTileCols];
  __shared__ bool s_last;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int tile = blockIdx.x;
  const int s = blockIdx.y;
  const int S = gridDim.y;
  const int ncols = gridDim.x * kTileCols;       // part's padded row
  const int n0 = tile * kTileCols + lane * 4;    // this lane's columns
  const int k0 = s * kSlice;
  const int kn = min(kSlice, K - k0);
  const int r0 = warp * kWarpRows;               // the warp's rows in it
  const int rn = max(0, min(kWarpRows, kn - r0));
  const float* arow = a + static_cast<int64_t>(k0 + r0) * N;

  for (int m0 = 0; m0 < M; m0 += kQ) {
    __syncthreads();   // the previous pass is done with xs and red
    for (int i = t; i < kQ * kSlice; i += kWarps * 32) {
      const int j = i / kSlice;
      const int kk = i % kSlice;
      xs[j][kk] = (m0 + j < M && kk < kn)
                      ? x[static_cast<int64_t>(m0 + j) * K + k0 + kk]
                      : 0.0f;
    }
    __syncthreads();
    float4 acc[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < rn; r += kInFlight) {
      float4 av[kInFlight];
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) {
        av[i] = r + i < rn
                    ? load_cols<kVec>(arow + static_cast<int64_t>(r + i) * N,
                                      n0, N)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) {
        if (r + i < rn) {
#pragma unroll
          for (int j = 0; j < kQ; ++j) {
            const float xv = xs[j][r0 + r + i];
            acc[j].x = __fadd_rn(acc[j].x, __fmul_rn(xv, av[i].x));
            acc[j].y = __fadd_rn(acc[j].y, __fmul_rn(xv, av[i].y));
            acc[j].z = __fadd_rn(acc[j].z, __fmul_rn(xv, av[i].z));
            acc[j].w = __fadd_rn(acc[j].w, __fmul_rn(xv, av[i].w));
          }
        }
      }
    }
    // the warps' sums in warp order: thread (warp j, lane) adds query j's
    // four columns of the lane over the 8 warps
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      *reinterpret_cast<float4*>(&red[warp][j][lane * 4]) = acc[j];
    }
    __syncthreads();
    float4 v = *reinterpret_cast<const float4*>(&red[0][warp][lane * 4]);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      v = add4(v, *reinterpret_cast<const float4*>(&red[w][warp][lane * 4]));
    }
    if (m0 + warp < M) {
      *reinterpret_cast<float4*>(
          part + (static_cast<int64_t>(s) * M + m0 + warp) * ncols +
          tile * kTileCols + lane * 4) = v;
    }
  }

  // The last block of the tile to finish adds the slices in order.
  __threadfence();
  __syncthreads();
  if (t == 0) {
    s_last = atomicAdd(&tickets[tile], 1u) == static_cast<unsigned>(S - 1);
  }
  __syncthreads();
  if (!s_last) return;
  for (int i = t; i < M * (kTileCols / 4); i += kWarps * 32) {
    const int m = i / (kTileCols / 4);
    const int n = tile * kTileCols + (i % (kTileCols / 4)) * 4;
    const float* col = part + static_cast<int64_t>(m) * ncols + n;
    const int64_t stride = static_cast<int64_t>(M) * ncols;
    float4 v = __ldcg(reinterpret_cast<const float4*>(col));
    for (int u = 1; u < S; u += kInFlight) {   // loads batched, adds in order
      float4 pv[kInFlight];
#pragma unroll
      for (int c = 0; c < kInFlight; ++c) {
        pv[c] = u + c < S ? __ldcg(reinterpret_cast<const float4*>(
                                col + (u + c) * stride))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int c = 0; c < kInFlight; ++c) {
        if (u + c < S) v = add4(v, pv[c]);
      }
    }
    float* out = y + static_cast<int64_t>(m) * N + n;
    if constexpr (kVec) {
      if (n < N) *reinterpret_cast<float4*>(out) = v;
    } else {
      if (n < N) out[0] = v.x;
      if (n + 1 < N) out[1] = v.y;
      if (n + 2 < N) out[2] = v.z;
      if (n + 3 < N) out[3] = v.w;
    }
  }
  if (t == 0) tickets[tile] = 0u;   // ready for the next launch
}

// Grid (ceil(N / kCols), S): partial[s, m, n] over the K slice s.
template <int MODE>
__global__ void __launch_bounds__(kCols)
dense_partial_kernel(const float* __restrict__ x, const float* __restrict__ a,
                     float* __restrict__ part, int M, int K, int N) {
  __shared__ float xs[kQ][kMpSlice];
  __shared__ float as[kStage][kCols];
  const int t = threadIdx.x;
  const int n = blockIdx.x * kCols + t;
  const int s = blockIdx.y;
  const int k0 = s * kMpSlice;
  const int kn = min(kMpSlice, K - k0);
  for (int m0 = 0; m0 < M; m0 += kQ) {
    __syncthreads();   // the previous pass is done with xs
    for (int i = t; i < kQ * kMpSlice; i += kCols) {
      const int j = i / kMpSlice;
      const int kk = i % kMpSlice;
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

int launch_minplus(const float* x, const float* a, float* part, float* y,
                   int M, int K, int N, cudaStream_t st) {
  const int S = (K + kMpSlice - 1) / kMpSlice;
  const dim3 grid((N + kCols - 1) / kCols, S);
  dense_partial_kernel<kMinPlus><<<grid, kCols, 0, st>>>(x, a, part, M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t mn = static_cast<int64_t>(M) * N;
  const int64_t blocks = (mn + kTreeThreads - 1) / kTreeThreads;
  dense_tree_kernel<kMinPlus><<<static_cast<unsigned>(blocks), kTreeThreads,
                                0, st>>>(part, y, S, mn);
  return static_cast<int>(cudaGetLastError());
}

int check(int M, int K, int N, int slice) {
  if (M <= 0 || K <= 0 || N <= 0 || (K + slice - 1) / slice > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

int tiles(int N) { return (N + kTileCols - 1) / kTileCols; }

}  // namespace

// part: f32 scratch of dense_spmv_partials(M, K, N) floats; tickets:
// dense_spmv_tiles(N) unsigned ints, 0 before the first launch (each
// launch leaves them 0).  Launches on one tickets array run in stream order.
extern "C" int dense_spmv_launch(const float* x, const float* a, float* part,
                                 unsigned* tickets, float* y, int M, int K,
                                 int N, void* stream) {
  if (int rc = check(M, K, N, kSlice)) return rc;
  const dim3 grid(tiles(N), (K + kSlice - 1) / kSlice);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    dense_spmv_kernel<true><<<grid, kWarps * 32, 0, st>>>(x, a, part, tickets,
                                                         y, M, K, N);
  } else {
    dense_spmv_kernel<false><<<grid, kWarps * 32, 0, st>>>(x, a, part,
                                                          tickets, y, M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long dense_spmv_partials(int M, int K, int N) {
  return static_cast<long long>((K + kSlice - 1) / kSlice) * M * tiles(N) *
         kTileCols;
}

extern "C" int dense_spmv_tiles(int N) { return tiles(N); }

// part: f32 scratch [dense_spmv_minplus_slices(K), M, N].
extern "C" int dense_spmv_minplus_launch(const float* x, const float* a,
                                         float* part, float* y, int M, int K,
                                         int N, void* stream) {
  if (int rc = check(M, K, N, kMpSlice)) return rc;
  return launch_minplus(x, a, part, y, M, K, N,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int dense_spmv_minplus_slices(int K) {
  return (K + kMpSlice - 1) / kMpSlice;
}

extern "C" const char* dense_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
