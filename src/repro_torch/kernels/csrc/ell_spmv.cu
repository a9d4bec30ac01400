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
// need hundreds of GB; here the rows are CSR with no padding.
//
// Design (CSR-adaptive).  A row plan, made once per split on the host
// (kernels/ell_spmv.py::row_plan), cuts the rows into blocks of work:
//
//   * runs: consecutive rows whose slots fit kBudget (and at most kRunRows
//     rows).  The block stages the run's col/val into shared memory with
//     coalesced loads, then groups of L lanes (L a power of two chosen by
//     the plan from the run's mean and longest row) take its rows in turn;
//     lane i of a group adds slots i, i + L, ... of its row and the group
//     ends in a butterfly of log2(L) levels.  The plan picks L so that no
//     lane adds more than kLaneRun slots;
//   * chunks: a row longer than kBudget gets one block per kBudget slots;
//     each thread adds at most kBudget / kThreads slots (coalesced reads of
//     col/val), the warps end in a butterfly and the block in a fixed tree
//     over its 8 warps, and the chunk's partial is written to scratch.  A
//     second kernel adds each long row's partials in chunk order.
//
// x is read query-minor: xt [x_len, Qp], Qp = Q rounded up to a multiple of
// 4 with the (+)-identity in the padding, so one slot's 8 queries are one
// or two 16-byte loads from one 32-byte sector where query-major x touches
// 8 sectors (scripts/ell_ablation.py builds that layout as a variant of
// this source and times the two).  Each pass handles kQ = 8 queries.
//
// Summation order (plus_times) is fixed by the plan alone, with no float
// atomics: results are bit-identical launch to launch.  Longest rounding
// path of a row of n slots: in a run, kLaneRun adds in a lane, log2(32) = 5
// butterfly levels and the product, kLaneRun + 6; in chunks,
// kBudget / kThreads adds in a thread, 5 warp levels, 3 block levels,
// ceil(n / kBudget) - 1 adds of the partials and the product,
// kBudget / kThreads + 8 + ceil(n / kBudget).  A min is exact in any order,
// so min and min_plus are bit-equal to the plain PyTorch version.  Built
// without fast-math and with -fmad=false; products and sums use the _rn
// intrinsics.
//
// Bound on the card: bytes.  One launch reads row_ptr, col (and val) once,
// x once and writes y once; a multiply-add (or an add and a compare) per
// slot and query is far below the f32 peak.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBudget = 2048;        // slots staged by a run, or one chunk
constexpr int kRunRows = 512;        // most rows of one run
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

// acc[j] (+)= x[q0 + j, c] (x) w for the (up to) 8 queries of this pass:
// one or two 16-byte loads of row c of xt.
template <int MODE>
__device__ __forceinline__ void accumulate(float (&acc)[kQ],
                                           const float* __restrict__ xt,
                                           int Qp, int q0, int c, float w) {
  const float4* row =
      reinterpret_cast<const float4*>(xt + static_cast<int64_t>(c) * Qp + q0);
  const float4 a = __ldg(row);
  acc[0] = combine<MODE>(acc[0], edge<MODE>(a.x, w));
  acc[1] = combine<MODE>(acc[1], edge<MODE>(a.y, w));
  acc[2] = combine<MODE>(acc[2], edge<MODE>(a.z, w));
  acc[3] = combine<MODE>(acc[3], edge<MODE>(a.w, w));
  if (q0 + 4 < Qp) {
    const float4 b = __ldg(row + 1);
    acc[4] = combine<MODE>(acc[4], edge<MODE>(b.x, w));
    acc[5] = combine<MODE>(acc[5], edge<MODE>(b.y, w));
    acc[6] = combine<MODE>(acc[6], edge<MODE>(b.z, w));
    acc[7] = combine<MODE>(acc[7], edge<MODE>(b.w, w));
  }
}

// Butterfly over groups of `lanes` lanes (a power of two, <= 32); every
// lane of the warp takes part.
template <int MODE>
__device__ __forceinline__ void butterfly(float (&acc)[kQ], int lanes) {
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    for (int d = lanes / 2; d > 0; d >>= 1) {
      acc[j] = combine<MODE>(acc[j], __shfl_xor_sync(kFullMask, acc[j], d));
    }
  }
}

// One block per plan entry (first, second, third):
//   run   (r0, r1, L):  rows [r0, r1), L lanes per row;
//   chunk (r, c, -1 - p): slots [c * kBudget, (c + 1) * kBudget) of row r,
//                         its partial to partials[p].
template <int MODE>
__global__ void __launch_bounds__(kThreads)
ell_block_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                 const float* __restrict__ val, const float* __restrict__ xt,
                 float* __restrict__ y, const int* __restrict__ plan,
                 float* __restrict__ partials, int Q, int Qp, int V) {
  __shared__ int s_col[kBudget];
  __shared__ float s_val[kBudget];
  __shared__ int s_ptr[kRunRows + 1];
  __shared__ float s_part[kWarps][kQ];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int a = plan[3 * blockIdx.x];
  const int b = plan[3 * blockIdx.x + 1];
  const int c = plan[3 * blockIdx.x + 2];

  if (c < 0) {
    // -- a chunk of one long row --------------------------------------------
    const int s = row_ptr[a] + b * kBudget;
    const int e = min(row_ptr[a + 1], s + kBudget);
    float* out = partials + static_cast<int64_t>(-1 - c) * Qp;
    for (int q0 = 0; q0 < Qp; q0 += kQ) {
      float acc[kQ];
#pragma unroll
      for (int j = 0; j < kQ; ++j) acc[j] = identity<MODE>();
      for (int k = s + tid; k < e; k += kThreads) {
        accumulate<MODE>(acc, xt, Qp, q0, col[k],
                                MODE == kMin ? 0.0f : val[k]);
      }
      butterfly<MODE>(acc, 32);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kQ; ++j) s_part[warp][j] = acc[j];
      }
      __syncthreads();
      if (tid < kQ && q0 + tid < Qp) {
        const float w01 = combine<MODE>(s_part[0][tid], s_part[1][tid]);
        const float w23 = combine<MODE>(s_part[2][tid], s_part[3][tid]);
        const float w45 = combine<MODE>(s_part[4][tid], s_part[5][tid]);
        const float w67 = combine<MODE>(s_part[6][tid], s_part[7][tid]);
        out[q0 + tid] = combine<MODE>(combine<MODE>(w01, w23),
                                      combine<MODE>(w45, w67));
      }
      __syncthreads();
    }
    return;
  }

  // -- a run of rows [a, b), c lanes per row --------------------------------
  const int base = row_ptr[a];
  const int rows = b - a;
  for (int i = tid; i <= rows; i += kThreads) s_ptr[i] = row_ptr[a + i] - base;
  const int slots = row_ptr[b] - base;
  for (int i = tid; i < slots; i += kThreads) {
    s_col[i] = col[base + i];
    if (MODE != kMin) s_val[i] = val[base + i];
  }
  __syncthreads();
  const int lanes = c;
  const int groups = kThreads / lanes;
  const int group = tid / lanes;
  const int sub = tid % lanes;
  for (int first = 0; first < rows; first += groups) {
    const int i = first + group;
    const bool live = i < rows;
    const int s = live ? s_ptr[i] : 0;
    const int e = live ? s_ptr[i + 1] : 0;
    for (int q0 = 0; q0 < Q; q0 += kQ) {
      float acc[kQ];
#pragma unroll
      for (int j = 0; j < kQ; ++j) acc[j] = identity<MODE>();
      for (int k = s + sub; k < e; k += lanes) {
        accumulate<MODE>(acc, xt, Qp, q0, s_col[k],
                                MODE == kMin ? 0.0f : s_val[k]);
      }
      butterfly<MODE>(acc, lanes);
      if (live && sub == 0) {
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          if (q0 + j < Q) y[static_cast<int64_t>(q0 + j) * V + a + i] = acc[j];
        }
      }
    }
  }
}

// One thread per (long row, query): the row's chunk partials in chunk
// order.  long_rows[2 i] is the row, long_rows[2 i + 1] its first partial.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
ell_merge_kernel(const int* __restrict__ row_ptr,
                 const int* __restrict__ long_rows,
                 const float* __restrict__ partials, float* __restrict__ y,
                 int num_long, int Q, int Qp, int V) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<int64_t>(num_long) * Q) return;
  const int i = static_cast<int>(t / Q);
  const int q = static_cast<int>(t % Q);
  const int r = long_rows[2 * i];
  const int p = long_rows[2 * i + 1];
  const int chunks = (row_ptr[r + 1] - row_ptr[r] + kBudget - 1) / kBudget;
  float total = partials[static_cast<int64_t>(p) * Qp + q];
  for (int k = 1; k < chunks; ++k) {
    total = combine<MODE>(total,
                          partials[static_cast<int64_t>(p + k) * Qp + q]);
  }
  y[static_cast<int64_t>(q) * V + r] = total;
}

template <int MODE>
int launch(const int* row_ptr, const int* col, const float* val,
           const float* xt, float* y, const int* plan, int num_blocks,
           const int* long_rows, int num_long, float* partials, int Q,
           int Qp, int V, cudaStream_t st) {
  ell_block_kernel<MODE><<<num_blocks, kThreads, 0, st>>>(
      row_ptr, col, val, xt, y, plan, partials, Q, Qp, V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_long == 0) return static_cast<int>(err);
  const int64_t threads = static_cast<int64_t>(num_long) * Q;
  ell_merge_kernel<MODE><<<static_cast<int>((threads + kThreads - 1) /
                                            kThreads),
                           kThreads, 0, st>>>(row_ptr, long_rows, partials, y,
                                              num_long, Q, Qp, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xt: f32 [x_len, Qp] query-minor, Qp a multiple of 4 >= Q; plan: int32
// [num_blocks, 3] (kernels/ell_spmv.py::row_plan); long_rows: int32
// [num_long, 2]; partials: f32 scratch of the plan's partials x Qp.
extern "C" int ell_spmv_launch(int mode, const int* row_ptr, const int* col,
                               const float* val, const float* xt, float* y,
                               const int* plan, int num_blocks,
                               const int* long_rows, int num_long,
                               float* partials, int Q, int Qp, int V,
                               void* stream) {
  if (Q <= 0 || V <= 0 || Qp < Q || Qp % 4 != 0 || num_blocks <= 0 ||
      num_long < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode != kMin && val == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kPlusTimes:
      return launch<kPlusTimes>(row_ptr, col, val, xt, y, plan, num_blocks,
                                long_rows, num_long, partials, Q, Qp, V, st);
    case kMinPlus:
      return launch<kMinPlus>(row_ptr, col, val, xt, y, plan, num_blocks,
                              long_rows, num_long, partials, Q, Qp, V, st);
    case kMin:
      return launch<kMin>(row_ptr, col, val, xt, y, plan, num_blocks,
                          long_rows, num_long, partials, Q, Qp, V, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The plan's constants, so the host plan and the kernel cannot disagree.
extern "C" int ell_spmv_budget() { return kBudget; }
extern "C" int ell_spmv_run_rows() { return kRunRows; }
extern "C" int ell_spmv_threads() { return kThreads; }

extern "C" const char* ell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
