// Bottom-up (pull) scan of direction-optimized traversal for Hopper (sm_90a):
// every destination row scans its in-neighbours' messages and keeps the
// minimum, and reports how many slots a sequential scan of the row examines.
//
// Replaces repro/kernels/bottomup.py::bottomup_scan (the Pallas kernel,
// reached through repro/kernels/ops.py::bottomup_scan_op).  The TPU kernel
// reads a dense ELL block [V, kmax] whose width is the largest in-degree,
// gathers the whole block with jnp.take and reduces every slot.  Here the
// rows are CSR with no padding slots (on a scale-free graph one hub's
// in-degree would set the width of every row of an ELL block), and the
// kernel has the sparse-stage kernel's design (ell_spmv.cu) plus the count
// and the early exit:
//
//   * a row plan, made once per row set on the host
//     (kernels/ell_spmv.py::row_plan), cuts the rows into blocks of work.
//     Runs: consecutive rows whose slots fit kBudget (at most kRunRows
//     rows), staged into shared memory with coalesced loads, then groups of
//     L lanes (L chosen by the plan) take the run's rows in turn; lane i of
//     a group reads slots i, i + L, ... of its row.  Chunks: a row longer
//     than kBudget gets one block per kBudget slots, each thread reading
//     slots tid, tid + kThreads, ...; a second kernel folds each long row's
//     chunk minima and first hits in chunk order;
//   * x is read query-minor: xt [x_len, Qp], Qp = Q rounded up to a
//     multiple of 4, so one slot's 8 queries are one or two 16-byte loads
//     from one 32-byte sector, and row_ptr, col and val are read once per
//     launch for all the queries of a pass (kQ = 8), where a query-major
//     grid reads them once per query;
//   * early exit (MODE kMinEarly), for 8 queries at once: for
//     frontier-uniform programs (BFS) every live message of a superstep
//     holds the same value, so the first live slot of a row is the row
//     minimum.  The lanes of a row move through it in lock-step strides of L
//     slots; after each stride a ballot per query gives the lowest lane that
//     hit it, and the row stops once every query of the pass has a hit.  At
//     that point each query's first hit is known exactly, so scanned stays
//     exact (min(first + 1, n)) even where the row was read further for
//     another query.  A chunk stops on the hits it has seen itself (a block
//     vote per stride); the fold takes the first chunk, in order, that hit.
//     y is the minimum over the slots read, which under the caller's
//     uniformity licence (ops.bottomup_scan_op states it) is the first live
//     value.  Without early exit every slot is read.
//
// Outputs per (query, row): y = min over the row's slots of x[col] (plus
// val for min_plus), +inf for an empty row; scanned = slots up to and
// including the first live one (early exit), else the row's length.  Both
// [Q, V], consecutive rows of one query at consecutive addresses.  A min is
// exact in any order, so y is bit-equal to the plain PyTorch version.  No
// float atomics.  Built without fast-math and with -fmad=false.
//
// Bound on the card: bytes.  One launch reads row_ptr once, the col (and
// val) slots the scans reach, x once and writes y and scanned; a compare
// (and an add) per slot and query is far below the f32 peak.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBudget = 2048;        // slots staged by a run, or one chunk
constexpr int kRunRows = 512;        // most rows of one run
constexpr int kQ = 8;                // queries per pass
constexpr int kNone = 0x7fffffff;    // no hit yet
constexpr unsigned kFullMask = 0xffffffffu;

enum Mode { kMin = 0, kMinEarly = 1, kMinPlus = 2 };

// One slot's messages for the 8 queries of a pass: one or two 16-byte loads
// of row c of xt (plus the slot's value for min_plus).  Lanes past the
// loads are +inf.
template <int MODE>
__device__ __forceinline__ void load_slot(float (&m)[kQ],
                                          const float* __restrict__ xt,
                                          int Qp, int q0, int c, float w) {
  const float4* row =
      reinterpret_cast<const float4*>(xt + static_cast<int64_t>(c) * Qp + q0);
  const float4 a = __ldg(row);
  const float4 b = q0 + 4 < Qp ? __ldg(row + 1)
                               : make_float4(CUDART_INF_F, CUDART_INF_F,
                                             CUDART_INF_F, CUDART_INF_F);
  m[0] = a.x; m[1] = a.y; m[2] = a.z; m[3] = a.w;
  m[4] = b.x; m[5] = b.y; m[6] = b.z; m[7] = b.w;
  if constexpr (MODE == kMinPlus) {
#pragma unroll
    for (int j = 0; j < kQ; ++j) m[j] = __fadd_rn(m[j], w);
  }
}

// Minimum over groups of `lanes` lanes (a power of two, <= 32); every lane
// of the warp takes part.
__device__ __forceinline__ void butterfly(float (&acc)[kQ], int lanes) {
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    for (int d = lanes / 2; d > 0; d >>= 1) {
      acc[j] = fminf(acc[j], __shfl_xor_sync(kFullMask, acc[j], d));
    }
  }
}

// One block per plan entry (first, second, third):
//   run   (r0, r1, L):  rows [r0, r1), L lanes per row;
//   chunk (r, c, -1 - p): slots [c * kBudget, (c + 1) * kBudget) of row r,
//                         its minima and first hits to partials p.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
scan_block_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                  const float* __restrict__ val, const float* __restrict__ xt,
                  float* __restrict__ y, int* __restrict__ scanned,
                  const int* __restrict__ plan, float* __restrict__ part_y,
                  int* __restrict__ part_first, int Q, int Qp, int V) {
  constexpr bool kEarly = MODE == kMinEarly;
  constexpr bool kVal = MODE == kMinPlus;
  __shared__ int s_col[kBudget];
  __shared__ float s_val[kVal ? kBudget : 1];
  __shared__ int s_ptr[kRunRows + 1];
  __shared__ float s_part[kWarps][kQ];
  __shared__ int s_first[kWarps][kQ];
  __shared__ unsigned s_hits[2][kWarps];
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
    const int off = b * kBudget - s;       // slot k is index k + off of the row
    float* out_y = part_y + static_cast<int64_t>(-1 - c) * Qp;
    int* out_first = part_first + static_cast<int64_t>(-1 - c) * Qp;
    for (int q0 = 0; q0 < Q; q0 += kQ) {
      const int nq = min(kQ, Q - q0);
      const unsigned want = (1u << nq) - 1u;
      float acc[kQ];
      int first[kQ];
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        acc[j] = CUDART_INF_F;
        first[j] = kNone;
      }
      unsigned hits = 0;                   // queries this thread has hit
      int turn = 0;
      for (int k0 = s; k0 < e; k0 += kThreads) {
        const int k = k0 + tid;
        if (k < e) {
          float m[kQ];
          load_slot<MODE>(m, xt, Qp, q0, col[k], kVal ? val[k] : 0.0f);
#pragma unroll
          for (int j = 0; j < kQ; ++j) {
            acc[j] = fminf(acc[j], m[j]);
            if (kEarly && m[j] < CUDART_INF_F && first[j] == kNone) {
              first[j] = k + off;
              hits |= 1u << j;
            }
          }
        }
        if constexpr (kEarly) {
          // a block vote: stop once every query of the pass has a hit among
          // the slots read so far (double-buffered, one barrier a stride)
          const unsigned wh = __reduce_or_sync(kFullMask, hits);
          if (lane == 0) s_hits[turn][warp] = wh;
          __syncthreads();
          unsigned all = 0;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) all |= s_hits[turn][w];
          turn ^= 1;
          if ((all & want) == want) break;
        }
      }
      // the chunk's minimum and first hit per query: warps, then 8 warps
      butterfly(acc, 32);
      if constexpr (kEarly) {
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          first[j] = __reduce_min_sync(kFullMask, first[j]);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          s_part[warp][j] = acc[j];
          s_first[warp][j] = first[j];
        }
      }
      __syncthreads();
      if (tid < nq) {
        float m = s_part[0][tid];
        int f = s_first[0][tid];
        for (int w = 1; w < kWarps; ++w) {
          m = fminf(m, s_part[w][tid]);
          f = min(f, s_first[w][tid]);
        }
        out_y[q0 + tid] = m;
        out_first[q0 + tid] = f;
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
    if constexpr (kVal) s_val[i] = val[base + i];
  }
  __syncthreads();
  const int lanes = c;
  const int groups = kThreads / lanes;
  const int group = tid / lanes;
  const int sub = tid % lanes;
  // this lane's group within its warp, for the ballots
  const unsigned gmask = lanes == 32 ? kFullMask : (1u << lanes) - 1u;
  const int gshift = (group * lanes) & 31;
  for (int r0 = 0; r0 < rows; r0 += groups) {
    const int i = r0 + group;
    const bool live = i < rows;
    const int s = live ? s_ptr[i] : 0;
    const int n = live ? s_ptr[i + 1] - s : 0;
    for (int q0 = 0; q0 < Q; q0 += kQ) {
      const int nq = min(kQ, Q - q0);
      float acc[kQ];
      int first[kQ];
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        acc[j] = CUDART_INF_F;
        first[j] = kNone;
      }
      if constexpr (kEarly) {
        // lock-step strides of L slots; the warp runs until each of its
        // groups has a hit for every query of the pass or its row ends
        bool active = n > 0;
        for (int k0 = 0; __any_sync(kFullMask, active); k0 += lanes) {
          const int k = k0 + sub;
          const bool read = active && k < n;
          float m[kQ];
          if (read) {
            load_slot<MODE>(m, xt, Qp, q0, s_col[s + k], 0.0f);
          }
          bool done = true;
#pragma unroll
          for (int j = 0; j < kQ; ++j) {
            const bool hit = read && m[j] < CUDART_INF_F;
            if (read) acc[j] = fminf(acc[j], m[j]);
            const unsigned got = (__ballot_sync(kFullMask, hit) >> gshift) &
                                 gmask;
            if (first[j] == kNone && got != 0u) first[j] = k0 + __ffs(got) - 1;
            done = done && (j >= nq || first[j] != kNone);
          }
          active = active && !done && k0 + lanes < n;
        }
      } else {
        for (int k = s + sub; k < s + n; k += lanes) {
          float m[kQ];
          load_slot<MODE>(m, xt, Qp, q0, s_col[k], kVal ? s_val[k] : 0.0f);
#pragma unroll
          for (int j = 0; j < kQ; ++j) acc[j] = fminf(acc[j], m[j]);
        }
      }
      butterfly(acc, lanes);
      if (live && sub == 0) {
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          if (j < nq) {
            const int64_t at = static_cast<int64_t>(q0 + j) * V + a + i;
            y[at] = acc[j];
            scanned[at] = kEarly ? min(first[j] == kNone ? n : first[j] + 1, n)
                                 : n;
          }
        }
      }
    }
  }
}

// One thread per (long row, query): the row's chunk minima in chunk order,
// and the first chunk that hit.  long_rows[2 i] is the row,
// long_rows[2 i + 1] its first partial.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
scan_merge_kernel(const int* __restrict__ row_ptr,
                  const int* __restrict__ long_rows,
                  const float* __restrict__ part_y,
                  const int* __restrict__ part_first, float* __restrict__ y,
                  int* __restrict__ scanned, int num_long, int Q, int Qp,
                  int V) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<int64_t>(num_long) * Q) return;
  const int i = static_cast<int>(t / Q);
  const int q = static_cast<int>(t % Q);
  const int r = long_rows[2 * i];
  const int p = long_rows[2 * i + 1];
  const int n = row_ptr[r + 1] - row_ptr[r];
  const int chunks = (n + kBudget - 1) / kBudget;
  float best = CUDART_INF_F;
  int first = kNone;
  for (int k = 0; k < chunks; ++k) {
    const int64_t at = static_cast<int64_t>(p + k) * Qp + q;
    best = fminf(best, part_y[at]);
    if (first == kNone) first = part_first[at];
  }
  const int64_t out = static_cast<int64_t>(q) * V + r;
  y[out] = best;
  scanned[out] = MODE == kMinEarly ? min(first == kNone ? n : first + 1, n)
                                   : n;
}

template <int MODE>
int launch(const int* row_ptr, const int* col, const float* val,
           const float* xt, float* y, int* scanned, const int* plan,
           int num_blocks, const int* long_rows, int num_long, float* part_y,
           int* part_first, int Q, int Qp, int V, cudaStream_t st) {
  scan_block_kernel<MODE><<<num_blocks, kThreads, 0, st>>>(
      row_ptr, col, val, xt, y, scanned, plan, part_y, part_first, Q, Qp, V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_long == 0) return static_cast<int>(err);
  const int64_t threads = static_cast<int64_t>(num_long) * Q;
  scan_merge_kernel<MODE><<<static_cast<int>((threads + kThreads - 1) /
                                             kThreads),
                            kThreads, 0, st>>>(row_ptr, long_rows, part_y,
                                               part_first, y, scanned,
                                               num_long, Q, Qp, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xt: f32 [x_len, Qp] query-minor (16-byte aligned, Qp a multiple of 4 and
// >= Q); plan: int32 [num_blocks, 3] (kernels/ell_spmv.py::row_plan);
// long_rows: int32 [num_long, 2]; part_y f32 and part_first int32: scratch
// of the plan's partials x Qp; y f32 and scanned int32 [Q, V].
extern "C" int bottomup_scan_launch(int mode, const int* row_ptr,
                                    const int* col, const float* val,
                                    const float* xt, float* y, int* scanned,
                                    const int* plan, int num_blocks,
                                    const int* long_rows, int num_long,
                                    float* part_y, int* part_first, int Q,
                                    int Qp, int V, void* stream) {
  if (Q <= 0 || V <= 0 || Qp < Q || Qp % 4 != 0 || num_blocks <= 0 ||
      num_long < 0 || reinterpret_cast<uintptr_t>(xt) % 16 != 0 ||
      (mode == kMinPlus && val == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kMin:
      return launch<kMin>(row_ptr, col, val, xt, y, scanned, plan, num_blocks,
                          long_rows, num_long, part_y, part_first, Q, Qp, V,
                          st);
    case kMinEarly:
      return launch<kMinEarly>(row_ptr, col, val, xt, y, scanned, plan,
                               num_blocks, long_rows, num_long, part_y,
                               part_first, Q, Qp, V, st);
    case kMinPlus:
      return launch<kMinPlus>(row_ptr, col, val, xt, y, scanned, plan,
                              num_blocks, long_rows, num_long, part_y,
                              part_first, Q, Qp, V, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The plan's constants, so the host plan and the kernel cannot disagree.
extern "C" int bottomup_scan_budget() { return kBudget; }
extern "C" int bottomup_scan_run_rows() { return kRunRows; }
extern "C" int bottomup_scan_threads() { return kThreads; }

extern "C" const char* bottomup_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
