// Fused BSP superstep compute phase for Hopper (sm_90a): gather the source
// state of every edge, form the algorithm's edge message, and reduce the
// messages over their extended destination ids -- without ever writing the
// [Q, Pl, e_max] message array to device memory.
//
// Replaces repro/kernels/fused_superstep.py::fused_superstep_blocks (the
// Pallas kernel) together with the phase-2 merge of its block partials in
// repro/kernels/ops.py::fused_superstep_op.  The TPU kernel gathers with a
// masked-max one-hot over the whole partition state (no indexed loads
// there) and reduces with a [block_e, span] one-hot contraction, which
// bounds the span a block may cover.  Here:
//
//   * gather: a direct indexed load of state[q, p, k, src[e]];
//   * message: one device form per EdgeMessage kind, chosen by a template
//     argument (the kinds of repro_torch/kernels/fused_superstep.py::KINDS);
//   * reduce: edges are sorted by destination, so within a block the ids
//     base + local are non-decreasing.  Each thread reduces the runs of equal
//     ids among its consecutive edges; runs that cross thread boundaries are
//     joined by a segmented scan over the threads (warp shuffles, then a fold
//     over the block's warps).  A run that lies inside the block is written
//     straight to acc; the block's first and last runs, which may continue
//     into neighbouring blocks (a hub spans many), go to a partials array
//     that a second kernel merges in block order.  No [span] buffer exists,
//     so there is no span limit and no fallback.
//
// Every sum is taken in a fixed order (thread-sequential, a fixed scan
// tree, block order in the merge): the same inputs give the same bits on
// every run.  No float atomics.  Build without fast-math and with
// -fmad=false: BC's backward message divides, and the min kinds are held
// bit for bit against the plain PyTorch version.
//
// Bound on the card: bytes.  One launch reads the topology once (src,
// local, mask [, weight]: 12-16 B per edge slot, shared across the Q
// queries, since a thread block loads its edge block once and loops over
// the queries), gathers K state values per edge and query (K * Q * Pl *
// v_max * 4 B at least once), and writes the Q * Pl * seg * 4 B
// accumulator.  The arithmetic is a few operations per edge and query, far
// below the f32 peak.  On RMAT20 it runs at 4-8 % of this bound (PERF.md).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

enum Kind { kBfs = 0, kSssp = 1, kCc = 2, kPagerank = 3, kBcFwd = 4, kBcBwd = 5 };

template <bool kMin>
__device__ __forceinline__ float combine(float a, float b) {
  if constexpr (kMin) {
    return fminf(a, b);
  } else {
    return __fadd_rn(a, b);
  }
}

// The edge message of each kind, on the gathered source state.  `vs` points
// at the [K, V] state of one (query, partition); `s` is the source vertex.
// The arithmetic mirrors the EdgeMessage.fn of the same kind operation for
// operation (round-to-nearest intrinsics keep nvcc from contracting them).
template <int KIND>
__device__ __forceinline__ float message(const float* __restrict__ vs,
                                         int64_t V, int s, float w,
                                         float step, float c0) {
  if constexpr (KIND == kBfs) {            // gather (level,)
    const float level = vs[s];
    return level == step ? __fadd_rn(level, 1.0f) : CUDART_INF_F;
  } else if constexpr (KIND == kSssp) {    // gather (dist, active)
    return vs[V + s] > 0.0f ? __fadd_rn(vs[s], w) : CUDART_INF_F;
  } else if constexpr (KIND == kCc) {      // gather (label, active)
    return vs[V + s] > 0.0f ? vs[s] : CUDART_INF_F;
  } else if constexpr (KIND == kPagerank) {  // gather (rank, inv_deg)
    return __fmul_rn(vs[s], vs[V + s]);
  } else if constexpr (KIND == kBcFwd) {   // gather (dist, sigma)
    return vs[s] == step ? vs[V + s] : 0.0f;
  } else {                                 // kBcBwd: (dist, sigma, delta)
    const float level = __fsub_rn(__fsub_rn(c0, 1.0f), step);  // c0 = max_level
    const float sigma = vs[V + s];
    const bool sending = (vs[s] == __fadd_rn(level, 1.0f)) && (sigma > 0.0f);
    return sending ? __fdiv_rn(__fadd_rn(1.0f, vs[2 * V + s]),
                               fmaxf(sigma, 1.0f))
                   : 0.0f;
  }
}

// Shared-memory slot of edge i of the block: one pad word per 32 keeps the
// strided per-thread reads (thread t reads edges t*ipt + j) off one bank.
__device__ __forceinline__ int sidx(int i) { return i + (i >> 5); }

// Grid (nb, Pl); one thread block per (partition, edge block), looping over
// the Q queries.  vstate is [Q, Pl, K, V]; acc [Q, Pl, seg] is pre-filled
// with the identity.
// part_id/part_val [Q, Pl, nb, 2] receive each block's first and last run.
template <int KIND>
__global__ void __launch_bounds__(kThreads)
fused_superstep_kernel(const float* __restrict__ vstate,
                       const float* __restrict__ scal,
                       const int* __restrict__ src,
                       const int* __restrict__ local,
                       const int* __restrict__ mask,
                       const float* __restrict__ weight,
                       const int* __restrict__ base,
                       float* __restrict__ acc,
                       int* __restrict__ part_id,
                       float* __restrict__ part_val,
                       int Q, int Pl, int K, int V, int S, int e_pad, int nb,
                       int block_e, int seg) {
  constexpr bool kMin = KIND <= kCc;
  const float ident = kMin ? CUDART_INF_F : 0.0f;

  extern __shared__ int smem[];
  const int padded = block_e + (block_e >> 5);
  int* s_src = smem;
  int* s_id = smem + padded;
  int* s_mask = smem + 2 * padded;
  float* s_w = reinterpret_cast<float*>(smem + 3 * padded);
  __shared__ float s_warp_v[kWarps];
  __shared__ int s_warp_f[kWarps];
  __shared__ float s_run[kThreads];

  const int b = blockIdx.x;
  const int p = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // The edge block: loaded once, coalesced, shared by all Q queries.
  const int64_t e0 = static_cast<int64_t>(p) * e_pad +
                     static_cast<int64_t>(b) * block_e;
  const int blk_base = base[static_cast<int64_t>(p) * nb + b];
  for (int i = t; i < block_e; i += kThreads) {
    s_src[sidx(i)] = src[e0 + i];
    s_id[sidx(i)] = blk_base + local[e0 + i];
    s_mask[sidx(i)] = mask[e0 + i];
    if constexpr (KIND == kSssp) s_w[sidx(i)] = weight[e0 + i];
  }
  __syncthreads();

  const int ipt = block_e / kThreads;      // consecutive edges per thread
  const int i0 = t * ipt;
  const int first_id = s_id[sidx(0)];      // the block's first run
  // A run begins at this thread's first edge / ends at its last edge.
  const bool starts_new = (t == 0) || s_id[sidx(i0)] != s_id[sidx(i0 - 1)];
  const bool ends_run = (t == kThreads - 1) ||
                        s_id[sidx(i0 + ipt - 1)] != s_id[sidx(i0 + ipt)];

  for (int q = 0; q < Q; ++q) {
    const int64_t qp = static_cast<int64_t>(q) * Pl + p;
    const float* vs = vstate + qp * K * static_cast<int64_t>(V);
    const float step = scal[qp * S];
    const float c0 = S > 1 ? scal[qp * S + 1] : 0.0f;
    float* out = acc + qp * seg;
    int* pid = part_id + (qp * nb + b) * 2;
    float* pval = part_val + (qp * nb + b) * 2;

    // 1. Runs among this thread's own edges.  A run bounded by id changes
    //    on both sides inside the thread is owned by it alone.
    int run_id = s_id[sidx(i0)];
    float run_v = ident;
    bool has_break = false;
    int head_id = run_id;
    float head_v = ident;
    for (int j = 0; j < ipt; ++j) {
      const int i = sidx(i0 + j);
      const int id = s_id[i];
      const float w = (KIND == kSssp) ? s_w[i] : 0.0f;
      const float m = s_mask[i] ? message<KIND>(vs, V, s_src[i], w, step, c0)
                                : ident;
      if (id != run_id) {
        if (!has_break) {
          has_break = true;
          head_id = run_id;
          head_v = run_v;
        } else {
          out[run_id] = run_v;
        }
        run_id = id;
        run_v = m;
      } else {
        run_v = combine<kMin>(run_v, m);
      }
    }

    // 2. Segmented inclusive scan over threads of (a run starts in this
    //    thread, value of the run reaching its last edge).  Afterwards v is
    //    the block-local total of run_id up to this thread's last edge.
    bool f = has_break || starts_new;
    float v = run_v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float vu = __shfl_up_sync(kFullMask, v, d);
      const int fu = __shfl_up_sync(kFullMask, static_cast<int>(f), d);
      if (lane >= d) {
        if (!f) v = combine<kMin>(vu, v);
        f = f || fu;
      }
    }
    if (lane == 31) {
      s_warp_v[warp] = v;
      s_warp_f[warp] = f;
    }
    __syncthreads();
    if (warp > 0 && !f) {
      float pv = s_warp_v[0];
      for (int u = 1; u < warp; ++u) {
        pv = s_warp_f[u] ? s_warp_v[u] : combine<kMin>(pv, s_warp_v[u]);
      }
      v = combine<kMin>(pv, v);
    }
    s_run[t] = v;
    __syncthreads();

    // 3. Close the runs that end in this thread.
    if (has_break) {  // the head run ends inside this thread
      const float h = starts_new ? head_v : combine<kMin>(s_run[t - 1], head_v);
      if (head_id == first_id) {
        pid[0] = head_id;
        pval[0] = h;
      } else {
        out[head_id] = h;
      }
    }
    if (ends_run) {   // run_id ends at this thread's last edge
      if (t == kThreads - 1) {
        if (run_id == first_id) {  // one run covers the whole block
          pid[0] = run_id;
          pval[0] = v;
          pid[1] = run_id;
          pval[1] = ident;
        } else {
          pid[1] = run_id;
          pval[1] = v;
        }
      } else if (run_id == first_id) {
        pid[0] = run_id;
        pval[0] = v;
      } else {
        out[run_id] = v;
      }
    }
    __syncthreads();  // s_warp_* and s_run are rewritten by the next query
  }
}

// Merge the blocks' first/last runs in block order.  part ids are
// non-decreasing along each (q, p) row of 2*nb entries; the thread at the
// head of each run of equal ids folds it and writes the segment.
template <bool kMin>
__global__ void merge_partials_kernel(const int* __restrict__ part_id,
                                      const float* __restrict__ part_val,
                                      float* __restrict__ acc, int n2,
                                      int seg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const int64_t qp = blockIdx.y;
  const int* ids = part_id + qp * n2;
  const float* vals = part_val + qp * n2;
  const int id = ids[i];
  if (i > 0 && ids[i - 1] == id) return;
  float v = vals[i];
  for (int j = i + 1; j < n2 && ids[j] == id; ++j) v = combine<kMin>(v, vals[j]);
  acc[qp * seg + id] = v;
}

template <int KIND>
cudaError_t launch(const float* vstate, const float* scal, const int* src,
                   const int* local, const int* mask, const float* weight,
                   const int* base, float* acc, int* part_id, float* part_val,
                   int Q, int Pl, int K, int V, int S, int e_pad, int nb,
                   int block_e, int seg, cudaStream_t stream) {
  const size_t smem = 4u * static_cast<size_t>(block_e + (block_e >> 5)) *
                      sizeof(int);
  if (smem > 48u * 1024u) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_superstep_kernel<KIND>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(nb, Pl);
  fused_superstep_kernel<KIND><<<grid, kThreads, smem, stream>>>(
      vstate, scal, src, local, mask, weight, base, acc, part_id, part_val,
      Q, Pl, K, V, S, e_pad, nb, block_e, seg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n2 = 2 * nb;
  const dim3 mgrid((n2 + 255) / 256, Q * Pl);
  merge_partials_kernel<(KIND <= kCc)><<<mgrid, 256, 0, stream>>>(
      part_id, part_val, acc, n2, seg);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_superstep_launch(
    int kind, const float* vstate, const float* scal, const int* src,
    const int* local, const int* mask, const float* weight, const int* base,
    float* acc, int* part_id, float* part_val, int Q, int Pl, int K, int V,
    int S, int e_pad, int nb, int block_e, int seg, void* stream) {
  if (block_e <= 0 || block_e % kThreads != 0 || nb <= 0 || Q <= 0 ||
      Pl <= 0 || Q * Pl > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(KIND)                                                  \
  launch<KIND>(vstate, scal, src, local, mask, weight, base, acc, part_id,  \
               part_val, Q, Pl, K, V, S, e_pad, nb, block_e, seg, st)
  cudaError_t err;
  switch (kind) {
    case kBfs: err = REPRO_LAUNCH(kBfs); break;
    case kSssp: err = REPRO_LAUNCH(kSssp); break;
    case kCc: err = REPRO_LAUNCH(kCc); break;
    case kPagerank: err = REPRO_LAUNCH(kPagerank); break;
    case kBcFwd: err = REPRO_LAUNCH(kBcFwd); break;
    case kBcBwd: err = REPRO_LAUNCH(kBcBwd); break;
    default: err = cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
  return static_cast<int>(err);
}

extern "C" const char* fused_superstep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
