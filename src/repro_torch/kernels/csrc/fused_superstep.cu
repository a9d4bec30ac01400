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
//   * state query-minor: vt [Pl, K, V, Qp], Qp = Q rounded up to a
//     multiple of 4.  One edge's queries of one gathered array lie in one
//     32-byte sector, so a thread takes them with one or two 16-byte
//     loads (two at Q=8) instead of one 4-byte request per query;
//   * all queries in one pass: a block walks its edges once for each group
//     of kGroup (8) queries and carries kGroup values through every step.
//     Each thread issues the loads of a batch of its edges (kBatch, by the
//     number of gathered arrays) before it forms their messages;
//   * message: one device form per EdgeMessage kind, chosen by a template
//     argument (the kinds of repro_torch/kernels/fused_superstep.py::KINDS);
//   * reduce: edges are sorted by destination, so within a block the ids
//     base + local are non-decreasing.  Each thread reduces the runs of equal
//     ids among its consecutive edges; runs that cross thread boundaries are
//     joined by a segmented scan over the threads (warp shuffles, then a fold
//     over the block's warps).  The run structure depends on the topology
//     alone, so the walk, the scan and the fold run once per query group
//     with one flag for kGroup values: three barriers per group, not per
//     query.  A run that lies inside the block is written straight to acc;
//     the block's first and last runs, which may continue into
//     neighbouring blocks (a hub spans many), go to a partials array that a
//     second kernel merges in block order.  Their ids do not depend on the
//     query ([Pl, nb, 2]); their values do ([Q, Pl, nb, 2]).  No [span]
//     buffer exists, so there is no span limit and no fallback.
//
// Every sum is taken in a fixed order, the same for each query as when the
// kernel looped over queries: thread-sequential over the thread's
// block_e / 128 edges, the 5-level shuffle scan, the fold over 4 warps, one
// carry, blocks in order in the merge.  The same inputs give the same bits
// on every run.  No float atomics.  Build without fast-math and with
// -fmad=false: BC's backward message divides, and the min kinds are held
// bit for bit against the plain PyTorch version.
//
// Bound on the card: bytes.  One launch reads the topology once (src,
// local, mask [, weight]: 12-16 B per edge slot, shared across the Q
// queries), gathers K state values per vertex and query (K * Qp * Pl *
// v_max * 4 B at least once), and writes the Q * Pl * seg * 4 B
// accumulator.  The arithmetic is a few operations per edge and query, far
// below the f32 peak.  The gathers are random (sources of a destination-
// sorted edge list), so the design cuts the requests per edge from K * Q to
// K * Qp / 4 and keeps a batch of them in flight per thread.
//
// Registers: 80-96 a thread.  The first build, with twice the batches
// below, held kBfs at 128 registers with 20 bytes of spill stores (8 edges
// x 8 queries of gathered state beside the run, head and step values);
// kBfs still spills 8 bytes at 96.  The kBcBwd division (__fdiv_rn, a
// subroutine call for its slow path) does not spill.  chip_smoke.py prints
// each kernel's registers and spill stores and holds the library to at most
// 40 bytes.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;                 // queries carried together
constexpr unsigned kFullMask = 0xffffffffu;

enum Kind {
  kBfs = 0, kSssp = 1, kCc = 2, kPagerank = 3, kBcFwd = 4, kBcBwd = 5,
  kBfsRelax = 6
};

// Kinds that combine by min (the rest sum).
template <int KIND>
constexpr bool kIsMin = KIND <= kCc || KIND == kBfsRelax;

// Gathered state arrays of each kind, and the edges whose loads one thread
// issues together (kBatch * kGather * 8 floats in flight per thread).
// Twice these batches ran 1-16 % slower at RMAT20 (scripts/
// fused_ablation.py, batch_x2).
template <int KIND>
struct Spec {
  static constexpr int kGather = KIND == kBfs ? 1 : (KIND == kBcBwd ? 3 : 2);
  static constexpr int kBatch = kGather == 1 ? 4 : (kGather == 2 ? 2 : 1);
};

template <bool kMin>
__device__ __forceinline__ float combine(float a, float b) {
  if constexpr (kMin) {
    return fminf(a, b);
  } else {
    return __fadd_rn(a, b);
  }
}

// The edge message of each kind for one query, on the gathered source
// state g0, g1, g2 (the kind's gathered arrays in order).  The arithmetic
// mirrors the EdgeMessage.fn of the same kind operation for operation
// (round-to-nearest intrinsics keep nvcc from contracting them).
template <int KIND>
__device__ __forceinline__ float message(float g0, float g1, float g2,
                                         float w, float step, float c0) {
  if constexpr (KIND == kBfs) {            // gather (level,)
    return g0 == step ? __fadd_rn(g0, 1.0f) : CUDART_INF_F;
  } else if constexpr (KIND == kSssp) {    // gather (dist, active)
    return g1 > 0.0f ? __fadd_rn(g0, w) : CUDART_INF_F;
  } else if constexpr (KIND == kCc) {      // gather (label, active)
    return g1 > 0.0f ? g0 : CUDART_INF_F;
  } else if constexpr (KIND == kBfsRelax) {  // gather (level, active)
    return g1 > 0.0f ? __fadd_rn(g0, 1.0f) : CUDART_INF_F;
  } else if constexpr (KIND == kPagerank) {  // gather (rank, inv_deg)
    return __fmul_rn(g0, g1);
  } else if constexpr (KIND == kBcFwd) {   // gather (dist, sigma)
    return g0 == step ? g1 : 0.0f;
  } else {                                 // kBcBwd: (dist, sigma, delta)
    const float level = __fsub_rn(__fsub_rn(c0, 1.0f), step);  // c0 = max_level
    const bool sending = (g0 == __fadd_rn(level, 1.0f)) && (g1 > 0.0f);
    return sending ? __fdiv_rn(__fadd_rn(1.0f, g2), fmaxf(g1, 1.0f)) : 0.0f;
  }
}

// One edge's kGroup queries of one gathered array: nvec (1 or 2) 16-byte
// loads from the query-minor row; lanes past them are 0 (padding, never
// written out).
__device__ __forceinline__ void load_group(const float* __restrict__ row,
                                           int nvec, float (&v)[kGroup]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4 lo = __ldg(r4);
  const float4 hi = nvec > 1 ? __ldg(r4 + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// Index of (query q, partition p, segment id) in acc [Q, Pl, seg].
__device__ __forceinline__ int64_t acc_at(int q, int p, int id, int Pl,
                                          int seg, int Qp) {
  return (static_cast<int64_t>(q) * Pl + p) * seg + id;
}

// Write a run's value for L lanes of a group, starting at query q: the
// real queries only.
template <int L>
__device__ __forceinline__ void store_group(float* __restrict__ acc, int q,
                                            int Q, int Qp, int Pl, int p,
                                            int seg, int id, const float* v) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (q + j < Q) acc[acc_at(q + j, p, id, Pl, seg, Qp)] = v[j];
  }
}

// Shared-memory slot of edge i of the block: one pad word per 32 keeps the
// strided per-thread reads (thread t reads edges t*ipt + j) off one bank.
__device__ __forceinline__ int sidx(int i) { return i + (i >> 5); }

// What one thread knows of its runs, the same for every query group.
struct Runs {
  int t, lane, warp;
  bool starts_new;   // a run begins at this thread's first edge
  bool ends_run;     // run_id ends at this thread's last edge
  bool has_break;    // an id changes inside this thread
  int head_id;       // the run that reaches this thread's first edge
  int run_id;        // the run that reaches its last edge
  int first_id;      // the block's first run
};

// Steps 2 and 3 for L lanes [l0, l0 + L) of a group: the segmented scan
// over threads (one flag for the L values), the fold over warps, and the
// writes of the runs that end in this thread.  Three barriers.
template <bool kMin, int L>
__device__ __forceinline__ void scan_and_close(
    const Runs& r, int l0, const float (&run_v)[kGroup],
    const float (&head_v)[kGroup], float (*s_warp_v)[kWarps], int* s_warp_f,
    float (*s_run)[kThreads], float* __restrict__ acc, int* __restrict__ pid,
    float* __restrict__ part_val, int q0, int Q, int Qp, int Pl, int p,
    int nb, int b, int seg) {
  const float kIdent = kMin ? CUDART_INF_F : 0.0f;
  // Segmented inclusive scan over threads of (a run starts in this thread,
  // value of the run reaching its last edge).  Afterwards v is the
  // block-local total of run_id up to this thread's last edge.
  bool f = r.has_break || r.starts_new;
  float v[L];
#pragma unroll
  for (int j = 0; j < L; ++j) v[j] = run_v[l0 + j];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    float vu[L];
#pragma unroll
    for (int j = 0; j < L; ++j) vu[j] = __shfl_up_sync(kFullMask, v[j], d);
    const int fu = __shfl_up_sync(kFullMask, static_cast<int>(f), d);
    if (r.lane >= d) {
      if (!f) {
#pragma unroll
        for (int j = 0; j < L; ++j) v[j] = combine<kMin>(vu[j], v[j]);
      }
      f = f || fu;
    }
  }
  if (r.lane == 31) {
#pragma unroll
    for (int j = 0; j < L; ++j) s_warp_v[l0 + j][r.warp] = v[j];
    s_warp_f[r.warp] = f;
  }
  __syncthreads();
  if (r.warp > 0 && !f) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      float pv = s_warp_v[l0 + j][0];
      for (int u = 1; u < r.warp; ++u) {
        pv = s_warp_f[u] ? s_warp_v[l0 + j][u]
                         : combine<kMin>(pv, s_warp_v[l0 + j][u]);
      }
      v[j] = combine<kMin>(pv, v[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < L; ++j) s_run[l0 + j][r.t] = v[j];
  __syncthreads();

  // Close the runs that end in this thread.  pval points at query q's
  // [nb, 2] partials of this block: slot 0 the first run, 1 the last.
  auto partial = [&](int slot, int id, const float* val) {
    pid[slot] = id;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int q = q0 + l0 + j;
      if (q < Q) {
        part_val[((static_cast<int64_t>(q) * Pl + p) * nb + b) * 2 + slot] =
            val[j];
      }
    }
  };
  if (r.has_break) {  // the head run ends inside this thread
    float h[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      h[j] = r.starts_new ? head_v[l0 + j]
                          : combine<kMin>(s_run[l0 + j][r.t - 1],
                                          head_v[l0 + j]);
    }
    if (r.head_id == r.first_id) {
      partial(0, r.head_id, h);
    } else {
      store_group<L>(acc, q0 + l0, Q, Qp, Pl, p, seg, r.head_id, h);
    }
  }
  if (r.ends_run) {   // run_id ends at this thread's last edge
    if (r.t == kThreads - 1) {
      if (r.run_id == r.first_id) {  // one run covers the whole block
        float idv[L];
#pragma unroll
        for (int j = 0; j < L; ++j) idv[j] = kIdent;
        partial(0, r.run_id, v);
        partial(1, r.run_id, idv);
      } else {
        partial(1, r.run_id, v);
      }
    } else if (r.run_id == r.first_id) {
      partial(0, r.run_id, v);
    } else {
      store_group<L>(acc, q0 + l0, Q, Qp, Pl, p, seg, r.run_id, v);
    }
  }
  __syncthreads();  // s_warp_* and s_run are rewritten by the next lanes
}

// Grid (nb, Pl); one thread block per (partition, edge block), looping over
// the query groups.  vt is [Pl, K, V, Qp]; acc [Q, Pl, seg] is pre-filled
// with the identity.  part_id [Pl, nb, 2] and part_val [Q, Pl, nb, 2]
// receive each block's first and last run.
template <int KIND>
__global__ void __launch_bounds__(kThreads)
fused_superstep_kernel(const float* __restrict__ vt,
                       const float* __restrict__ scal,
                       const int* __restrict__ src,
                       const int* __restrict__ local,
                       const int* __restrict__ mask,
                       const float* __restrict__ weight,
                       const int* __restrict__ base,
                       float* __restrict__ acc,
                       int* __restrict__ part_id,
                       float* __restrict__ part_val,
                       int Q, int Qp, int Pl, int V, int S, int e_pad, int nb,
                       int block_e, int seg) {
  constexpr bool kMin = kIsMin<KIND>;
  constexpr int K = Spec<KIND>::kGather;
  constexpr int kB = Spec<KIND>::kBatch;
  const float kIdent = kMin ? CUDART_INF_F : 0.0f;

  extern __shared__ int smem[];
  const int padded = block_e + (block_e >> 5);
  int* s_src = smem;
  int* s_id = smem + padded;
  int* s_mask = smem + 2 * padded;
  float* s_w = reinterpret_cast<float*>(smem + 3 * padded);
  __shared__ float s_warp_v[kGroup][kWarps];
  __shared__ int s_warp_f[kWarps];
  __shared__ float s_run[kGroup][kThreads];

  const int b = blockIdx.x;
  const int p = blockIdx.y;
  Runs r;
  r.t = threadIdx.x;
  r.lane = r.t & 31;
  r.warp = r.t >> 5;

  // The edge block: loaded once, coalesced, shared by all Q queries.
  const int64_t e0 = static_cast<int64_t>(p) * e_pad +
                     static_cast<int64_t>(b) * block_e;
  const int blk_base = base[static_cast<int64_t>(p) * nb + b];
  for (int i = r.t; i < block_e; i += kThreads) {
    s_src[sidx(i)] = src[e0 + i];
    s_id[sidx(i)] = blk_base + local[e0 + i];
    s_mask[sidx(i)] = mask[e0 + i];
    if constexpr (KIND == kSssp) s_w[sidx(i)] = weight[e0 + i];
  }
  __syncthreads();

  const int ipt = block_e / kThreads;      // consecutive edges per thread
  const int i0 = r.t * ipt;
  r.first_id = s_id[sidx(0)];
  r.starts_new = (r.t == 0) || s_id[sidx(i0)] != s_id[sidx(i0 - 1)];
  r.ends_run = (r.t == kThreads - 1) ||
               s_id[sidx(i0 + ipt - 1)] != s_id[sidx(i0 + ipt)];
  const float* vp = vt + static_cast<int64_t>(p) * K * V * Qp;
  int* pid = part_id + (static_cast<int64_t>(p) * nb + b) * 2;

  for (int q0 = 0; q0 < Q; q0 += kGroup) {
    const int nvec = Qp - q0 >= 8 ? 2 : 1;
    float step[kGroup], c0[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int64_t qp = static_cast<int64_t>(min(q0 + j, Q - 1)) * Pl + p;
      step[j] = scal[qp * S];
      c0[j] = S > 1 ? scal[qp * S + 1] : 0.0f;
    }

    // 1. Runs among this thread's own edges.  A run bounded by id changes
    //    on both sides inside the thread is owned by it alone.
    r.run_id = s_id[sidx(i0)];
    r.has_break = false;
    r.head_id = r.run_id;
    float run_v[kGroup], head_v[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) run_v[j] = head_v[j] = kIdent;
    for (int j0 = 0; j0 < ipt; j0 += kB) {
      // the batch's loads, all issued before any message is formed
      float g[kB][K][kGroup];
#pragma unroll
      for (int e = 0; e < kB; ++e) {
        const int i = sidx(i0 + j0 + e);
        const bool live = j0 + e < ipt && s_mask[i];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (live) {
            load_group(vp + (static_cast<int64_t>(k) * V + s_src[i]) * Qp + q0,
                       nvec, g[e][k]);
          } else {
#pragma unroll
            for (int j = 0; j < kGroup; ++j) g[e][k][j] = 0.0f;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < kB; ++e) {
        if (j0 + e < ipt) {
          const int i = sidx(i0 + j0 + e);
          const int id = s_id[i];
          const bool live = s_mask[i] != 0;
          const float w = (KIND == kSssp) ? s_w[i] : 0.0f;
          float m[kGroup];
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            m[j] = live ? message<KIND>(g[e][0][j], g[e][K > 1 ? 1 : 0][j],
                                        g[e][K > 2 ? 2 : 0][j], w, step[j],
                                        c0[j])
                        : kIdent;
          }
          if (id != r.run_id) {
            if (!r.has_break) {
              r.has_break = true;
              r.head_id = r.run_id;
#pragma unroll
              for (int j = 0; j < kGroup; ++j) head_v[j] = run_v[j];
            } else {
              store_group<kGroup>(acc, q0, Q, Qp, Pl, p, seg, r.run_id,
                                  run_v);
            }
            r.run_id = id;
#pragma unroll
            for (int j = 0; j < kGroup; ++j) run_v[j] = m[j];
          } else {
#pragma unroll
            for (int j = 0; j < kGroup; ++j) {
              run_v[j] = combine<kMin>(run_v[j], m[j]);
            }
          }
        }
      }
    }

    // 2-3. The scan over threads and the closing writes, once for the
    //      group's kGroup queries.
    scan_and_close<kMin, kGroup>(r, 0, run_v, head_v, s_warp_v, s_warp_f,
                                 s_run, acc, pid, part_val, q0, Q, Qp, Pl, p,
                                 nb, b, seg);
  }
}

// Merge the blocks' first/last runs in block order.  part ids are
// non-decreasing along each partition's row of 2*nb entries; the thread at
// the head of each run of equal ids folds it and writes the segment.
template <bool kMin>
__global__ void merge_partials_kernel(const int* __restrict__ part_id,
                                      const float* __restrict__ part_val,
                                      float* __restrict__ acc, int n2, int Pl,
                                      int seg, int Qp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const int qp = blockIdx.y;               // q * Pl + p
  const int q = qp / Pl;
  const int p = qp % Pl;
  const int* ids = part_id + static_cast<int64_t>(p) * n2;
  const float* vals = part_val + static_cast<int64_t>(qp) * n2;
  const int id = ids[i];
  if (i > 0 && ids[i - 1] == id) return;
  float v = vals[i];
  for (int j = i + 1; j < n2 && ids[j] == id; ++j) v = combine<kMin>(v, vals[j]);
  acc[acc_at(q, p, id, Pl, seg, Qp)] = v;
}

template <int KIND>
cudaError_t launch(const float* vt, const float* scal, const int* src,
                   const int* local, const int* mask, const float* weight,
                   const int* base, float* acc, int* part_id, float* part_val,
                   int Q, int Qp, int Pl, int K, int V, int S, int e_pad,
                   int nb, int block_e, int seg, cudaStream_t stream) {
  if (K != Spec<KIND>::kGather) return cudaErrorInvalidValue;
  const size_t smem = 4u * static_cast<size_t>(block_e + (block_e >> 5)) *
                      sizeof(int);
  if (smem > 32u * 1024u) {   // past what the 48 KB default leaves it
    cudaError_t err = cudaFuncSetAttribute(
        fused_superstep_kernel<KIND>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(nb, Pl);
  fused_superstep_kernel<KIND><<<grid, kThreads, smem, stream>>>(
      vt, scal, src, local, mask, weight, base, acc, part_id, part_val,
      Q, Qp, Pl, V, S, e_pad, nb, block_e, seg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n2 = 2 * nb;
  const dim3 mgrid((n2 + 255) / 256, Q * Pl);
  merge_partials_kernel<kIsMin<KIND>><<<mgrid, 256, 0, stream>>>(
      part_id, part_val, acc, n2, Pl, seg, Qp);
  return cudaGetLastError();
}

}  // namespace

// vt: f32 [Pl, K, V, Qp] (query-minor, 16-byte aligned, Qp a multiple of 4
// and >= Q); scal f32 [Q, Pl, S]; src/local/mask int32 [Pl, e_pad]; weight
// f32 [Pl, e_pad] (sssp) or null; base int32 [Pl, nb]; acc f32 [Q, Pl, seg]
// pre-filled with the identity; part_id int32 [Pl, nb, 2] and part_val f32
// [Q, Pl, nb, 2] scratch.
extern "C" int fused_superstep_launch(
    int kind, const float* vt, const float* scal, const int* src,
    const int* local, const int* mask, const float* weight, const int* base,
    float* acc, int* part_id, float* part_val, int Q, int Qp, int Pl, int K,
    int V, int S, int e_pad, int nb, int block_e, int seg, void* stream) {
  if (block_e <= 0 || block_e % kThreads != 0 || nb <= 0 || Q <= 0 ||
      Pl <= 0 || Q * Pl > 65535 || Qp < Q || Qp % 4 != 0 ||
      reinterpret_cast<uintptr_t>(vt) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(KIND)                                                  \
  launch<KIND>(vt, scal, src, local, mask, weight, base, acc, part_id,      \
               part_val, Q, Qp, Pl, K, V, S, e_pad, nb, block_e, seg, st)
  cudaError_t err;
  switch (kind) {
    case kBfs: err = REPRO_LAUNCH(kBfs); break;
    case kSssp: err = REPRO_LAUNCH(kSssp); break;
    case kCc: err = REPRO_LAUNCH(kCc); break;
    case kPagerank: err = REPRO_LAUNCH(kPagerank); break;
    case kBcFwd: err = REPRO_LAUNCH(kBcFwd); break;
    case kBcBwd: err = REPRO_LAUNCH(kBcBwd); break;
    case kBfsRelax: err = REPRO_LAUNCH(kBfsRelax); break;
    default: err = cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
  return static_cast<int>(err);
}

extern "C" const char* fused_superstep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
