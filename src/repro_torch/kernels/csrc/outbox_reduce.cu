// Source-side outbox aggregation for Hopper (sm_90a): the boundary leg of
// the sharded hybrid superstep (paper §3.4, §4.3).  Every boundary edge
// sends x[q, src] (times or plus its weight) to one outbox slot, one slot
// per (source partition, remote vertex); the edges arrive sorted by flat
// slot id, and the kernel reduces them into out[q, slot] without writing
// a per-edge message array.
//
// Replaces repro/kernels/outbox_reduce.py::outbox_reduce_blocks (the Pallas
// kernel) together with the phase-2 merge of its block partials in
// repro/kernels/ops.py::outbox_reduce_op.  The TPU kernel gathers with a
// chunked masked-max one-hot over the whole message vector (no indexed
// loads there) and reduces with a [block_e, span] one-hot contraction,
// which bounds the slots a block may cover and sends wider blocks to a
// plain fallback.  This is the fused superstep kernel's problem with an
// indexed gather in front, so it follows fused_superstep.cu:
//
//   * x query-minor: xt [x_len, Qp], Qp = Q rounded up to a multiple of 4.
//     One edge's queries lie in one 32-byte sector, so a thread takes them
//     with one or two 16-byte loads (two at Q=8) instead of one 4-byte
//     request per query; each thread issues the loads of kBatch edges
//     before it forms their messages.  The padded lanes are read and never
//     written out;
//   * all queries in one pass: a block walks its edges once for each group
//     of kGroup (8) queries and carries kGroup values through every step.
//     The weight is applied inline (add for min_plus, mul for plus_times,
//     none), loaded once per edge for the group;
//   * reduce: within a block of block_e edges the slot ids are
//     non-decreasing.  Each thread reduces the runs of equal ids among its
//     consecutive edges; runs crossing thread boundaries are joined by a
//     segmented scan (warp shuffles, then a fold over the block's warps).
//     The run structure depends on the slot ids alone, so the walk, the
//     scan and the fold run once per query group with one flag for kGroup
//     values: three barriers per group, not per query.  A run inside the
//     block is written straight to out; the block's first and last runs,
//     which may continue into neighbouring blocks (a hub's slot collects
//     tens of thousands of edges), go to a partials array that a second
//     kernel merges in block order.  Their ids do not depend on the query
//     ([nb, 2]); their values do ([Q, nb, 2]).  The merge takes one run of
//     equal ids per thread, for every query.  No span bound, no fallback.
//
// Every sum is taken in a fixed order, the same for each query as when the
// kernel looped over queries: thread-sequential over the thread's
// block_e / 128 edges, the 5-level shuffle scan, the fold over 4 warps, one
// carry, blocks in order in the merge.  So the sums are bit-equal to the
// query-by-query kernel's and the rounding depth is unchanged.  The same
// inputs give the same bits on every launch.  No float atomics.  Build
// without fast-math and with -fmad=false: the min modes are held bit for
// bit against the plain PyTorch version.
//
// The output [Q, num_slots] is pre-filled with the identity by the wrapper
// (one pass), and the kernel stores each closed run's value per query.
// scripts/scan_outbox_ablation.py times the other choice: the kernel
// writing the identity into the gaps between the runs it closes.
//
// Bound on the card: bytes.  One launch reads src and flat (and weight)
// once for all Q queries, gathers Q values per edge from xt (each of the
// Q * x_len values at least once) and writes the Q * num_slots output.
// The arithmetic is one or two operations per edge and query, far below
// the f32 peak.  The gathers are random (sources of a slot-sorted edge
// list), so the design cuts the requests per edge from Q to Qp / 4 and
// keeps a batch of them in flight per thread.
//
// Registers: 85 a thread, no spills (8 queries of run, head and scan
// values beside 4 edges x 8 queries of gathered messages in flight).
// chip_smoke.py prints each kernel's registers and spill stores and holds
// the library to none.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;                 // queries carried together
constexpr int kBatch = 4;                 // edges whose loads go out together
// Blocks an SM must hold at once.  It lets ptxas use up to 128 registers;
// without it ptxas held the kernel at 80 and spilled 4-16 bytes.
constexpr int kMinBlocks = 4;
constexpr unsigned kFullMask = 0xffffffffu;

enum WeightOp { kNone = 0, kAdd = 1, kMul = 2 };

template <bool kMin>
__device__ __forceinline__ float combine(float a, float b) {
  if constexpr (kMin) {
    return fminf(a, b);
  } else {
    return __fadd_rn(a, b);
  }
}

template <int WOP>
__device__ __forceinline__ float message(float xv, float w) {
  if constexpr (WOP == kAdd) {
    return __fadd_rn(xv, w);
  } else if constexpr (WOP == kMul) {
    return __fmul_rn(xv, w);
  } else {
    return xv;
  }
}

// One edge's kGroup queries: nvec (1 or 2) 16-byte loads from the
// query-minor row; lanes past them are 0 (never written out).
__device__ __forceinline__ void load_group(const float* __restrict__ row,
                                           int nvec, float (&v)[kGroup]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4 lo = __ldg(r4);
  const float4 hi = nvec > 1 ? __ldg(r4 + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// Write a run's value for the group's real queries, starting at query q0.
__device__ __forceinline__ void store_group(float* __restrict__ out, int q0,
                                            int Q, int num_slots, int id,
                                            const float (&v)[kGroup]) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    if (q0 + j < Q) out[static_cast<int64_t>(q0 + j) * num_slots + id] = v[j];
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
    float (*s_run)[kThreads], float* __restrict__ out, int* __restrict__ pid,
    float* __restrict__ part_val, int q0, int Q, int nb, int b,
    int num_slots) {
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

  // Close the runs that end in this thread: slot 0 of the block's partials
  // is its first run, slot 1 its last; part_val is [Q, nb, 2].
  auto partial = [&](int slot, int id, const float* val) {
    pid[slot] = id;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int q = q0 + l0 + j;
      if (q < Q) {
        part_val[(static_cast<int64_t>(q) * nb + b) * 2 + slot] = val[j];
      }
    }
  };
  auto store = [&](int id, const float* val) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int q = q0 + l0 + j;
      if (q < Q) out[static_cast<int64_t>(q) * num_slots + id] = val[j];
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
      store(r.head_id, h);
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
      store(r.run_id, v);
    }
  }
  __syncthreads();  // s_warp_* and s_run are rewritten by the next lanes
}

// Grid (nb); one thread block per edge block, looping over the query
// groups.  xt is [x_len, Qp]; out [Q, num_slots] is pre-filled with the
// identity.  part_id [nb, 2] and part_val [Q, nb, 2] receive each block's
// first and last run.
template <bool kMin, int WOP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
outbox_reduce_kernel(const float* __restrict__ xt,
                     const int* __restrict__ src,
                     const int* __restrict__ flat,
                     const float* __restrict__ weight,
                     float* __restrict__ out,
                     int* __restrict__ part_id,
                     float* __restrict__ part_val,
                     int Q, int Qp, int64_t E, int nb, int block_e,
                     int num_slots) {
  const float kIdent = kMin ? CUDART_INF_F : 0.0f;

  extern __shared__ int smem[];
  const int padded = block_e + (block_e >> 5);
  int* s_src = smem;
  int* s_id = smem + padded;
  float* s_w = reinterpret_cast<float*>(smem + 2 * padded);
  __shared__ float s_warp_v[kGroup][kWarps];
  __shared__ int s_warp_f[kWarps];
  __shared__ float s_run[kGroup][kThreads];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  Runs r;
  r.t = t;
  r.lane = t & 31;
  r.warp = t >> 5;

  // The edge block: loaded once, coalesced, shared by all Q queries.  Past
  // the last edge the slot id repeats the last real one and the source is
  // -1, whose message is the identity (the block metadata's padding).
  const int64_t e0 = static_cast<int64_t>(b) * block_e;
  const int last_id = flat[E - 1];
  for (int i = t; i < block_e; i += kThreads) {
    const int64_t e = e0 + i;
    const bool real = e < E;
    s_src[sidx(i)] = real ? src[e] : -1;
    s_id[sidx(i)] = real ? flat[e] : last_id;
    if constexpr (WOP != kNone) s_w[sidx(i)] = real ? weight[e] : 0.0f;
  }
  __syncthreads();

  const int ipt = block_e / kThreads;      // consecutive edges per thread
  const int i0 = t * ipt;
  r.first_id = s_id[sidx(0)];
  r.starts_new = (t == 0) || s_id[sidx(i0)] != s_id[sidx(i0 - 1)];
  r.ends_run = (t == kThreads - 1) ||
               s_id[sidx(i0 + ipt - 1)] != s_id[sidx(i0 + ipt)];
  int* pid = part_id + static_cast<int64_t>(b) * 2;

  for (int q0 = 0; q0 < Q; q0 += kGroup) {
    const int nvec = Qp - q0 >= 8 ? 2 : 1;

    // 1. Runs among this thread's own edges.  A run bounded by id changes
    //    on both sides inside the thread is owned by it alone.
    r.run_id = s_id[sidx(i0)];
    r.has_break = false;
    r.head_id = r.run_id;
    float run_v[kGroup], head_v[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) run_v[j] = head_v[j] = kIdent;
    for (int j0 = 0; j0 < ipt; j0 += kBatch) {
      // the batch's loads, all issued before any message is formed
      float g[kBatch][kGroup];
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int i = sidx(i0 + j0 + e);
        const int s = j0 + e < ipt ? s_src[i] : -1;
        if (s >= 0) {
          load_group(xt + static_cast<int64_t>(s) * Qp + q0, nvec, g[e]);
        } else {
#pragma unroll
          for (int j = 0; j < kGroup; ++j) g[e][j] = 0.0f;
        }
      }
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        if (j0 + e < ipt) {
          const int i = sidx(i0 + j0 + e);
          const int id = s_id[i];
          const bool live = s_src[i] >= 0;
          const float w = WOP != kNone ? s_w[i] : 0.0f;
          float m[kGroup];
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            m[j] = live ? message<WOP>(g[e][j], w) : kIdent;
          }
          if (id != r.run_id) {
            if (!r.has_break) {
              r.has_break = true;
              r.head_id = r.run_id;
#pragma unroll
              for (int j = 0; j < kGroup; ++j) head_v[j] = run_v[j];
            } else {
              store_group(out, q0, Q, num_slots, r.run_id, run_v);
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
                                 s_run, out, pid, part_val, q0, Q, nb, b,
                                 num_slots);
  }
}

// Merge the blocks' first/last runs in block order.  part ids [2 * nb] are
// non-decreasing and the same for every query; the thread at the head of
// each run of equal ids folds it for each query and writes the slot.
template <bool kMin>
__global__ void merge_partials_kernel(const int* __restrict__ part_id,
                                      const float* __restrict__ part_val,
                                      float* __restrict__ out, int n2, int Q,
                                      int num_slots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const int id = part_id[i];
  if (i > 0 && part_id[i - 1] == id) return;
  int end = i + 1;
  while (end < n2 && part_id[end] == id) ++end;
  for (int q = 0; q < Q; ++q) {
    const float* vals = part_val + static_cast<int64_t>(q) * n2;
    float v = vals[i];
    for (int j = i + 1; j < end; ++j) v = combine<kMin>(v, vals[j]);
    out[static_cast<int64_t>(q) * num_slots + id] = v;
  }
}

template <bool kMin, int WOP>
cudaError_t launch(const float* xt, const int* src, const int* flat,
                   const float* weight, float* out, int* part_id,
                   float* part_val, int Q, int Qp, int64_t E, int nb,
                   int block_e, int num_slots, cudaStream_t stream) {
  const size_t smem = (WOP == kNone ? 2u : 3u) *
                      static_cast<size_t>(block_e + (block_e >> 5)) *
                      sizeof(int);
  if (smem > 32u * 1024u) {   // past what the 48 KB default leaves it
    cudaError_t err = cudaFuncSetAttribute(
        outbox_reduce_kernel<kMin, WOP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  outbox_reduce_kernel<kMin, WOP><<<nb, kThreads, smem, stream>>>(
      xt, src, flat, weight, out, part_id, part_val, Q, Qp, E, nb, block_e,
      num_slots);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n2 = 2 * nb;
  merge_partials_kernel<kMin><<<(n2 + 255) / 256, 256, 0, stream>>>(
      part_id, part_val, out, n2, Q, num_slots);
  return cudaGetLastError();
}

}  // namespace

// xt: f32 [x_len, Qp] (query-minor, 16-byte aligned, Qp a multiple of 4 and
// >= Q); src/flat int32 [E] (flat non-decreasing, below num_slots); weight
// f32 [E] or null; out f32 [Q, num_slots] pre-filled with the identity;
// part_id int32 [nb, 2] and part_val f32 [Q, nb, 2] scratch.
extern "C" int outbox_reduce_launch(int is_min, int weight_op, const float* xt,
                                    const int* src, const int* flat,
                                    const float* weight, float* out,
                                    int* part_id, float* part_val, int Q,
                                    int Qp, long long E, int nb, int block_e,
                                    int num_slots, void* stream) {
  if (block_e <= 0 || block_e % kThreads != 0 || nb <= 0 || Q <= 0 ||
      Qp < Q || Qp % 4 != 0 || E <= 0 ||
      static_cast<long long>(nb) * block_e < E ||
      reinterpret_cast<uintptr_t>(xt) % 16 != 0 ||
      (weight_op != kNone && weight == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(MIN, WOP)                                              \
  launch<MIN, WOP>(xt, src, flat, weight, out, part_id, part_val, Q, Qp, E, \
                   nb, block_e, num_slots, st)
  cudaError_t err;
  switch (weight_op * 2 + (is_min ? 1 : 0)) {
    case kNone * 2: err = REPRO_LAUNCH(false, kNone); break;
    case kNone * 2 + 1: err = REPRO_LAUNCH(true, kNone); break;
    case kAdd * 2: err = REPRO_LAUNCH(false, kAdd); break;
    case kAdd * 2 + 1: err = REPRO_LAUNCH(true, kAdd); break;
    case kMul * 2: err = REPRO_LAUNCH(false, kMul); break;
    case kMul * 2 + 1: err = REPRO_LAUNCH(true, kMul); break;
    default: err = cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
  return static_cast<int>(err);
}

extern "C" const char* outbox_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
