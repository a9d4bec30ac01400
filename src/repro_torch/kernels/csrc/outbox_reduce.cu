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
//   * gather: a direct load of x[q, src[e]]; the weight is applied inline
//     (add for min_plus, mul for plus_times, none);
//   * reduce: within a block of block_e edges the slot ids are
//     non-decreasing.  Each thread reduces the runs of equal ids among its
//     consecutive edges; runs crossing thread boundaries are joined by a
//     segmented scan (warp shuffles, then a fold over the block's warps).
//     A run inside the block is written straight to out; the block's first
//     and last runs, which may continue into neighbouring blocks (a hub's
//     slot collects tens of thousands of edges), go to a partials array
//     that a second kernel merges in block order.  No span bound, no
//     fallback.
//
// Every sum is taken in a fixed order (thread-sequential, a fixed scan
// tree, block order in the merge), so the same inputs give the same bits
// on every launch.  No float atomics.  Build without fast-math and with
// -fmad=false: the min modes are held bit for bit against the plain
// PyTorch version.
//
// Bound on the card: bytes.  One launch reads src and flat (and weight)
// once for all Q queries, since a thread block stages its edge block in
// shared memory and loops over the queries; it gathers Q values per edge
// from x (each of the Q * x_len values at least once) and writes the used
// slots of the Q * num_slots output.  The arithmetic is one or two
// operations per edge and query, far below the f32 peak.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
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

// Shared-memory slot of edge i of the block: one pad word per 32 keeps the
// strided per-thread reads (thread t reads edges t*ipt + j) off one bank.
__device__ __forceinline__ int sidx(int i) { return i + (i >> 5); }

// Grid (nb); one thread block per edge block, looping over the Q queries.
// x is [Q, x_len]; out [Q, num_slots] is pre-filled with the identity.
// part_id/part_val [Q, nb, 2] receive each block's first and last run.
template <bool kMin, int WOP>
__global__ void __launch_bounds__(kThreads)
outbox_reduce_kernel(const float* __restrict__ x,
                     const int* __restrict__ src,
                     const int* __restrict__ flat,
                     const float* __restrict__ weight,
                     float* __restrict__ out,
                     int* __restrict__ part_id,
                     float* __restrict__ part_val,
                     int Q, int64_t x_len, int64_t E, int nb, int block_e,
                     int num_slots) {
  const float ident = kMin ? CUDART_INF_F : 0.0f;

  extern __shared__ int smem[];
  const int padded = block_e + (block_e >> 5);
  int* s_src = smem;
  int* s_id = smem + padded;
  float* s_w = reinterpret_cast<float*>(smem + 2 * padded);
  __shared__ float s_warp_v[kWarps];
  __shared__ int s_warp_f[kWarps];
  __shared__ float s_run[kThreads];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

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
  const int first_id = s_id[sidx(0)];      // the block's first run
  // A run begins at this thread's first edge / ends at its last edge.
  const bool starts_new = (t == 0) || s_id[sidx(i0)] != s_id[sidx(i0 - 1)];
  const bool ends_run = (t == kThreads - 1) ||
                        s_id[sidx(i0 + ipt - 1)] != s_id[sidx(i0 + ipt)];

  for (int q = 0; q < Q; ++q) {
    const float* xq = x + static_cast<int64_t>(q) * x_len;
    float* oq = out + static_cast<int64_t>(q) * num_slots;
    int* pid = part_id + (static_cast<int64_t>(q) * nb + b) * 2;
    float* pval = part_val + (static_cast<int64_t>(q) * nb + b) * 2;

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
      const int s = s_src[i];
      float m = ident;
      if (s >= 0) {
        const float xv = xq[s];
        if constexpr (WOP == kAdd) {
          m = __fadd_rn(xv, s_w[i]);
        } else if constexpr (WOP == kMul) {
          m = __fmul_rn(xv, s_w[i]);
        } else {
          m = xv;
        }
      }
      if (id != run_id) {
        if (!has_break) {
          has_break = true;
          head_id = run_id;
          head_v = run_v;
        } else {
          oq[run_id] = run_v;
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
        oq[head_id] = h;
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
        oq[run_id] = v;
      }
    }
    __syncthreads();  // s_warp_* and s_run are rewritten by the next query
  }
}

// Merge the blocks' first/last runs in block order.  part ids are
// non-decreasing along each query's row of 2*nb entries; the thread at the
// head of each run of equal ids folds it and writes the slot.
template <bool kMin>
__global__ void merge_partials_kernel(const int* __restrict__ part_id,
                                      const float* __restrict__ part_val,
                                      float* __restrict__ out, int n2,
                                      int num_slots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const int64_t q = blockIdx.y;
  const int* ids = part_id + q * n2;
  const float* vals = part_val + q * n2;
  const int id = ids[i];
  if (i > 0 && ids[i - 1] == id) return;
  float v = vals[i];
  for (int j = i + 1; j < n2 && ids[j] == id; ++j) v = combine<kMin>(v, vals[j]);
  out[q * num_slots + id] = v;
}

template <bool kMin, int WOP>
cudaError_t launch(const float* x, const int* src, const int* flat,
                   const float* weight, float* out, int* part_id,
                   float* part_val, int Q, int64_t x_len, int64_t E, int nb,
                   int block_e, int num_slots, cudaStream_t stream) {
  const size_t smem = (WOP == kNone ? 2u : 3u) *
                      static_cast<size_t>(block_e + (block_e >> 5)) *
                      sizeof(int);
  if (smem > 48u * 1024u) {
    cudaError_t err = cudaFuncSetAttribute(
        outbox_reduce_kernel<kMin, WOP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  outbox_reduce_kernel<kMin, WOP><<<nb, kThreads, smem, stream>>>(
      x, src, flat, weight, out, part_id, part_val, Q, x_len, E, nb, block_e,
      num_slots);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n2 = 2 * nb;
  const dim3 mgrid((n2 + 255) / 256, Q);
  merge_partials_kernel<kMin><<<mgrid, 256, 0, stream>>>(part_id, part_val,
                                                        out, n2, num_slots);
  return cudaGetLastError();
}

}  // namespace

extern "C" int outbox_reduce_launch(int is_min, int weight_op, const float* x,
                                    const int* src, const int* flat,
                                    const float* weight, float* out,
                                    int* part_id, float* part_val, int Q,
                                    long long x_len, long long E, int nb,
                                    int block_e, int num_slots, void* stream) {
  if (block_e <= 0 || block_e % kThreads != 0 || nb <= 0 || Q <= 0 ||
      Q > 65535 || E <= 0 || static_cast<long long>(nb) * block_e < E) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(MIN, WOP)                                              \
  launch<MIN, WOP>(x, src, flat, weight, out, part_id, part_val, Q, x_len,  \
                   E, nb, block_e, num_slots, st)
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
