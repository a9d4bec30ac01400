// Sorted segment reduce for Hopper (sm_90a): TOTEM's message reduction
// (paper §3.4) as a standalone op.  msgs [Q, E] f32 (Q leading rows that
// share one id array) and ids [E] int32, non-decreasing and below
// num_segments; out[q, s] is the sum or the minimum of msgs[q, e] over the
// e with ids[e] == s, and the identity (0 or +inf) where no id is s.
//
// Replaces repro/kernels/segment_reduce.py::segment_reduce_blocks (the
// Pallas kernel, _seg_sum_kernel and _seg_min_kernel) together with the
// phase-2 merge and the span fallback of repro/kernels/ops.py::
// segment_reduce_op.  The TPU kernel reduces a block with a [block_e, span]
// one-hot contraction, so a block may cover at most `span` ids and wider
// blocks go to a plain fallback.  This kernel reduces runs of equal ids
// instead, the scheme of fused_superstep.cu and outbox_reduce.cu without
// their gather:
//
//   * a thread block stages its block_e ids once in shared memory and loops
//     over the Q rows, staging each row's messages (coalesced);
//   * each thread reduces the runs of equal ids among its consecutive
//     edges; runs crossing thread boundaries are joined by a segmented scan
//     (warp shuffles, then a fold over the block's warps);
//   * a run inside the block is written straight to out; the block's first
//     and last runs, which may continue into neighbouring blocks, go to a
//     partials array that a second kernel merges in block order.  No span
//     bound, no fallback.
//
// Every sum is taken in a fixed order (thread-sequential, a fixed scan
// tree, block order in the merge), so the same inputs give the same bits
// on every launch.  No float atomics.  Built without fast-math and with
// -fmad=false; a minimum is exact in any order.
//
// Bound on the card: bytes.  One launch reads the ids once for all Q rows,
// each message once, and writes the used segments of the output (the
// wrapper fills the rest with the identity); one operation per message is
// far below the f32 peak.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

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

// Grid (nb); one thread block per edge block, looping over the Q rows.
// out [Q, num_segments] is pre-filled with the identity; part_id/part_val
// [Q, nb, 2] receive each block's first and last run.
template <bool kMin>
__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const float* __restrict__ msgs,
                      const int* __restrict__ ids, float* __restrict__ out,
                      int* __restrict__ part_id, float* __restrict__ part_val,
                      int Q, int64_t E, int nb, int block_e,
                      int num_segments) {
  const float ident = kMin ? CUDART_INF_F : 0.0f;

  extern __shared__ int smem[];
  const int padded = block_e + (block_e >> 5);
  int* s_id = smem;
  float* s_msg = reinterpret_cast<float*>(smem + padded);
  __shared__ float s_warp_v[kWarps];
  __shared__ int s_warp_f[kWarps];
  __shared__ float s_run[kThreads];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // Past the last edge the id repeats the last real one and the message is
  // the identity.
  const int64_t e0 = static_cast<int64_t>(b) * block_e;
  const int last_id = ids[E - 1];
  for (int i = t; i < block_e; i += kThreads) {
    const int64_t e = e0 + i;
    s_id[sidx(i)] = e < E ? ids[e] : last_id;
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
    const float* mq = msgs + static_cast<int64_t>(q) * E;
    float* oq = out + static_cast<int64_t>(q) * num_segments;
    int* pid = part_id + (static_cast<int64_t>(q) * nb + b) * 2;
    float* pval = part_val + (static_cast<int64_t>(q) * nb + b) * 2;

    for (int i = t; i < block_e; i += kThreads) {
      const int64_t e = e0 + i;
      s_msg[sidx(i)] = e < E ? mq[e] : ident;
    }
    __syncthreads();

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
      const float m = s_msg[i];
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
    __syncthreads();  // s_msg, s_warp_* and s_run are rewritten next row
  }
}

// Merge the blocks' first/last runs in block order.  part ids are
// non-decreasing along each row's 2*nb entries; the thread at the head of
// each run of equal ids folds it and writes the segment.
template <bool kMin>
__global__ void merge_partials_kernel(const int* __restrict__ part_id,
                                      const float* __restrict__ part_val,
                                      float* __restrict__ out, int n2,
                                      int num_segments) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const int64_t q = blockIdx.y;
  const int* pids = part_id + q * n2;
  const float* vals = part_val + q * n2;
  const int id = pids[i];
  if (i > 0 && pids[i - 1] == id) return;
  float v = vals[i];
  for (int j = i + 1; j < n2 && pids[j] == id; ++j) v = combine<kMin>(v, vals[j]);
  out[q * num_segments + id] = v;
}

template <bool kMin>
cudaError_t launch(const float* msgs, const int* ids, float* out,
                   int* part_id, float* part_val, int Q, int64_t E, int nb,
                   int block_e, int num_segments, cudaStream_t stream) {
  const size_t smem =
      2u * static_cast<size_t>(block_e + (block_e >> 5)) * sizeof(int);
  if (smem > 48u * 1024u) {
    cudaError_t err = cudaFuncSetAttribute(
        segment_reduce_kernel<kMin>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  segment_reduce_kernel<kMin><<<nb, kThreads, smem, stream>>>(
      msgs, ids, out, part_id, part_val, Q, E, nb, block_e, num_segments);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n2 = 2 * nb;
  const dim3 mgrid((n2 + 255) / 256, Q);
  merge_partials_kernel<kMin><<<mgrid, 256, 0, stream>>>(part_id, part_val,
                                                        out, n2, num_segments);
  return cudaGetLastError();
}

}  // namespace

extern "C" int segment_reduce_launch(int is_min, const float* msgs,
                                     const int* ids, float* out, int* part_id,
                                     float* part_val, int Q, long long E,
                                     int nb, int block_e, int num_segments,
                                     void* stream) {
  if (block_e <= 0 || block_e % kThreads != 0 || nb <= 0 || Q <= 0 ||
      Q > 65535 || E <= 0 || static_cast<long long>(nb) * block_e < E) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_min ? launch<true>(msgs, ids, out, part_id, part_val, Q, E, nb,
                            block_e, num_segments, st)
             : launch<false>(msgs, ids, out, part_id, part_val, Q, E, nb,
                             block_e, num_segments, st);
  return static_cast<int>(err);
}

extern "C" const char* segment_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
