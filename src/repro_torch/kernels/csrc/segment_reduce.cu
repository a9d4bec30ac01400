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
// their gather, so it has no span bound and no fallback.
//
// Bound on the card: bytes.  One launch reads the ids once for all Q rows,
// each message once, and writes the output once (the wrapper pre-fills it
// with the identity; the kernel stores the used segments); one operation
// per message is far below the f32 peak.  By Little's law the card needs
// some 25 KB of loads in flight per SM.
//
// The first design staged a block's ids and then each row's messages in
// shared memory with scalar 4-byte loads in strided loops, waiting at a
// barrier after each, and walked the runs, scanned and folded once per
// row, four barriers a row; its merge took one thread per run of partials
// walking it one load at a time.  This design:
//
//   * registers, not shared memory: a thread owns kIpt (8) consecutive
//     edges and loads their ids and each row's messages straight to
//     registers, as 16-byte vectors (two per array and row) where E % 4 ==
//     0 and both arrays are aligned, else with scalar loads in the same
//     kernel (kVec = false).  The loads stream (__ldcs, evict-first): each
//     byte is read once, and the output the wrapper pre-filled stays in the
//     L2 for the kernel's stores.  A group's loads all go out before any
//     message is used.  Neighbouring threads' boundary ids come by warp
//     shuffles; at a warp's edges the one id is read again through the
//     cache, so finding the runs needs no barrier;
//   * the run structure once per block: where the thread's runs break,
//     whether a run starts at its first edge or ends at its last, the
//     block's first run and the segmented scan's flags (the levels at which
//     a thread folds in its neighbour's value) come from the ids alone and
//     are computed once.  The rows then carry values only, kGroup (8) rows
//     at a time through one shuffle scan and one fold over the warps: one
//     barrier per group of rows (two between groups), where the first
//     design took four per row.  A launch with Q == 1 takes an instance
//     that carries one row (39 registers against 102);
//   * a run inside the block is written straight to out; the block's first
//     and last runs, which may continue into neighbouring blocks, go to a
//     partials array, ids [nb, 2] shared by the rows and values [Q, nb, 2],
//     that a second kernel merges in block order: a thread per (entry,
//     row), loading kMergeBatch ids and values at a time.
//
// scripts/minplus_segment_ablation.py times the choices against their
// alternatives: 16 edges a thread, the merge by the last block to finish
// (one block then folds all 2 * nb partials), scalar loads, cached loads,
// each row's loads just before its walk, and the kernel storing nothing
// (what the scattered stores into the pre-filled output cost).  Here the
// gain over the first design is smaller than the loads alone suggest: at
// Q = 8 the kernel reads 302 MB, and the first design already moved its
// bytes at about 2 TB/s (H100, 700 W).
//
// Every sum is taken in a fixed order, the first design's: kIpt adds in a
// thread (from the identity, the padding past E included), the 5-level
// shuffle scan, the fold over the 4 warps in order, one carry, blocks in
// order in the merge.  So the sums are bit-equal to the first design's,
// and the same inputs give the same bits on every launch.  No float
// atomics.  Built without fast-math and with -fmad=false; a minimum is
// exact in any order.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kIpt = 8;                      // consecutive edges a thread
constexpr int kBlockE = kThreads * kIpt;     // edges a block
constexpr int kGroup = 8;                    // rows carried together
// Blocks an SM must hold at once: lets ptxas use up to 128 registers.
constexpr int kMinBlocks = 4;
constexpr int kMergeThreads = 256;
constexpr int kMergeBatch = 8;               // partials a merge thread loads
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kIpt % 4 == 0, "a thread's edges are whole 16-byte vectors");

template <bool kMin>
__device__ __forceinline__ float combine(float a, float b) {
  if constexpr (kMin) {
    return fminf(a, b);
  } else {
    return __fadd_rn(a, b);
  }
}

__device__ __forceinline__ void load4(const int* __restrict__ p, int* o) {
  const int4 w = __ldcs(reinterpret_cast<const int4*>(p));
  o[0] = w.x; o[1] = w.y; o[2] = w.z; o[3] = w.w;
}

__device__ __forceinline__ void load4(const float* __restrict__ p, float* o) {
  const float4 w = __ldcs(reinterpret_cast<const float4*>(p));
  o[0] = w.x; o[1] = w.y; o[2] = w.z; o[3] = w.w;
}

// The kIpt values of v at edges [e, e + kIpt), `pad` at and past E:
// 16-byte loads where kVec (E % 4 == 0 and v aligned, so each vector lies
// below E or at or past it whole), else scalar loads.
template <bool kVec, typename T>
__device__ __forceinline__ void load_edges(const T* __restrict__ v,
                                           int64_t e, int64_t E, T pad,
                                           T (&out)[kIpt]) {
  if constexpr (kVec) {
#pragma unroll
    for (int c = 0; c < kIpt; c += 4) {
      if (e + c < E) {
        load4(v + e + c, out + c);
      } else {
        out[c] = out[c + 1] = out[c + 2] = out[c + 3] = pad;
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < kIpt; ++c) {
      out[c] = e + c < E ? __ldcs(v + e + c) : pad;
    }
  }
}

// Grid (nb), nb = ceil(E / kBlockE); one thread block per edge block,
// looping over groups of L rows.  out [Q, num_segments] is pre-filled with
// the identity; part_id [nb, 2] and part_val [Q, nb, 2] receive each
// block's first and last run.
template <bool kMin, bool kVec, int L>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
segment_reduce_kernel(const float* __restrict__ msgs,
                      const int* __restrict__ ids, float* __restrict__ out,
                      int* __restrict__ part_id, float* __restrict__ part_val,
                      int Q, int64_t E, int nb, int num_segments) {
  const float kIdent = kMin ? CUDART_INF_F : 0.0f;
  __shared__ float s_warp_v[L][kWarps];
  __shared__ int s_warp_f[kWarps];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t e0 = static_cast<int64_t>(b) * kBlockE;
  const int64_t et = e0 + t * kIpt;            // this thread's first edge

  // The ids, once for every row.  Past the last edge the id repeats the
  // last real one (and the message is the identity).
  const int last_id = et + kIpt >= E ? __ldg(ids + E - 1) : 0;
  int id[kIpt];
  load_edges<kVec>(ids, et, E, last_id, id);
  const int first_id = __ldg(ids + e0);        // the block's first run
  int prev = __shfl_up_sync(kFullMask, id[kIpt - 1], 1);
  int next = __shfl_down_sync(kFullMask, id[0], 1);
  if (lane == 0 && t > 0) prev = et - 1 < E ? __ldg(ids + et - 1) : last_id;
  if (lane == 31 && t < kThreads - 1) {
    next = et + kIpt < E ? __ldg(ids + et + kIpt) : last_id;
  }
  // A run begins at this thread's first edge / ends at its last edge / an
  // id changes inside it.
  const bool starts_new = t == 0 || id[0] != prev;
  const bool ends_run = t == kThreads - 1 || id[kIpt - 1] != next;
  bool has_break = false;
#pragma unroll
  for (int k = 1; k < kIpt; ++k) has_break |= id[k] != id[k - 1];

  // The segmented scan's flags: bit l of `take` is set where, at level l
  // (distance 2^l), the thread folds in the value from 2^l lanes up.
  // Afterwards f says that a run starts between the warp's first edge and
  // this thread's last edge.
  bool f = has_break || starts_new;
  unsigned take = 0;
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const int fu = __shfl_up_sync(kFullMask, static_cast<int>(f), 1 << l);
    if (lane >= (1 << l)) {
      if (!f) take |= 1u << l;
      f = f || fu;
    }
  }
  if (lane == 31) s_warp_f[warp] = f;   // read after the group's barrier
  int* pid = part_id + static_cast<int64_t>(b) * 2;

  for (int q0 = 0; q0 < Q; q0 += L) {
    if (q0 > 0) __syncthreads();   // the last group is done with s_warp_v

    // 1. The group's messages, every row's loads issued before any is
    //    used; then the runs among this thread's own edges, row by row.  A
    //    run bounded by id changes on both sides inside the thread is owned
    //    by it alone.
    float m[L][kIpt];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (L == 1 || q0 + j < Q) {
        load_edges<kVec>(msgs + static_cast<int64_t>(q0 + j) * E, et, E,
                         kIdent, m[j]);
      } else {
#pragma unroll
        for (int k = 0; k < kIpt; ++k) m[j][k] = kIdent;
      }
    }
    float run_v[L], head_v[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int q = q0 + j;
      float rv = combine<kMin>(kIdent, m[j][0]);
      float hv = kIdent;
      bool broke = false;
#pragma unroll
      for (int k = 1; k < kIpt; ++k) {
        if (id[k] != id[k - 1]) {
          if (!broke) {
            broke = true;
            hv = rv;
          } else if (L == 1 || q < Q) {
            out[static_cast<int64_t>(q) * num_segments + id[k - 1]] = rv;
          }
          rv = m[j][k];
        } else {
          rv = combine<kMin>(rv, m[j][k]);
        }
      }
      run_v[j] = rv;
      head_v[j] = hv;
    }

    // 2. The segmented inclusive scan over threads of the value of the run
    //    reaching each thread's last edge, then the fold over the earlier
    //    warps: v becomes the block-local total of that run up to here.
    float v[L];
#pragma unroll
    for (int j = 0; j < L; ++j) v[j] = run_v[j];
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      float vu[L];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        vu[j] = __shfl_up_sync(kFullMask, v[j], 1 << l);
      }
      if (take >> l & 1u) {
#pragma unroll
        for (int j = 0; j < L; ++j) v[j] = combine<kMin>(vu[j], v[j]);
      }
    }
    if (lane == 31) {
#pragma unroll
      for (int j = 0; j < L; ++j) s_warp_v[j][warp] = v[j];
    }
    __syncthreads();
    // pv: the run's total up to the previous warp's last edge, the warps
    // folded in order (the value the previous warp's lane 31 ends with).
    float pv[L];
#pragma unroll
    for (int j = 0; j < L; ++j) pv[j] = kIdent;
    if (warp > 0) {
#pragma unroll
      for (int j = 0; j < L; ++j) {
        float p = s_warp_v[j][0];
        for (int u = 1; u < warp; ++u) {
          p = s_warp_f[u] ? s_warp_v[j][u] : combine<kMin>(p, s_warp_v[j][u]);
        }
        pv[j] = p;
        if (!f) v[j] = combine<kMin>(p, v[j]);
      }
    }
    // The previous thread's total, for the head run that ends in this one.
    float prev_v[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const float up = __shfl_up_sync(kFullMask, v[j], 1);
      prev_v[j] = lane > 0 ? up : pv[j];
    }

    // 3. Close the runs that end in this thread: slot 0 of the block's
    //    partials is its first run, slot 1 its last.
    auto partial = [&](int slot, int run, const float* val) {
      if (q0 == 0) pid[slot] = run;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int q = q0 + j;
        if (L == 1 || q < Q) {
          part_val[(static_cast<int64_t>(q) * nb + b) * 2 + slot] = val[j];
        }
      }
    };
    auto store = [&](int run, const float* val) {
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int q = q0 + j;
        if (L == 1 || q < Q) {
          out[static_cast<int64_t>(q) * num_segments + run] = val[j];
        }
      }
    };
    if (has_break) {   // the head run ends inside this thread
      float h[L];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        h[j] = starts_new ? head_v[j] : combine<kMin>(prev_v[j], head_v[j]);
      }
      if (id[0] == first_id) {
        partial(0, id[0], h);
      } else {
        store(id[0], h);
      }
    }
    if (ends_run) {    // the run of the last edge ends here
      const int run = id[kIpt - 1];
      if (t == kThreads - 1) {
        if (run == first_id) {   // one run covers the whole block
          float idv[L];
#pragma unroll
          for (int j = 0; j < L; ++j) idv[j] = kIdent;
          partial(0, run, v);
          partial(1, run, idv);
        } else {
          partial(1, run, v);
        }
      } else if (run == first_id) {
        partial(0, run, v);
      } else {
        store(run, v);
      }
    }
  }
}

// Merge the blocks' first/last runs in block order.  part ids [2 * nb] are
// non-decreasing and the same for every row.  The thread of (entry, row)
// at the head of a run of equal ids folds the run's values in order and
// writes the segment; it loads kMergeBatch ids and values at a time, so a
// run over many blocks (a hub's segment) costs a few round trips.
template <bool kMin>
__global__ void __launch_bounds__(kMergeThreads)
merge_partials_kernel(const int* __restrict__ part_id,
                      const float* __restrict__ part_val,
                      float* __restrict__ out, int n2, int Q,
                      int num_segments) {
  const int i = blockIdx.x * kMergeThreads + threadIdx.x;
  if (i >= n2) return;
  const int id = part_id[i];
  if (i > 0 && part_id[i - 1] == id) return;
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    const float* vals = part_val + static_cast<int64_t>(q) * n2;
    float v = vals[i];
    for (int j0 = i + 1; j0 < n2; j0 += kMergeBatch) {
      int pid[kMergeBatch];
      float pv[kMergeBatch];
#pragma unroll
      for (int c = 0; c < kMergeBatch; ++c) {
        pid[c] = j0 + c < n2 ? part_id[j0 + c] : -1;   // ids are >= 0
        pv[c] = j0 + c < n2 ? vals[j0 + c] : 0.0f;
      }
      bool more = true;
#pragma unroll
      for (int c = 0; c < kMergeBatch; ++c) {
        more = more && pid[c] == id;
        if (more) v = combine<kMin>(v, pv[c]);
      }
      if (!more) break;
    }
    out[static_cast<int64_t>(q) * num_segments + id] = v;
  }
}

template <bool kMin, bool kVec>
void launch_rows(const float* msgs, const int* ids, float* out, int* part_id,
                 float* part_val, int Q, int64_t E, int nb, int num_segments,
                 cudaStream_t st) {
  if (Q == 1) {
    segment_reduce_kernel<kMin, kVec, 1><<<nb, kThreads, 0, st>>>(
        msgs, ids, out, part_id, part_val, Q, E, nb, num_segments);
  } else {
    segment_reduce_kernel<kMin, kVec, kGroup><<<nb, kThreads, 0, st>>>(
        msgs, ids, out, part_id, part_val, Q, E, nb, num_segments);
  }
}

template <bool kMin>
cudaError_t launch(const float* msgs, const int* ids, float* out,
                   int* part_id, float* part_val, int Q, int64_t E, int nb,
                   int num_segments, cudaStream_t st) {
  const bool vec = E % 4 == 0 && reinterpret_cast<uintptr_t>(msgs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ids) % 16 == 0;
  if (vec) {
    launch_rows<kMin, true>(msgs, ids, out, part_id, part_val, Q, E, nb,
                            num_segments, st);
  } else {
    launch_rows<kMin, false>(msgs, ids, out, part_id, part_val, Q, E, nb,
                             num_segments, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n2 = 2 * nb;
  const dim3 grid((n2 + kMergeThreads - 1) / kMergeThreads, min(Q, 65535));
  merge_partials_kernel<kMin><<<grid, kMergeThreads, 0, st>>>(
      part_id, part_val, out, n2, Q, num_segments);
  return cudaGetLastError();
}

}  // namespace

// msgs f32 [Q, E]; ids int32 [E], non-decreasing, below num_segments; out
// f32 [Q, num_segments] pre-filled with the identity; part_id int32
// [nb, 2] and part_val f32 [Q, nb, 2] scratch, nb = ceil(E / block_e);
// block_e must be kBlockE (1024), whose order the caller's bounds assume.
extern "C" int segment_reduce_launch(int is_min, const float* msgs,
                                     const int* ids, float* out, int* part_id,
                                     float* part_val, int Q, long long E,
                                     int nb, int block_e, int num_segments,
                                     void* stream) {
  if (block_e != kBlockE || Q <= 0 || E <= 0 || nb <= 0 ||
      static_cast<long long>(nb) * block_e < E ||
      static_cast<long long>(nb - 1) * block_e >= E) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_min ? launch<true>(msgs, ids, out, part_id, part_val, Q, E, nb,
                            num_segments, st)
             : launch<false>(msgs, ids, out, part_id, part_val, Q, E, nb,
                             num_segments, st);
  return static_cast<int>(err);
}

extern "C" const char* segment_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
