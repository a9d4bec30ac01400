// Causal online-softmax attention for Hopper (sm_90a): the prefill
// attention of the LM serving path.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the Pallas
// kernel, _flash_kernel) together with the head repeat of
// repro/kernels/ops.py::flash_attention_op.  It computes what
// repro/models/attention.py::chunked_attention computes, the attention the
// JAX prefill runs: per query row, softmax(q k^T / sqrt(D)) v over the
// live keys (k <= q when causal; q - k < window when window > 0), with a
// running max, denominator and accumulator in f32 and only the output
// rounded to the input type.  P stays in f32 (as in chunked_attention);
// the products run on the CUDA cores, not the tensor cores.
//
// Layout: the model's own.  q [B, S, G, R, D], k and v [B, S, G, D], o like
// q; query head h = g * R + r reads KV group g = h / R, so no head is
// repeated in memory.
//
// Design.  One thread block per 64 query rows of one (batch, head), 256
// threads as 16 x 16.  The block stages its queries once, transposed
// (Qt[d][row]), then walks the 64-key tiles that hold a live key for any of
// its rows: tiles wholly above the diagonal (causal) or wholly older than
// the window are skipped.  Per tile: K transposed and V into shared memory,
// S = Q K^T as a 4 x 4 register tile per thread (float4 reads of Qt and Kt
// along d), the mask, the row max and sum across the 16 threads of a row
// (warp shuffles), P transposed into shared memory, and O += P V with each
// thread holding 4 rows x D/16 columns of the accumulator.  Masked scores
// are NEG_INF = -1e30, as in the JAX kernels: a row whose keys are all
// masked so far gets p = exp(0) = 1, which the first live key's
// alpha = exp(-1e30 - m) = 0 erases, so a skipped tile and a computed
// masked tile give the same result; every row has a live key (its own
// position).  A ragged last tile reads zeros past S and masks them.  The
// heaviest causal blocks (the last query rows) are scheduled first.
//
// Bound on the card: at the prefill's shapes (S = 2048, D = 64) the
// operations: 4 * S^2 * D / 2 per head for the causal half, far above the
// bytes of q, k, v and o (read and written once).  On the CUDA cores the
// f32 rate (67 TFLOP/s) is the kernel's own ceiling; the bound counted
// against it is the bf16 tensor-core rate (989 TFLOP/s), which a later
// kernel on the tensor cores can reach for.  Products use explicit fmaf
// (the build turns contraction off); exp and the final division are
// IEEE.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBlockM = 64;           // query rows per block
constexpr int kBlockN = 64;           // keys per tile
constexpr int kThreads = 256;         // 16 x 16
constexpr int kLd = kBlockM + 4;      // row stride of Qt, Kt, Pt (float4 aligned)
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Reduce over the 16 threads of one row (lanes that differ in bits 0-3).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

constexpr size_t smem_bytes(int d) {
  return sizeof(float) *
         (2u * d * kLd + static_cast<size_t>(kBlockN) * d + kBlockN * kLd);
}

// Grid (ceil(S / 64), B * G * R).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int G, int R, int causal, int window, float scale) {
  constexpr int kCols = D / 16;       // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                   // [D][kLd]   Q transposed
  float* kt = qt + D * kLd;           // [D][kLd]   K transposed
  float* vs = kt + D * kLd;           // [kBlockN][D]
  float* pt = vs + kBlockN * D;       // [kBlockN][kLd]  P transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nq = gridDim.x;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBlockM;
  const int H = G * R;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int g = h / R;
  const int64_t q_row = static_cast<int64_t>(H) * D;   // stride of one position
  const int64_t kv_row = static_cast<int64_t>(G) * D;
  const T* qb = q + (static_cast<int64_t>(b) * S * H + h) * D;
  T* ob = o + (static_cast<int64_t>(b) * S * H + h) * D;
  const T* kb = k + (static_cast<int64_t>(b) * S * G + g) * D;
  const T* vb = v + (static_cast<int64_t>(b) * S * G + g) * D;

  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int row = i / D, d = i % D;
    const int pos = q0 + row;
    qt[d * kLd + row] = pos < S ? to_f32(qb[pos * q_row + d]) : 0.0f;
  }

  // The key tiles with a live key for some row of this block.
  const int q_last = min(q0 + kBlockM, S) - 1;
  const int k_hi = causal ? q_last + 1 : S;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = (k_lo / kBlockN) * kBlockN; k0 < k_hi; k0 += kBlockN) {
    __syncthreads();                  // the previous tile is consumed
    for (int i = tid; i < kBlockN * D; i += kThreads) {
      const int n = i / D, d = i % D;
      const int pos = k0 + n;
      const bool in = pos < S;
      kt[d * kLd + n] = in ? to_f32(kb[pos * kv_row + d]) : 0.0f;
      vs[n * D + d] = in ? to_f32(vb[pos * kv_row + d]) : 0.0f;
    }
    __syncthreads();

    // S = Q K^T: rows ty*4 + i, keys tx*4 + j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kLd + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(av[i], cv[j], s[i][j]);
    }

    // Mask, online softmax statistics, P into shared memory.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        const bool live = kp < S && (!causal || kp <= qp) &&
                          (window <= 0 || qp - kp < window);
        s[i][j] = live ? __fmul_rn(s[i][j], scale) : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps = __fadd_rn(ps, s[i][j]);
      }
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), row_sum(ps));
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = __fmul_rn(acc[i][c], alpha);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * kLd + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // O += P V: rows ty*4 + i, columns tx + 16*c.
#pragma unroll 4
    for (int n = 0; n < kBlockN; ++n) {
      const float4 p = *reinterpret_cast<const float4*>(pt + n * kLd + ty * 4);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vs[n * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = __fmaf_rn(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pos = q0 + ty * 4 + i;
    if (pos >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      ob[pos * q_row + tx + 16 * c] = from_f32<T>(__fdiv_rn(acc[i][c], denom));
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int G, int R, int causal, int window,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  if (smem > 48u * 1024u) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + kBlockM - 1) / kBlockM, B * G * R);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, G, R, causal, window,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_launch(int is_bf16, const void* q,
                                      const void* k, const void* v, void* o,
                                      int B, int S, int G, int R, int D,
                                      int causal, int window, float scale,
                                      void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || R <= 0 ||
      static_cast<long long>(B) * G * R > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(T, DD) \
  launch<T, DD>(q, k, v, o, B, S, G, R, causal, window, scale, st)
  cudaError_t err;
  switch (D * 2 + (is_bf16 ? 1 : 0)) {
    case 16 * 2: err = REPRO_LAUNCH(float, 16); break;
    case 32 * 2: err = REPRO_LAUNCH(float, 32); break;
    case 64 * 2: err = REPRO_LAUNCH(float, 64); break;
    case 128 * 2: err = REPRO_LAUNCH(float, 128); break;
    case 16 * 2 + 1: err = REPRO_LAUNCH(__nv_bfloat16, 16); break;
    case 32 * 2 + 1: err = REPRO_LAUNCH(__nv_bfloat16, 32); break;
    case 64 * 2 + 1: err = REPRO_LAUNCH(__nv_bfloat16, 64); break;
    case 128 * 2 + 1: err = REPRO_LAUNCH(__nv_bfloat16, 128); break;
    default: err = cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
