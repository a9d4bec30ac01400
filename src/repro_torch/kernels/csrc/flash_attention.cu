// Causal online-softmax attention for Hopper (sm_90a): the prefill
// attention of the LM serving path.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the Pallas
// kernel, _flash_kernel) together with the head repeat of
// repro/kernels/ops.py::flash_attention_op.  Per query row it computes
// softmax(q k^T / sqrt(D)) v over the live keys (k <= q when causal;
// q - k < window when window > 0) as an online softmax: running max,
// denominator and accumulator in f32, masked scores NEG_INF = -1e30, the
// output divided by max(l, 1e-30) and rounded to the input type.
//
// Layout: the model's own.  q [B, S, G, R, D], k and v [B, S, G, D], o like
// q; query head h = g * R + r reads KV group g = h / R, so no head is
// repeated in memory.  Any S (a ragged last tile is masked), D in
// {16, 32, 64, 128}, B * G * R <= 65535.  Two kernels, chosen by the input
// type (not a fallback):
//
// bf16: flash_attention_tc_kernel, both products on the tensor cores, as the
// Pallas kernel computes them: S = Q K^T a bf16 product with an f32
// accumulator, P rounded to bf16 before O += P V (f32 accumulator), the
// denominator summing P unrounded.
//   * Products: wgmma.mma_async m64nNk16 (bf16 in, f32 accumulate).  S:
//     Q and K from shared memory, both K-major (D contiguous).  P V: P from
//     registers (the S accumulator fragment is the A fragment of the next
//     product, rounded to bf16 pairs), V from shared memory as the MN-major
//     B operand (the transpose bit), so V needs no transpose in memory.
//   * Loads: TMA (cp.async.bulk.tensor, 3-D maps over [B, S, heads * D]
//     that carry the strided layout: a Q row is H * D apart, a K/V row
//     G * D) into a ring of kStages K/V stages with mbarriers.  Rows past S
//     are filled with zeros by the TMA unit and masked.  Tiles are swizzled
//     by the TMA unit at the width of one row of a sub-tile (32, 64 or 128
//     bytes: D = 16, 32, 64; D = 128 as two 64-column sub-tiles) and the
//     wgmma descriptors name the same swizzle.  The map encoder is reached
//     through cudaGetDriverEntryPoint, so the library links no -lcuda.
//   * Warp roles: one producer warp issues every load; two consumer
//     warpgroups of 64 query rows each take two query heads of one KV group
//     at the same positions, so they share each K/V tile and each mask
//     (GQA).  With R odd the second warpgroup of the last pair repeats the
//     last head and stores nothing.  The two take turns to issue S (named
//     barriers), so one's softmax runs while the other's products use the
//     tensor cores.
//   * Exponentials: 2^x (ex2.approx, about 2 ulp) on scores prescaled by
//     scale * log2(e); P is rounded to bf16 after (2^-8), so neither the
//     base-2 form nor the approximate unit changes what the rounding keeps.
//     A tile whose keys are all live for every row of a warp skips the
//     mask and folds the scale into the exponent's argument (one fma).  A
//     row whose keys are all masked so far gets p = 2^0 = 1, which the
//     first live key's alpha = 0 erases: O is rescaled before each P V, in
//     that order.
//   * Key tiles wholly above the diagonal (causal) or older than the window
//     are skipped; the heaviest query tiles (the last rows) are scheduled
//     first.
// f32: flash_attention_f32_kernel, both products on the CUDA cores in f32
// with P kept in f32.  On the tensor cores f32 would run as TF32, whose
// 10-bit mantissa breaks the f32 limits against the plain version.  One
// block per 64 query rows of one head, 256 threads as 16 x 16: K
// transposed and V staged in shared memory, S = Q K^T as a 4 x 4 register
// tile per thread, P transposed through shared memory into O += P V.
//
// Bound on the card: at the prefill's shapes (S = 2048, D = 64) the
// operations, 4 * S^2 * D / 2 per head for the causal half, at the bf16
// tensor-core rate (989 TFLOP/s); the bytes of q, k, v and o (read and
// written once) take a third of that time.  The f32 kernel is capped by
// the f32 CUDA-core rate (67 TFLOP/s).  Built without fast-math and with
// -fmad=false: the f32 kernel's products use explicit fmaf, its exp and
// final division are IEEE.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace tc {

constexpr int kRows = 64;            // query rows per consumer warpgroup
constexpr int kKeys = 64;            // keys per K/V tile
constexpr int kStages = 2;           // K/V ring depth
constexpr int kConsumers = 2;        // warpgroups, one query head each
constexpr int kThreads = kConsumers * 128 + 32;   // + one producer warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFullMask = 0xffffffffu;

// Shared-memory geometry of one 64-row tile of head dim D.
template <int D>
struct Geo {
  static constexpr int kSub = D > 64 ? 64 : D;     // columns per sub-tile
  static constexpr int kNumSub = D / kSub;
  static constexpr int kRowBytes = kSub * 2;       // = the swizzle width
  static constexpr int kSubBytes = kKeys * kRowBytes;
  static constexpr int kTileBytes = kSubBytes * kNumSub;
  // wgmma descriptor layout code of that swizzle: 128 B, 64 B, 32 B
  static constexpr int kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kAtomBytes = 8 * kRowBytes;  // 8 rows of one swizzle
  // 1024 for aligning the base, Q tiles, K and V stages, the barriers
  static constexpr size_t kSmem = 1024 +
      static_cast<size_t>(kConsumers + 2 * kStages) * kTileBytes +
      8 * (1 + 2 * kStages);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n"
      "}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// One box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout code.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Named barriers over the two consumer warpgroups (256 threads): one waits
// for its turn, the other signals it.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B from shared memory
// (descriptors), both K-major; D is overwritten when accumulate is 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 16] += A[64 x 16] B[16 x 16]: A from registers (bf16 pairs),
// B from shared memory MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] B[16 x 32]: A from registers (bf16 pairs),
// B from shared memory MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (bf16 pairs),
// B from shared memory MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n16(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n32(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (ex2.approx, about 2 ulp; subnormal
// results flush to 0).  P is rounded to bf16 after, 2^-8 relative.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
}

// Grid (ceil(S / 64), B * G * ceil(R / 2)); kThreads threads: warpgroups
// 0 and 1 consume (query heads 2 * pair and 2 * pair + 1 of KV group g),
// warp 8 produces.  Accumulator fragments (wgmma m64nN, f32): thread lane
// of warp w holds rows 16 w + lane / 4 (+ 8) and columns 8 j + 2 (lane % 4)
// (+ 1): d[4 j + e], e = 0, 1 on the first row, 2, 3 on the second.
// Two blocks share an SM up to D = 64 (at most 113 registers a thread,
// which these fit without spilling), so four consumer warpgroups hide each
// other's latencies; D = 128 keeps one (its accumulator alone is 64).
template <int D>
__global__ void __launch_bounds__(kThreads, D > 64 ? 1 : 2)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ o, int S, int G, int R,
                          int causal, int window, float scale_log2) {
  using Gm = Geo<D>;
  constexpr int kSub = Gm::kSub;
  constexpr int kKSteps = kSub / 16;     // k16 steps per sub-tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;   // [kConsumers] Q tiles
  const uint32_t sk = sq + kConsumers * Gm::kTileBytes;   // [kStages] K
  const uint32_t sv = sk + kStages * Gm::kTileBytes;      // [kStages] V
  const uint32_t q_full = sv + kStages * Gm::kTileBytes;
  auto full = [&](int s) { return q_full + 8u * (1 + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + kStages + s); };

  const int q0 =
      (static_cast<int>(gridDim.x) - 1 - static_cast<int>(blockIdx.x)) * kRows;
  const int pairs = (R + 1) / 2;
  const int by = blockIdx.y;
  const int pair = by % pairs;
  const int g = by / pairs % G;
  const int b = by / pairs / G;
  const int H = G * R;
  // the key tiles with a live key for some row of this block
  const int q_last = min(q0 + kRows, S) - 1;
  const int k_hi = causal ? q_last + 1 : S;
  const int k_first =
      window > 0 ? max(0, q0 - window + 1) / kKeys * kKeys : 0;
  const int tiles = (k_hi - k_first + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // -- producer: Q once, then the K/V ring ------------------------------
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(q_full, kConsumers * Gm::kTileBytes);
      for (int c = 0; c < kConsumers; ++c) {
        const int h = g * R + min(2 * pair + c, R - 1);
        for (int sub = 0; sub < Gm::kNumSub; ++sub) {
          tma_load(sq + c * Gm::kTileBytes + sub * Gm::kSubBytes, &tm_q,
                   q_full, h * D + sub * kSub, q0, b);
        }
      }
      for (int it = 0; it < tiles; ++it) {
        const int st = it % kStages;
        mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * Gm::kTileBytes);
        const int k0 = k_first + it * kKeys;
        for (int sub = 0; sub < Gm::kNumSub; ++sub) {
          const uint32_t off = st * Gm::kTileBytes + sub * Gm::kSubBytes;
          tma_load(sk + off, &tm_k, full(st), g * D + sub * kSub, k0, b);
          tma_load(sv + off, &tm_v, full(st), g * D + sub * kSub, k0, b);
        }
      }
    }
    return;
  }

  // -- consumers ------------------------------------------------------------
  const int c = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int r = 2 * pair + c;
  const int h = g * R + min(r, R - 1);
  const int row0 = q0 + warp * 16 + lane / 4;   // and row0 + 8
  const uint32_t my_q = sq + c * Gm::kTileBytes;

  float acc[Gm::kNumSub][kSub / 2];
#pragma unroll
  for (int sub = 0; sub < Gm::kNumSub; ++sub)
#pragma unroll
    for (int i = 0; i < kSub / 2; ++i) acc[sub][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};     // this thread's share of the row sums

  // The two warpgroups take turns to issue S (named barriers 1 and 2,
  // warpgroup 0 first), so one's softmax runs while the other's products
  // use the tensor cores.
  if (c == 1) turn_pass(1);
  mbar_wait(q_full, 0);
  for (int it = 0; it < tiles; ++it) {
    const int st = it % kStages;
    mbar_wait(full(st), (it / kStages) & 1);
    const uint32_t k_tile = sk + st * Gm::kTileBytes;
    const uint32_t v_tile = sv + st * Gm::kTileBytes;

    // S = Q K^T over D in k16 steps
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    fence_regs(s);
    turn_wait(1 + c);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off =
          (kk / kKSteps) * Gm::kSubBytes + (kk % kKSteps) * 32;
      wgmma_ss_n64(s,
                   make_desc(my_q + off, 16, Gm::kAtomBytes, Gm::kLayout),
                   make_desc(k_tile + off, 16, Gm::kAtomBytes, Gm::kLayout),
                   kk > 0);
    }
    wgmma_commit();
    if (c == 0 || it + 1 < tiles) turn_pass(2 - c);
    wgmma_wait_all();
    fence_regs(s);

    // mask, online softmax statistics (base 2), P.  A tile whose keys are
    // all live for every row of this warp skips the mask and folds the
    // scale into the exponent's argument.
    const int k0 = k_first + it * kKeys;
    const int w_lo = q0 + warp * 16;             // this warp's first row
    const bool whole = k0 + kKeys <= S &&
                       (!causal || k0 + kKeys - 1 <= w_lo) &&
                       (window <= 0 || w_lo + 15 - k0 < window);
    float mx[2] = {kNegInf, kNegInf};
    if (whole) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) mx[i] = __fmul_rn(mx[i], scale_log2);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e >> 1) * 8;
          const int col = k0 + 8 * j + 2 * t4 + (e & 1);
          const bool live = col < S && (!causal || col <= row) &&
                            (window <= 0 || row - col < window);
          float& x = s[4 * j + e];
          x = live ? __fmul_rn(x, scale_log2) : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
    }
    float alpha[2], ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = ex2(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float mi = m[(i >> 1) & 1];
      s[i] = whole ? ex2(__fmaf_rn(s[i], scale_log2, -mi)) : ex2(s[i] - mi);
      ps[(i >> 1) & 1] = __fadd_rn(ps[(i >> 1) & 1], s[i]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), ps[i]);
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
      }
    }

    // O = alpha O + P V over the tile's keys in k16 steps
#pragma unroll
    for (int sub = 0; sub < Gm::kNumSub; ++sub) {
#pragma unroll
      for (int i = 0; i < kSub / 2; ++i) {
        acc[sub][i] = __fmul_rn(acc[sub][i], alpha[(i >> 1) & 1]);
      }
      fence_regs(acc[sub]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int sub = 0; sub < Gm::kNumSub; ++sub) {
        const uint32_t addr =
            v_tile + sub * Gm::kSubBytes + kk * 16 * Gm::kRowBytes;
        wgmma_rs<kSub>(acc[sub], pa[kk],
                       make_desc(addr, Gm::kAtomBytes, Gm::kAtomBytes,
                                 Gm::kLayout));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int sub = 0; sub < Gm::kNumSub; ++sub) fence_regs(acc[sub]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));   // this warp is done with st
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = __fadd_rn(l[i], __shfl_xor_sync(kFullMask, l[i], 1));
    l[i] = __fadd_rn(l[i], __shfl_xor_sync(kFullMask, l[i], 2));
  }
  if (r >= R) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= S) continue;
    const float denom = fmaxf(l[half], 1e-30f);
    __nv_bfloat16* out =
        o + ((static_cast<int64_t>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int sub = 0; sub < Gm::kNumSub; ++sub) {
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j) {
        const int col = sub * kSub + 8 * j + 2 * t4;
        *reinterpret_cast<uint32_t*>(out + col) =
            pack_bf16(__fdiv_rn(acc[sub][4 * j + 2 * half], denom),
                      __fdiv_rn(acc[sub][4 * j + 2 * half + 1], denom));
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A bf16 tensor [B, S, width] as boxes of `sub` columns by 64 rows of one
// batch, swizzled at the box's row width.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
              int width, int S, int B, int sub) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width) * 2,
                                 static_cast<cuuint64_t>(S) * width * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(sub),
                             static_cast<cuuint32_t>(kKeys), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      sub == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                : sub == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int G, int R, int causal, int window,
                   float scale, cudaStream_t stream) {
  using Gm = Geo<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap mq, mk, mv;
  if (!make_map(encode, &mq, q, G * R * D, S, B, Gm::kSub) ||
      !make_map(encode, &mk, k, G * D, S, B, Gm::kSub) ||
      !make_map(encode, &mv, v, G * D, S, B, Gm::kSub)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Gm::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kRows - 1) / kRows, B * G * ((R + 1) / 2));
  flash_attention_tc_kernel<D><<<grid, kThreads, Gm::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), S, G, R, causal, window,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tc

namespace f32 {

constexpr int kBlockM = 64;           // query rows per block
constexpr int kBlockN = 64;           // keys per tile
constexpr int kThreads = 256;         // 16 x 16
constexpr int kLd = kBlockM + 4;      // row stride of Qt, Kt, Pt (float4 aligned)
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

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
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ o, int S, int G, int R,
                           int causal, int window, float scale) {
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
  const float* qb = q + (static_cast<int64_t>(b) * S * H + h) * D;
  float* ob = o + (static_cast<int64_t>(b) * S * H + h) * D;
  const float* kb = k + (static_cast<int64_t>(b) * S * G + g) * D;
  const float* vb = v + (static_cast<int64_t>(b) * S * G + g) * D;

  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int row = i / D, d = i % D;
    const int pos = q0 + row;
    qt[d * kLd + row] = pos < S ? qb[pos * q_row + d] : 0.0f;
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
      kt[d * kLd + n] = in ? kb[pos * kv_row + d] : 0.0f;
      vs[n * D + d] = in ? vb[pos * kv_row + d] : 0.0f;
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
      ob[pos * q_row + tx + 16 * c] = __fdiv_rn(acc[i][c], denom);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int G, int R, int causal, int window,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  if (smem > 48u * 1024u) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_f32_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + kBlockM - 1) / kBlockM, B * G * R);
  flash_attention_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, G, R, causal,
      window, scale);
  return cudaGetLastError();
}

}  // namespace f32

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
#define REPRO_LAUNCH(NS, DD) \
  NS::launch<DD>(q, k, v, o, B, S, G, R, causal, window, scale, st)
  cudaError_t err;
  switch (D * 2 + (is_bf16 ? 1 : 0)) {
    case 16 * 2: err = REPRO_LAUNCH(f32, 16); break;
    case 32 * 2: err = REPRO_LAUNCH(f32, 32); break;
    case 64 * 2: err = REPRO_LAUNCH(f32, 64); break;
    case 128 * 2: err = REPRO_LAUNCH(f32, 128); break;
    case 16 * 2 + 1: err = REPRO_LAUNCH(tc, 16); break;
    case 32 * 2 + 1: err = REPRO_LAUNCH(tc, 32); break;
    case 64 * 2 + 1: err = REPRO_LAUNCH(tc, 64); break;
    case 128 * 2 + 1: err = REPRO_LAUNCH(tc, 128); break;
    default: err = cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
