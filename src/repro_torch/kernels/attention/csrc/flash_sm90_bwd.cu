// Flash attention backward for Hopper's tensor cores: bfloat16, causal,
// GQA layout, equal head dims 64 and 128.
//
// Replaces no TPU kernel: the JAX package's flash kernel is forward-only
// and its trainer differentiates the plain masked softmax.  This is the
// backward of csrc/flash_sm90.cu's causal forward with the log-sum-exp
// flag on (flash_attention_sm90_fwd_lse), so that the port's training
// attention runs on the card without the (B, K, G, S, S) float32 score
// tensor the plain route builds three times a step under the dots policy.
//
// The function: q (B, S, H, d), k and v (B, S, K, d), query head h
// reading kv head h / G (G = H / K) without a copy, query s reading keys
// t <= s, scale c = 1 / sqrt(d); o the forward's output, lse (B, H, S)
// its float32 log-sum-exp of each row's scaled scores, dO the gradient of
// o.  With the scores recomputed in float32 from q and k,
//   P  = exp(c q k^T - lse)          D  = rowsum(dO o)   (float32)
//   dP = dO v^T                      dS = P (dP - D)
//   dV = P^T dO    dK = c dS^T q     dQ = c dS k
// dK and dV of a kv head summed over its G query heads.  Scores, P, dP,
// D, dS and every accumulator are float32; P and dS are rounded to bf16
// only as the operands of the products (as the plain route rounds its
// probabilities), dQ, dK and dV to bf16 once, at the end.
//
// Bound on an H100: a causal head does 5 products of S^2 d / 2
// multiply-adds (QK^T, dO V^T, P^T dO, dS^T Q, dS K) -- qwen2-1.5b's
// training shape (B 4, S 2048, H 12 over K 2, d 128): 129 GFLOP, 0.130
// ms at 989 TFLOP/s, against 9 MB of q, k, v, o, dO and gradients: bound
// by operations.
//
// Design: three kernels on the caller's stream, no atomics, so every
// gradient is the same bits run to run.
// * dsum: D = rowsum(dO o) in float32, one warp a row.
// * dkdv: one CTA per (key tile of BN = 64 keys, kv head, sequence),
//   longest first (the first key tiles are read by every later query).
//   It keeps its K and V tiles in shared memory and dK, dV in registers
//   (one consumer warpgroup, 64 key rows), and walks the G query heads
//   of its kv head and, for each, the query tiles of BM rows from the
//   diagonal on: a producer warp streams their Q and dO tiles through a
//   ring of STAGES stages by TMA (128-byte swizzle, 64-column boxes, as
//   the forward) with the rows' lse and D beside them.  Per tile:
//   S^T = K Q^T and dP^T = V dO^T (wgmma, both operands K-major in shared
//   memory), P^T and dS^T in registers, then dV += P^T dO and dK += dS^T
//   Q (wgmma, A from registers -- the accumulator of S^T is the A
//   fragment as it stands -- and dO / Q read MN-major through the
//   transpose bit).  The sum over the G heads stays in registers.
// * dq: one CTA per (query tile of BM = 64 rows, head, sequence), longest
//   first, with Q and dO in shared memory and dQ in registers; a producer
//   warp streams the K and V tiles up to the diagonal.  Per tile S = Q
//   K^T and dP = dO V^T again, P, dS, then dQ += dS K.  It recomputes two
//   products that dkdv already formed, in place of summing dQ across
//   CTAs with float32 atomics and a conversion pass: 7 products instead
//   of 5, every gradient written once, in order.
// Query rows past S come in as zeros and their P and dS are set to 0
// (not multiplied: their lse and D are not defined); key rows past S are
// masked by causality; rows past S are never stored.

#include <cuda.h>            // CUtensorMap and the driver's enums only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;              // query rows of a dkdv step, of a dq CTA
constexpr int BN = 64;              // key rows of a dkdv CTA, of a dq step
constexpr int STAGES = 2;           // the tile ring's depth, both kernels
constexpr int BOX_COLS = 64;        // head-dim columns of a TMA box
constexpr int ROW = 128;            // a box row's bytes (128-byte swizzle)
constexpr int CONSUMERS = 128;      // the consumer warpgroup
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr float LOG2E = 1.4426950408889634f;

// D: the head dim (64 or 128)
template <int D>
struct Cfg {
  static constexpr int BOXES = D / BOX_COLS;
  static constexpr int Q_TILE = BOXES * BM * ROW;   // a Q or dO tile
  static constexpr int K_TILE = BOXES * BN * ROW;   // a K or V tile
  // dkdv: K, V; per stage Q, dO; then per stage the rows' lse and D
  static constexpr int KV_V = K_TILE;
  static constexpr int KV_Q = 2 * K_TILE;
  static constexpr int KV_STAGE = 2 * Q_TILE;
  static constexpr int KV_ROWS = KV_Q + STAGES * KV_STAGE;
  static constexpr int KV_BAR = KV_ROWS + STAGES * 2 * BM * 4;
  static constexpr int KV_SMEM = KV_BAR + 64 + 1024;
  // dq: Q, dO; then per stage K, V
  static constexpr int Q_DO = Q_TILE;
  static constexpr int Q_K = 2 * Q_TILE;
  static constexpr int Q_STAGE = 2 * K_TILE;
  static constexpr int Q_BAR = Q_K + STAGES * Q_STAGE;
  static constexpr int Q_SMEM = Q_BAR + 64 + 1024;
  static_assert(D % BOX_COLS == 0 && BM % 16 == 0 && BN % 16 == 0,
                "tiles of whole boxes and 16-row steps");
  static_assert(8 * (1 + 2 * STAGES) <= 64, "the barriers' 64 bytes");
  static_assert(K_TILE % 1024 == 0 && Q_TILE % 1024 == 0,
                "tiles on the swizzle's 1024 B");
};

// -- PTX wrappers (as in flash_sm90.cu) ------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a tile TMA wrote with the 128-byte
// swizzle: start address, leading and stride byte offsets, in 16-byte
// units.  K-major operands: 8-row groups 8 ROW apart (stride).  MN-major
// operands: 8-row groups 8 ROW apart (stride), 64-column boxes `lead`
// apart.
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr, uint32_t lead,
                                            uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lead >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((stride >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// 2^x on the special-function unit; subnormal results flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// keep the compiler from moving accumulator reads and writes across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (+)= A B, m64n64k16, A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
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

// D += A B, m64n64k16: A (bf16) from registers, B from shared memory,
// MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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

// D += A B, m64n128k16: A (bf16) from registers, B from shared memory,
// MN-major (transposed) across two 64-column boxes
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc (64 x D) += A (64 x 16, registers) B (16 x D, MN-major tile)
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// the K-major descriptor of k-step kk (16 head-dim columns) of a tile of
// `rows` rows at `tile`
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk, int rows) {
  return desc_sw(tile + (kk / 4) * rows * ROW + (kk % 4) * 32, 16, 8 * ROW);
}

// the MN-major descriptor of k-step kk (16 rows) of a tile of `rows` rows
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk, int rows) {
  return desc_sw(tile + kk * 16 * ROW, rows * ROW, 8 * ROW);
}

// a (64 x D) float32 accumulator times `scale`, rounded to bf16, into rows
// [r0, r0 + 8) of `out` (row stride `ld` elements), rows < S
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ld,
                                           const float (&acc)[D / 2],
                                           float scale, int row0, int col0,
                                           int S) {
  __nv_bfloat16* o0 = out + (long long)row0 * ld + col0;
  __nv_bfloat16* o1 = o0 + 8 * ld;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (row0 + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

// -- D = rowsum(dO o) --------------------------------------------------------

// one warp a row (b, s, h) of the contiguous (B, S, H, D) o and dO; dsum
// (B, H, S) float32
template <int D>
__global__ void __launch_bounds__(256)
    flash_attention_bwd_dsum_sm90(const __nv_bfloat16* __restrict__ o,
                                  const __nv_bfloat16* __restrict__ dout,
                                  float* __restrict__ dsum, int S, int H,
                                  long long rows) {
  constexpr int PER = D / 32;       // elements a lane: 2 or 4
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const __nv_bfloat16* a = o + row * D + lane * PER;
  const __nv_bfloat16* g = dout + row * D + lane * PER;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < PER; i += 2) {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + i));
    const float2 y =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g + i));
    sum = fmaf(x.x, y.x, fmaf(x.y, y.y, sum));
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bs = row / H;               // b * S + s
    const long long b = bs / S, s = bs % S;
    dsum[(b * H + h) * S + s] = sum;
  }
}

// -- dK, dV ------------------------------------------------------------------

// Grid: one CTA per (key tile, kv head, sequence), the first key tiles
// (the most query tiles) first.  dk, dv: contiguous (B, S, K, D).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ CUtensorMap tdo,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ dsum,
                                  __nv_bfloat16* __restrict__ dk,
                                  __nv_bfloat16* __restrict__ dv, int S,
                                  int H, int K, int B, float scale,
                                  float scale_log2) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms: 1024 B
  uint8_t* gbase = smem_raw + (base - raw);       // the same, generic
  const uint32_t sk = base, sv = base + C::KV_V;
  auto sq = [&](int s) { return base + C::KV_Q + s * C::KV_STAGE; };
  auto sdo = [&](int s) { return sq(s) + C::Q_TILE; };
  // the stage's rows' lse and D, float32
  auto rows_lse = [&](int s) {
    return reinterpret_cast<float*>(gbase + C::KV_ROWS) + s * 2 * BM;
  };
  auto rows_d = [&](int s) { return rows_lse(s) + BM; };
  const uint32_t bar = base + C::KV_BAR;
  const uint32_t kv_full = bar;
  auto full = [&](int s) { return bar + 8u * (1 + s); };
  auto empty = [&](int s) { return bar + 8u * (1 + STAGES + s); };

  const int kb = K * B;
  const int kt = (int)(blockIdx.x / kb);
  const int kvh = (int)(blockIdx.x % kb) % K;
  const int b = (int)(blockIdx.x % kb) / K;
  const int G = H / K;
  const int n0 = kt * BN;
  const int n_qt = (S + BM - 1) / BM;
  const int mt0 = n0 / BM;                 // the first query tile to see n0
  const int per_head = n_qt - mt0;
  const int n_steps = G * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1 + 32);          // the TMA's arrival + 32 lanes
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warp: lane 0 issues the TMA loads, every lane copies
    // two rows' lse and D of each step ----
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * C::K_TILE);
#pragma unroll
      for (int x = 0; x < C::BOXES; ++x) {
        tma_load(sk + x * BN * ROW, &tk, kv_full, x * BOX_COLS, n0, kvh, b);
        tma_load(sv + x * BN * ROW, &tv, kv_full, x * BOX_COLS, n0, kvh, b);
      }
    }
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % STAGES, n = i / STAGES;
      const int h = kvh * G + i / per_head;
      const int m0 = (mt0 + i % per_head) * BM;
      if (n > 0) mbar_wait(empty(s), (n - 1) & 1);   // stage used up
      if (lane == 0) {
        mbar_expect_tx(full(s), 2 * C::Q_TILE);
#pragma unroll
        for (int x = 0; x < C::BOXES; ++x) {
          tma_load(sq(s) + x * BM * ROW, &tq, full(s), x * BOX_COLS, m0, h,
                   b);
          tma_load(sdo(s) + x * BM * ROW, &tdo, full(s), x * BOX_COLS, m0, h,
                   b);
        }
      }
      const long long rows = ((long long)b * H + h) * S;
      for (int r = lane; r < BM; r += 32) {
        const int m = m0 + r;
        rows_lse(s)[r] = m < S ? lse[rows + m] : 0.f;
        rows_d(s)[r] = m < S ? dsum[rows + m] : 0.f;
      }
      mbar_arrive(full(s));
    }
    return;
  }

  // ---- consumers: one warpgroup, key rows r0 and r0 + 8 a thread ----
  const int r0 = n0 + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);       // in every 8-column chunk

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  float st[BM / 2], dpt[BM / 2];         // S^T and dP^T of a step
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) st[i] = dpt[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % STAGES;
    const uint32_t parity = (i / STAGES) & 1;
    const int m0 = (mt0 + i % per_head) * BM;

    // S^T = K Q^T and dP^T = V dO^T over D in steps of 16
    mbar_wait(full(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(st, kmajor(sk, kk, BN), kmajor(sq(s), kk, BM), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dpt, kmajor(sv, kk, BN), kmajor(sdo(s), kk, BM), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // P^T = exp(c S^T - lse), dS^T = P^T (dP^T - D), rounded to bf16 as
    // the A fragments of the next products; masked (keys past the query,
    // queries past S) to 0 in the tiles that hold any
    const bool edge = m0 < n0 + BN || m0 + BM > S;
    const float* tl = rows_lse(s);
    const float* td = rows_d(s);
    uint32_t pa[BM / 16][4], da[BM / 16][4];
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * kk + half;       // the 8-column chunk
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + col0 + e;  // the query column in the tile
          const float l2 = tl[c] * LOG2E, dd = td[c];
          const int query = m0 + c;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int idx = 4 * j + 2 * rr + e;
            const int key = r0 + 8 * rr;
            const bool off = edge && (key > query || query >= S);
            const float p =
                off ? 0.f : ex2(fmaf(st[idx], scale_log2, -l2));
            st[idx] = p;
            dpt[idx] = off ? 0.f : p * (dpt[idx] - dd);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
        da[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
      }
    }

    // dV += P^T dO and dK += dS^T Q over the tile's queries in steps of 16
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      wgmma_rs<D>(acc_dv, pa[kk], mnmajor(sdo(s), kk, BM));
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      wgmma_rs<D>(acc_dk, da[kk], mnmajor(sq(s), kk, BM));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    mbar_arrive(empty(s));
  }

  // epilogue: dK = c dS^T Q, dV; rows < S of kv head kvh
  const long long ld = (long long)K * D;
  const long long off = ((long long)b * S * K + kvh) * D;
  store_rows<D>(dk + off, ld, acc_dk, scale, r0, col0, S);
  store_rows<D>(dv + off, ld, acc_dv, 1.f, r0, col0, S);
}

// -- dQ ----------------------------------------------------------------------

// Grid: one CTA per (query tile, head, sequence), the longest (last)
// query tiles first.  dq: contiguous (B, S, H, D).
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
    flash_attention_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const float* __restrict__ lse,
                                const float* __restrict__ dsum,
                                __nv_bfloat16* __restrict__ dq, int S, int H,
                                int K, int B, int n_qt, float scale,
                                float scale_log2) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base, sdo = base + C::Q_DO;
  auto sk = [&](int s) { return base + C::Q_K + s * C::Q_STAGE; };
  auto sv = [&](int s) { return sk(s) + C::K_TILE; };
  const uint32_t bar = base + C::Q_BAR;
  const uint32_t q_full = bar;
  auto full = [&](int s) { return bar + 8u * (1 + s); };
  auto empty = [&](int s) { return bar + 8u * (1 + STAGES + s); };

  const int hb = H * B;
  const int qt = n_qt - 1 - (int)(blockIdx.x / hb);   // longest first
  const int h = (int)(blockIdx.x % hb) % H;
  const int b = (int)(blockIdx.x % hb) / H;
  const int kvh = h / (H / K);
  const int m0 = qt * BM;
  const int k_end = min(m0 + BM, S);       // causal: keys < k_end matter
  const int n_tiles = (k_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: lane 0 of warp 4 issues every load ----
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, 2 * C::Q_TILE);
#pragma unroll
      for (int x = 0; x < C::BOXES; ++x) {
        tma_load(sq + x * BM * ROW, &tq, q_full, x * BOX_COLS, m0, h, b);
        tma_load(sdo + x * BM * ROW, &tdo, q_full, x * BOX_COLS, m0, h, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES, n = t / STAGES;
        if (n > 0) mbar_wait(empty(s), (n - 1) & 1);
        mbar_expect_tx(full(s), 2 * C::K_TILE);
#pragma unroll
        for (int x = 0; x < C::BOXES; ++x) {
          tma_load(sk(s) + x * BN * ROW, &tk, full(s), x * BOX_COLS, t * BN,
                   kvh, b);
          tma_load(sv(s) + x * BN * ROW, &tv, full(s), x * BOX_COLS, t * BN,
                   kvh, b);
        }
      }
    }
    return;
  }

  // ---- consumers: one warpgroup, query rows row0 and row0 + 8 a thread
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = m0 + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const long long rows = ((long long)b * H + h) * S;
  float l2[2], dd[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + 8 * rr;
    l2[rr] = r < S ? lse[rows + r] * LOG2E : 0.f;
    dd[rr] = r < S ? dsum[rows + r] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[BN / 2], dp[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const uint32_t parity = (t / STAGES) & 1;

    // S = Q K^T and dP = dO V^T
    mbar_wait(full(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc, kmajor(sq, kk, BM), kmajor(sk(s), kk, BN), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, kmajor(sdo, kk, BM), kmajor(sv(s), kk, BN), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // dS = P (dP - D), P = exp(c S - lse); the last tile holds the
    // diagonal (BN == BM): keys past each row masked to 0
    const bool edge = t == n_tiles - 1;
    uint32_t da[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * kk + half;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = t * BN + 8 * j + col0 + e;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int idx = 4 * j + 2 * rr + e;
            const bool off = edge && key > row0 + 8 * rr;
            const float p =
                off ? 0.f : ex2(fmaf(sc[idx], scale_log2, -l2[rr]));
            dp[idx] = off ? 0.f : p * (dp[idx] - dd[rr]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
    }

    // dQ += dS K over the tile's keys in steps of 16
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<D>(acc, da[kk], mnmajor(sk(s), kk, BN));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty(s));
  }

  store_rows<D>(dq + ((long long)b * S * H + h) * D, (long long)H * D, acc,
                scale, row0, col0, S);
}

// -- host side --------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// error codes of this file beside cudaError_t's (which are >= 0)
constexpr int ERR_NO_ENCODE = -1;     // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = -2;        // the driver refused a tensor map
constexpr int ERR_SHAPE = -3;         // an input these kernels do not take

// a (B, rows, heads, d) bf16 tensor with element strides {b, s, h, 1} as
// a 4-d map (d, rows, heads, B) of 64-column boxes of 64 rows in the
// 128-byte swizzle; rows past `rows` read as zeros
int encode(CUtensorMap* map, const void* ptr, int B, int rows, int heads,
           int d, const long long* st) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX_COLS, (cuuint32_t)BM, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

bool on_grid(const void* p, const long long* st) {
  return (reinterpret_cast<uintptr_t>(p) % 16) == 0 && st[3] == 1 &&
         st[0] % 8 == 0 && st[1] % 8 == 0 && st[2] % 8 == 0 && st[0] > 0 &&
         st[1] > 0 && st[2] > 0;
}

template <int D>
int run(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, float* dsum, void* dq, void* dk,
        void* dv, int B, int S, int H, int K, const long long* q_strides,
        const long long* k_strides, const long long* v_strides,
        const long long* do_strides, cudaStream_t st) {
  static_assert(BM == BN, "the dq kernel's diagonal is its last tile");
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv, tdo;
  int r = encode(&tq, q, B, S, H, D, q_strides);
  if (r == 0) r = encode(&tk, k, B, S, K, D, k_strides);
  if (r == 0) r = encode(&tv, v, B, S, K, D, v_strides);
  if (r == 0) r = encode(&tdo, dout, B, S, H, D, do_strides);
  if (r != 0) return r;
  const float scale = (float)(1.0 / sqrt((double)D));
  const float scale_log2 = scale * LOG2E;

  const long long rows = (long long)B * S * H;
  flash_attention_bwd_dsum_sm90<D><<<(unsigned)((rows + 7) / 8), 256, 0,
                                     st>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, dsum, S, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto dkdv = flash_attention_bwd_dkdv_sm90<D>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::KV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_kt = (S + BN - 1) / BN;
  dkdv<<<n_kt * K * B, THREADS, C::KV_SMEM, st>>>(
      tq, tk, tv, tdo, lse, dsum, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, S,
      H, K, B, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto dqk = flash_attention_bwd_dq_sm90<D>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::Q_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (S + BM - 1) / BM;
  dqk<<<n_qt * H * B, THREADS, C::Q_SMEM, st>>>(
      tq, tk, tv, tdo, lse, dsum, (__nv_bfloat16*)dq, S, H, K, B, n_qt, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The backward of flash_attention_sm90_fwd_lse (causal, T == S): q (B, S,
// H, dh), k and v (B, S, K, dh), dout (B, S, H, dh), bfloat16, element
// strides {b, s, h, d} with d == 1, the others multiples of 8, 16-byte
// aligned pointers; o the forward's contiguous (B, S, H, dh) output and
// dout contiguous too; lse the forward's float32 (B, H, S); dsum a
// float32 (B, H, S) scratch (D = rowsum(dout o)); dq (B, S, H, dh), dk
// and dv (B, S, K, dh) contiguous outputs.  dh 64 or 128.  Returns 0 when
// every launch was accepted, a cudaError_t, or one of this file's
// negative codes (flash_sm90_bwd_error_string).
int flash_attention_sm90_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const float* lse, float* dsum, void* dq,
                             void* dk, void* dv, int B, int S, int H, int K,
                             int dh, const long long* q_strides,
                             const long long* k_strides,
                             const long long* v_strides,
                             const long long* do_strides, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || H % K != 0 ||
      (long long)((S + BM - 1) / BM) * H * B > 0x7fffffffLL ||
      !on_grid(q, q_strides) || !on_grid(k, k_strides) ||
      !on_grid(v, v_strides) || !on_grid(dout, do_strides) ||
      do_strides[2] != dh || do_strides[1] != (long long)H * dh ||
      do_strides[0] != (long long)S * H * dh ||
      (reinterpret_cast<uintptr_t>(o) % 16) != 0 ||
      (reinterpret_cast<uintptr_t>(dq) % 16) != 0 ||
      (reinterpret_cast<uintptr_t>(dk) % 16) != 0 ||
      (reinterpret_cast<uintptr_t>(dv) % 16) != 0)
    return ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  if (dh == 64)
    return run<64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, H, K,
                   q_strides, k_strides, v_strides, do_strides, st);
  if (dh == 128)
    return run<128>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, H, K,
                    q_strides, k_strides, v_strides, do_strides, st);
  return ERR_SHAPE;
}

const char* flash_sm90_bwd_error_string(int code) {
  switch (code) {
    case ERR_NO_ENCODE:
      return "cuTensorMapEncodeTiled not found in the CUDA driver";
    case ERR_ENCODE:
      return "cuTensorMapEncodeTiled refused a tensor map";
    case ERR_SHAPE:
      return "an input the sm90 backward does not take";
    default:
      return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
