// Flash attention (forward) for Hopper's tensor cores: bfloat16, equal head
// dims (q.k = v) that are multiples of 8 up to 256, or MLA's (192, 128),
// GQA layout, causal or over every key.
//
// Replaces the Pallas TPU kernel of the JAX package
//   src/repro/kernels/attention/flash.py  flash_attention_pallas
// for the inputs the H100 serves: bf16 q, k, v whose head dim is
// contiguous.  It computes the same function as csrc/flash.cu and
// ref.py -- by index, scale 1/sqrt(dqk) (q's head dim: 192 for MLA),
// scores and the online softmax in float32, p rounded to bf16 before P.V
// while l sums the unrounded p, output acc / max(l, 1e-30) rounded to
// bf16, masked score -1e30 -- on the port's layout: q (B, S, H, dqk), k
// (B, T, K, dqk) and v (B, T, K, dv), query head h reading kv head
// h / (H / K) without a copy.  Causal: T == S, query s reads keys t <= s.
// Not causal (the TPU kernel's causal=False branch): any T >= 1, every
// key valid -- cross-attention's prompt pass, S text tokens over T image
// tokens.
//
// Head dims and tiles.  The tiles (64, 64), (128, 128), (192, 128) --
// MLA -- and (256, 256) run their own head dims as instantiations of
// their own.  Any other equal head dim d on TMA's 16-byte grid (d % 8 ==
// 0, d <= 256) runs in the smallest square tile of 16, 32, 64, 128 and
// 256 that holds it (MIN_TILE 16), in a padded instantiation (PAD), so
// that the tiles' own head dims compile without the padded route's
// runtime head dims, box counts and column guard (which cost the served
// dh 128 shapes 3-6 % in scripts/flash_ab.py's A/B on an H100).  The
// tensor maps are encoded at the true d, so TMA fills the columns past d
// with zeros: Q and K's zero columns add nothing to QK^T, and V's give
// zero output columns, which are never stored.  A box wholly past d (the
// 256 tile at d <= 192) is not loaded: the CTA zeroes it once in every
// stage.  The scale is the true d's, and the output rows are d wide.
// phi-2's d 80 and phi-3-mini's 96 pad to 128.  The 16 and 32 tiles
// take one box of their own width -- 32- or 64-byte rows in the 32- or
// 64-byte swizzle, P.V by wgmma.m64n16k16 / m64n32k16 -- so the reduced
// configs' 16 and 32 run unpadded, as d 8 and 24 nearly do.
//
// Bound on an H100: S^2 (dqk + dv) operations per head (causal QK^T and
// PV) against S (2 dqk + 2 dv) elements moved.  tinyllama-1.1b's prefill
// (B 1, S 1024, H 32, K 4, dh 64) needs 4.3 GFLOP, 4.3 us at the
// 989 TFLOP/s bf16 tensor-core rate, against 2.8 us of bytes: bound by
// operations, so the products run on the tensor cores, the loads hide
// behind them, and the softmax between them -- issue slots and the
// special-function unit's 2^x -- is what a tile costs beyond them.
// Without causality a head needs 2 S T (dqk + dv) operations:
// llama-3.2-vision's cross-attention prompt pass (B 4, S 1024, T 1600,
// H 64 / K 8, dh 128) 214.7 GFLOP, 0.217 ms at 989 TFLOP/s, against
// 0.048 ms to move its 160 MB: bound by operations as well.
// deepseek-v2's MLA prompt pass (B 1, S 1024, H 128 = K, q.k 192 / v
// 128: every head its own keys) moves 168 MB, 0.050 ms, against 0.043 ms
// of operations: bound by bytes.  recurrentgemma-2b's local layers (B 1,
// S 1024, H 10 over K 1, dh 256) do 5.4 GFLOP, 5.4 us, on 11.5 MB.
// phi-2's attention (B 1, S 1024, H 32 = K, d 80) moves 21 MB, 6.3 us,
// against 5.4 us of operations (8.7 us at the padded 128): bound by bytes.
//
// Design.  One CTA per (query block of BQ = 64 rows, head, sequence),
// 160 threads: one consumer warpgroup (warps 0-3, `wgmma` needs four
// warps together) and one producer warp.  Query blocks are issued
// longest first over every head (a causal grid is unbalanced).
// * The producer's lane 0 loads the CTA's Q block once and streams the
//   K and V tiles of BK keys through a ring of STAGES stages in shared
//   memory, by TMA (cp.async.bulk.tensor, 4-d maps over (d, S, heads, B)
//   built on the host from the tensors' strides, so strided views load
//   without a copy) in boxes of 64 head-dim columns -- dqk / 64 for Q
//   and K, dv / 64 for V -- with the 128-byte swizzle.  Each stage has a
//   "full" mbarrier for K, one for V (the TMA completes their
//   transaction bytes, K_TILE and V_TILE) and an "empty" one that the
//   128 consumer threads arrive on when the stage's products are done.
//   Tiles wholly in the future of the block are never loaded (causal);
//   without causality the ceil(T / BK) tiles of every key are.  Rows
//   past S or T come in as zeros (TMA fills out of bounds); query rows
//   past S are never stored.
// * The consumers compute S = Q K^T with dqk / 16 steps of
//   wgmma.m64n{BK}k16 (both operands K-major in shared memory,
//   descriptors with the TMA's 128-byte swizzle), mask the tiles that
//   need it (causal: those reaching past the block's first row -- the
//   last one when BK >= BQ; otherwise the one holding key T - 1, whose
//   zero-filled keys past T would score 0, not -1e30), run the online
//   softmax on the float32 accumulator in registers (each thread holds
//   two rows; a row's max and sum reduce over the four threads of a
//   quad; the scale folds into one FMA per score before ex2.approx),
//   round p to bf16 in registers as the A fragment of the next product,
//   and accumulate O += P V with wgmma.m64n{dv}k16 (A from registers, V
//   an MN-major B operand read through the transpose bit, its 64-column
//   boxes KV_BOX apart).  At dh 64 three CTAs share an SM, so one CTA's
//   softmax overlaps another's products; at dh 128 the 128-key tiles
//   halve the per-tile waits and reductions.  At MLA's 192 / 128 and at
//   dh 256 the key tile and the ring's depth are the fastest of
//   scripts/flash_sm90_tiles.py's sweep (BK_MLA / STAGES_MLA,
//   BK_DH256 / STAGES_DH256): at MLA 64-key tiles, two CTAs an SM; at
//   dh 256, where the O accumulator alone is 128 registers a thread,
//   64-key tiles three stages deep, one CTA an SM (32-key tiles spill
//   at two CTAs an SM and lose at one).
// Inputs it does not take (float32, a head dim off the 16-byte grid or
// unequal but MLA's, a head dim that is not contiguous, strides or
// pointers off TMA's 16-byte grid) go to csrc/flash.cu; the wrapper
// decides by shape before the launch.
//
// Log-sum-exp (training).  flash_attention_sm90_fwd_lse runs the causal
// kernel at dh 64 and 128 with the LSE flag on: the epilogue also writes
// each query row's float32 log-sum-exp of its scaled scores, lse (B, H,
// S), from the running max and sum the softmax already keeps, (m +
// log2 l) ln 2, for the backward of csrc/flash_sm90_bwd.cu.  The flag is
// a template argument: the serving instantiations compile without it.

#include <cuda.h>            // CUtensorMap and the driver's enums only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;              // query rows of a CTA (one warpgroup)
constexpr int BK_DH64 = 64;         // keys of one ring stage at dh 64
constexpr int BK_DH128 = 128;       // and at dh 128
// MLA's q.k 192 / v 128 and dh 256: the fastest key tile and ring depth
// of scripts/flash_sm90_tiles.py's sweep at deepseek-v2's and
// recurrentgemma-2b's prompt passes (BK 64 / 2 stages: 104 KB, two CTAs
// an SM; BK 64 / 3 stages: 225 KB, one)
constexpr int BK_MLA = 64;
constexpr int STAGES_MLA = 2;
constexpr int BK_DH256 = 64;
constexpr int STAGES_DH256 = 3;
// the smallest tile a padded head dim runs in: 16, then 32, 64, ...
// (scripts/flash_pad_sweep.py times the 16 and 32 tiles against a
// MIN_TILE 64 build, which pads every head dim below 64 to 64)
constexpr int MIN_TILE = 16;
constexpr int BOX_COLS = 64;        // head-dim columns of a TMA box at most
constexpr int CONSUMERS = 128;      // the consumer warpgroup
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int SM_SMEM = 233472;     // an SM's shared memory (228 KB)
constexpr int CTA_SMEM = 232448;    // the most one CTA may take (227 KB)
constexpr float NEG = -1e30f;       // the masked score of the TPU kernel
constexpr float LN2 = 0.6931471805599453f;

// DQK: q's and k's head dim; DV: v's
template <int DQK, int DV>
struct Cfg {
  static constexpr bool MLA = DQK == 192;
  static constexpr bool WIDE = DQK == 256;
  static constexpr int BK = DQK <= 64    ? BK_DH64
                            : DQK == 128 ? BK_DH128
                            : MLA        ? BK_MLA
                                         : BK_DH256;
  // a TMA box: 64 columns, 128-byte rows in the 128-byte swizzle; at the
  // 16 and 32 tiles the tile's width, 32- or 64-byte rows in the swizzle
  // of that span
  static constexpr int BOX = DQK < BOX_COLS ? DQK : BOX_COLS;
  static constexpr int ROW = 2 * BOX;                   // a box row's bytes
  static constexpr int KROW = ROW / 32;                 // k-steps in a row
  // 64 x 64 tiles (dh 64): 3 stages, 56 KB, 3 CTAs per SM (at most 136
  // registers); larger tiles at dh 64 / 128: 2 stages and at most 204
  // registers (at dh 128 with 128 keys, 144 KB: one CTA per SM)
  static constexpr bool SMALL = BK * DQK <= 64 * 64;
  static constexpr int STAGES = MLA    ? STAGES_MLA
                                : WIDE ? STAGES_DH256
                                : SMALL ? 3
                                        : 2;
  static constexpr int Q_BOXES = DQK / BOX;             // Q's and K's
  static constexpr int V_BOXES = DV / BOX;
  static constexpr int Q_TILE = Q_BOXES * BQ * ROW;
  static constexpr int KV_BOX = BK * ROW;               // BK rows of a box
  static constexpr int K_TILE = Q_BOXES * KV_BOX;       // a K tile
  static constexpr int V_TILE = V_BOXES * KV_BOX;       // a V tile
  static constexpr int K_OFF = Q_TILE;                  // after Q
  static constexpr int V_OFF = K_OFF + STAGES * K_TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * V_TILE;
  // + the barriers, + slack to align the base to the swizzle's 1024 B
  static constexpr int SMEM = BAR_OFF + 128 + 1024;
  // MLA and dh 256: as many CTAs an SM as its shared memory holds (1 KB
  // of it reserved per CTA), and registers to match
  static constexpr int FIT = SM_SMEM / (SMEM + 1024);
  static constexpr int MIN_BLOCKS = !(MLA || WIDE) ? (SMALL ? 3 : 2)
                                    : FIT > 3      ? 3
                                    : FIT < 1      ? 1
                                                   : FIT;
  static_assert(DQK % BOX == 0 && DV % BOX == 0 && BK % 32 == 0,
                "tiles of whole boxes and 16-key steps");
  static_assert(8 * (1 + 3 * STAGES) <= 128, "the barriers' 128 bytes");
  static_assert(SMEM <= CTA_SMEM, "a CTA's shared memory");
};

// -- PTX wrappers ----------------------------------------------------------

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

// wgmma shared-memory descriptor for a tile written by TMA with the
// swizzle of its ROW-byte rows (layout type 1: 128 bytes, 2: 64, 3: 32):
// start address, leading and stride byte offsets, all in 16-byte units.
// K-major operands (Q, K): 8-row groups 8 ROW apart (stride), the
// leading offset unused.  MN-major V: 8-key groups 8 ROW apart (stride),
// 64-column boxes KV_BOX apart (leading; one box at the small tiles).
template <int ROW>
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr, uint32_t lead,
                                            uint32_t stride) {
  constexpr uint64_t layout = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lead >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((stride >> 4) & 0x3FFF) << 32) | (layout << 62);
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

// zero `bytes` (a multiple of 16) of shared memory from `p`, 16 bytes a
// thread in turn over `threads` threads
__device__ __forceinline__ void zero_smem(uint8_t* p, int bytes,
                                          int threads) {
  for (int i = (int)threadIdx.x * 16; i < bytes; i += threads * 16)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0u, 0u, 0u, 0u);
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

// D (+)= A B, m64nNk16 (N = 32, 64, 128), A and B from shared memory, both
// K-major
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

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

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(accumulate));
}

// D += P V, m64n16k16 and m64n32k16 (the 16 and 32 tiles): A (P, bf16)
// from registers, B (V) from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += P V, m64n64k16: A (P, bf16) from registers, B (V) from shared
// memory, MN-major (transposed)
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

// D += P V, m64n128k16: A (P, bf16) from registers, B (V) from shared
// memory, MN-major (transposed)
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

// D += P V, m64n256k16: A (P, bf16) from registers, B (V) from shared
// memory, MN-major (transposed) across four 64-column boxes
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&s)[BK / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (BK == 32)
    wgmma_ss_n32(s, da, db, accumulate);
  else if constexpr (BK == 64)
    wgmma_ss_n64(s, da, db, accumulate);
  else
    wgmma_ss_n128(s, da, db, accumulate);
}

template <int DV>
__device__ __forceinline__ void wgmma_pv(float (&o)[DV / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DV == 16)
    wgmma_rs_n16(o, a, db);
  else if constexpr (DV == 32)
    wgmma_rs_n32(o, a, db);
  else if constexpr (DV == 64)
    wgmma_rs_n64(o, a, db);
  else if constexpr (DV == 128)
    wgmma_rs_n128(o, a, db);
  else
    wgmma_rs_n256(o, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Grid: one CTA per (query block, head, sequence), flattened so that the
// longest query blocks of every head come first.  CAUSAL is a template
// argument: the causal instantiation is the causal kernel alone, with
// no branch of the non-causal one in its tile loop.  PAD: the head dims
// dqk / dv are below the tile's DQK / DV (the padded route); without it
// they are the tile's own and the kernel compiles as if it had none.
// LSE: also write each row's log-sum-exp to lse (B, H, S); without it
// lse is never read.
template <int DQK, int DV, bool CAUSAL, bool PAD, bool LSE = false>
__global__ void __launch_bounds__(THREADS, Cfg<DQK, DV>::MIN_BLOCKS)
    flash_attention_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                __nv_bfloat16* __restrict__ o,
                                float* __restrict__ lse, int S, int T,
                                int H, int G, int B, int n_qb, int dqk,
                                int dv, float scale_log2) {
  using C = Cfg<DQK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms: 1024 B
  const uint32_t sq = base;
  const uint32_t sk = base + C::K_OFF;
  const uint32_t sv = base + C::V_OFF;
  const uint32_t bar = base + C::BAR_OFF;
  // barriers, 8 bytes each: q_full, k_full[STAGES], v_full[STAGES],
  // empty[STAGES]
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar + 8u * (1 + C::STAGES + s); };
  auto empty = [&](int s) { return bar + 8u * (1 + 2 * C::STAGES + s); };

  const int hb = H * B;
  const int qb = n_qb - 1 - (int)(blockIdx.x / hb);   // longest first
  const int h = (int)(blockIdx.x % hb) % H;
  const int b = (int)(blockIdx.x % hb) / H;
  const int kvh = h / G;
  const int q0 = qb * BQ;
  constexpr int BK = C::BK;
  // keys [0, k_end) matter; causal, the last of their tiles holds q0
  const int k_end = CAUSAL ? min(q0 + BQ, S) : T;
  const int n_tiles = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the boxes that hold head-dim columns: TMA loads only those (columns
  // past dqk / dv in them read as zeros); a tile wider than the head dim
  // by a box or more keeps its other boxes at the zeros written here
  const int q_boxes = PAD ? (dqk + C::BOX - 1) / C::BOX : C::Q_BOXES;
  const int v_boxes = PAD ? (dv + C::BOX - 1) / C::BOX : C::V_BOXES;
  if (PAD) {
    uint8_t* tiles = smem_raw + (base - raw);  // the same, generic
    for (int x = q_boxes; x < C::Q_BOXES; ++x) {
      zero_smem(tiles + x * BQ * C::ROW, BQ * C::ROW, THREADS);
      for (int s = 0; s < C::STAGES; ++s)
        zero_smem(tiles + C::K_OFF + s * C::K_TILE + x * C::KV_BOX,
                  C::KV_BOX, THREADS);
    }
    for (int x = v_boxes; x < C::V_BOXES; ++x)
      for (int s = 0; s < C::STAGES; ++s)
        zero_smem(tiles + C::V_OFF + s * C::V_TILE + x * C::KV_BOX,
                  C::KV_BOX, THREADS);
    // (wgmma reads them through the async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: lane 0 of warp 4 issues every load ----
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, q_boxes * BQ * C::ROW);
#pragma unroll
      for (int x = 0; x < q_boxes; ++x)
        tma_load(sq + x * BQ * C::ROW, &tq, q_full, x * C::BOX, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % C::STAGES, n = t / C::STAGES;
        if (n > 0) mbar_wait(empty(s), (n - 1) & 1);   // stage used up
        mbar_expect_tx(k_full(s), q_boxes * C::KV_BOX);
#pragma unroll
        for (int x = 0; x < q_boxes; ++x)
          tma_load(sk + s * C::K_TILE + x * C::KV_BOX, &tk, k_full(s),
                   x * C::BOX, t * BK, kvh, b);
        mbar_expect_tx(v_full(s), v_boxes * C::KV_BOX);
#pragma unroll
        for (int x = 0; x < v_boxes; ++x)
          tma_load(sv + s * C::V_TILE + x * C::KV_BOX, &tv, v_full(s),
                   x * C::BOX, t * BK, kvh, b);
      }
    }
    return;
  }

  // ---- consumers: one warpgroup, 16 rows per warp, 2 rows per thread ----
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + warp * 16 + lane / 4;   // and row0 + 8
  const int col0 = 2 * (lane % 4);              // in every 8-column chunk

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;   // l: this thread's part

  // the scores; the first k-step of every tile overwrites them
  float sc[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % C::STAGES;
    const uint32_t parity = (t / C::STAGES) & 1;

    // S = Q K^T over dqk in steps of 16 (32 bytes inside a box row)
    mbar_wait(k_full(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      wgmma_qk<BK>(
          sc,
          desc_sw<C::ROW>(sq + (kk / C::KROW) * BQ * C::ROW +
                              (kk % C::KROW) * 32,
                          16, 8 * C::ROW),
          desc_sw<C::ROW>(sk + s * C::K_TILE + (kk / C::KROW) * C::KV_BOX +
                              (kk % C::KROW) * 32,
                          16, 8 * C::ROW),
          kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax; m in log2 units, the scale folded into one FMA per
    // score.  Masked: causal, the keys past each row, in the tiles that
    // reach past the block's first row (the last one alone when BK >=
    // BQ); otherwise the keys past T, in the last tile
    const bool edge = CAUSAL && BK < BQ ? (t + 1) * BK > q0 + 1
                                        : t == n_tiles - 1;
    if (edge) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = t * BK + 8 * j + col0 + e;
          if (CAUSAL ? key > row0 : key >= T) sc[4 * j + e] = NEG;
          if (CAUSAL ? key > row0 + 8 : key >= T) sc[4 * j + 2 + e] = NEG;
        }
      }
    }
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    // key 0 lies in every row's first tile (T >= 1), so m is a real score
    // from the first tile on and alpha = 2^(NEG - m) = 0 there, never NaN;
    // a later tile wholly masked for a row leaves its m, alpha 1 and p 0
    const float n0 = fmaxf(m0, quad_max(mx0) * scale_log2);
    const float n1 = fmaxf(m1, quad_max(mx1) * scale_log2);
    const float alpha0 = ex2(m0 - n0), alpha1 = ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // masked: 2^(-1e30 * scale - m) = 0
        const float p0 = ex2(fmaf(sc[4 * j + e], scale_log2, -n0));
        const float p1 = ex2(fmaf(sc[4 * j + 2 + e], scale_log2, -n1));
        ps0 += p0;
        ps1 += p1;
        sc[4 * j + e] = p0;
        sc[4 * j + 2 + e] = p1;
      }
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      acc[4 * j] *= alpha0;
      acc[4 * j + 1] *= alpha0;
      acc[4 * j + 2] *= alpha1;
      acc[4 * j + 3] *= alpha1;
    }
    // p rounded to bf16: the accumulator of keys 16kk..16kk+15 is the A
    // fragment of the k-step kk as it stands (rows r, r + 8; columns
    // col0 and col0 + 8)
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    }

    // O += P V over the tile's keys in steps of 16 (two 8-key groups)
    mbar_wait(v_full(s), parity);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv<DV>(acc, pa[kk],
                   desc_sw<C::ROW>(sv + s * C::V_TILE + kk * 16 * C::ROW,
                                   C::KV_BOX, 8 * C::ROW));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty(s));
  }

  // epilogue: acc / max(l, 1e-30), rows < S and v's dv columns (those
  // past them, in a padded tile, are zeros), straight from registers; o
  // is (B, S, H, dv)
  const float d0 = fmaxf(quad_sum(l0), 1e-30f);
  const float d1 = fmaxf(quad_sum(l1), 1e-30f);
  if constexpr (LSE) {
    // m is in log2 units of the scaled score: lse = (m + log2 l) ln 2
    if (lane % 4 == 0) {
      float* lrow = lse + ((long long)b * H + h) * S;
      if (row0 < S) lrow[row0] = (m0 + log2f(d0)) * LN2;
      if (row0 + 8 < S) lrow[row0 + 8] = (m1 + log2f(d1)) * LN2;
    }
  }
  const int d_out = PAD ? dv : DV;
  __nv_bfloat16* o0 =
      o + (((long long)b * S + row0) * H + h) * d_out + col0;
  __nv_bfloat16* o1 = o0 + 8LL * H * d_out;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    if (PAD && 8 * j + col0 >= dv) break;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j] / d0, acc[4 * j + 1] / d0);
    if (row0 + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
  }
}

// -- host side --------------------------------------------------------------

// cuTensorMapEncodeTiled is a driver function: reached through the
// runtime's entry-point query, so nothing new is linked
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
constexpr int ERR_SHAPE = -3;         // an input this kernel does not take

// a (B, rows, heads, d) bf16 tensor with element strides {b, s, h, 1}
// as a 4-d map (d, rows, heads, B) of box_cols-column boxes of box_rows
// rows, swizzled over the box row (64 columns: 128 bytes; 32: 64; 16:
// 32); rows past `rows` and columns past `d` (a tile wider than the head
// dim) read as zeros
int encode(CUtensorMap* map, const void* ptr, int B, int rows, int heads,
           int d, const long long* st, int box_rows, int box_cols) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

bool on_grid(const void* p, const long long* st) {
  return (reinterpret_cast<uintptr_t>(p) % 16) == 0 && st[3] == 1 &&
         st[0] % 8 == 0 && st[1] % 8 == 0 && st[2] % 8 == 0 && st[0] > 0 &&
         st[1] > 0 && st[2] > 0;
}

template <int DQK, int DV, bool CAUSAL, bool PAD, bool LSE = false>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           void* o, float* lse, int B, int S, int T, int H, int K, int dqk,
           int dv, cudaStream_t st) {
  using C = Cfg<DQK, DV>;
  auto kernel = flash_attention_kernel_sm90<DQK, DV, CAUSAL, PAD, LSE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_qb = (S + BQ - 1) / BQ;
  // the scale is q's true head dim's: 1 / sqrt(192) for MLA, not v's
  // 128, and 1 / sqrt(80) for d 80 in the 128 tile
  const float scale_log2 =
      (float)(1.0 / sqrt((double)dqk) * 1.4426950408889634);
  kernel<<<n_qb * H * B, THREADS, C::SMEM, st>>>(
      tq, tk, tv, (__nv_bfloat16*)o, lse, S, T, H, H / K, B, n_qb, dqk, dv,
      scale_log2);
  return (int)cudaGetLastError();
}

// the maps at the true head dims (Q and K at dqk, V at dv, each at most
// its tile's DQK / DV; K and V in BK-row boxes), then the causal or the
// non-causal instantiation of the (DQK, DV) tile, padded or not
template <int DQK, int DV, bool PAD>
int run(const void* q, const void* k, const void* v, void* o, int B, int S,
        int T, int H, int K, int dqk, int dv, const long long* q_strides,
        const long long* k_strides, const long long* v_strides, int causal,
        cudaStream_t st) {
  using C = Cfg<DQK, DV>;
  CUtensorMap tq, tk, tv;
  int r = encode(&tq, q, B, S, H, dqk, q_strides, BQ, C::BOX);
  if (r == 0) r = encode(&tk, k, B, T, K, dqk, k_strides, C::BK, C::BOX);
  if (r == 0) r = encode(&tv, v, B, T, K, dv, v_strides, C::BK, C::BOX);
  if (r != 0) return r;
  return causal ? launch<DQK, DV, true, PAD>(tq, tk, tv, o, nullptr, B, S, T,
                                             H, K, dqk, dv, st)
                : launch<DQK, DV, false, PAD>(tq, tk, tv, o, nullptr, B, S,
                                              T, H, K, dqk, dv, st);
}

// the causal tile of the training route (dh 64 or 128, the tile's own),
// writing the log-sum-exp beside the output
template <int D>
int run_lse(const void* q, const void* k, const void* v, void* o, float* lse,
            int B, int S, int H, int K, const long long* q_strides,
            const long long* k_strides, const long long* v_strides,
            cudaStream_t st) {
  using C = Cfg<D, D>;
  CUtensorMap tq, tk, tv;
  int r = encode(&tq, q, B, S, H, D, q_strides, BQ, C::BOX);
  if (r == 0) r = encode(&tk, k, B, S, K, D, k_strides, C::BK, C::BOX);
  if (r == 0) r = encode(&tv, v, B, S, K, D, v_strides, C::BK, C::BOX);
  if (r != 0) return r;
  return launch<D, D, true, false, true>(tq, tk, tv, o, lse, B, S, S, H, K,
                                         D, D, st);
}

}  // namespace

extern "C" {

// q (B, S, H, dh), k (B, T, K, dh) and v (B, T, K, dv), bfloat16, element
// strides {b, s, h, d} with d == 1, the others multiples of 8 (16 bytes),
// and 16-byte aligned pointers; o a contiguous (B, S, H, dv).  (dh, dv)
// is (192, 128) or equal, a multiple of 8 up to 256 (run in the tile of
// 64, 128 or 256 that holds it).  causal: 1 (T == S,
// query s reads keys t <= s) or 0 (every key).  Returns 0 when the launch
// was accepted, a cudaError_t, or one of this file's negative codes
// (flash_sm90_error_string).
int flash_attention_sm90_fwd(const void* q, const void* k, const void* v,
                             void* o, int B, int S, int T, int H, int K,
                             int dh, int dv, const long long* q_strides,
                             const long long* k_strides,
                             const long long* v_strides, int causal,
                             void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || (causal && T != S) || H <= 0 ||
      K <= 0 || H % K != 0 ||
      (long long)((S + BQ - 1) / BQ) * H * B > 0x7fffffffLL ||
      !on_grid(q, q_strides) || !on_grid(k, k_strides) ||
      !on_grid(v, v_strides) || (reinterpret_cast<uintptr_t>(o) % 16) != 0)
    return ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
#define FLASH_SM90_RUN(DQK, DV, PAD)                                        \
  return run<DQK, DV, PAD>(q, k, v, o, B, S, T, H, K, dh, dv, q_strides,    \
                           k_strides, v_strides, causal, st);
  // the tiles' own head dims
  if (dh == 64 && dv == 64) FLASH_SM90_RUN(64, 64, false)
  if (dh == 128 && dv == 128) FLASH_SM90_RUN(128, 128, false)
  if (dh == 192 && dv == 128) FLASH_SM90_RUN(192, 128, false)
  if (dh == 256 && dv == 256) FLASH_SM90_RUN(256, 256, false)
  // any other equal head dim on the grid, in the tile that holds it
  if (dh != dv || dh <= 0 || dh % 8 != 0 || dh > 256) return ERR_SHAPE;
  if (MIN_TILE <= 16 && dh <= 16) FLASH_SM90_RUN(16, 16, true)
  if (MIN_TILE <= 32 && dh <= 32) FLASH_SM90_RUN(32, 32, true)
  if (dh <= 64) FLASH_SM90_RUN(64, 64, true)
  if (dh <= 128) FLASH_SM90_RUN(128, 128, true)
  FLASH_SM90_RUN(256, 256, true)
#undef FLASH_SM90_RUN
}

// The training forward: causal, T == S, dh 64 or 128 (q, k, v as
// flash_attention_sm90_fwd takes them), o a contiguous (B, S, H, dh) and
// lse a contiguous float32 (B, H, S), each row's log-sum-exp of its
// scaled scores (natural log).
int flash_attention_sm90_fwd_lse(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int B, int S, int H,
                                 int K, int dh, const long long* q_strides,
                                 const long long* k_strides,
                                 const long long* v_strides, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || H % K != 0 ||
      (long long)((S + BQ - 1) / BQ) * H * B > 0x7fffffffLL ||
      !on_grid(q, q_strides) || !on_grid(k, k_strides) ||
      !on_grid(v, v_strides) || (reinterpret_cast<uintptr_t>(o) % 16) != 0)
    return ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  if (dh == 64)
    return run_lse<64>(q, k, v, o, lse, B, S, H, K, q_strides, k_strides,
                       v_strides, st);
  if (dh == 128)
    return run_lse<128>(q, k, v, o, lse, B, S, H, K, q_strides, k_strides,
                        v_strides, st);
  return ERR_SHAPE;
}

const char* flash_sm90_error_string(int code) {
  switch (code) {
    case ERR_NO_ENCODE:
      return "cuTensorMapEncodeTiled not found in the CUDA driver";
    case ERR_ENCODE:
      return "cuTensorMapEncodeTiled refused a tensor map";
    case ERR_SHAPE:
      return "an input the sm90 kernel does not take";
    default:
      return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
