// Flash attention (forward) for Hopper's tensor cores in float32: TF32
// products, equal head dims (q.k = v) that are multiples of 4 up to 256,
// or MLA's (192, 128), GQA layout, causal or over every key.
//
// Replaces the Pallas TPU kernel of the JAX package
//   src/repro/kernels/attention/flash.py  flash_attention_pallas
// for float32 q, k, v whose head dim is contiguous.  That kernel
// multiplies at the TPU's default precision (dot_general with no
// precision=, flash.py:49-50 and :64-66): one bf16 pass.  This one
// rounds its operands to TF32 (10 explicit mantissa bits, round to
// nearest), no more coarsely than the TPU kernel does, and keeps the rest
// of the function of csrc/flash.cu and ref.py: by index, scale
// 1/sqrt(dqk) (q's head dim: 192 for MLA), scores and the online softmax
// in float32, l summing the same p that multiplies v, output
// acc / max(l, 1e-30), masked score -1e30, on the port's layout: q (B, S,
// H, dqk), k (B, T, K, dqk), v (B, T, K, dv), query head h reading kv head
// h / (H / K) without a copy.  Causal: T == S, query s reads keys t <= s.
// Not causal: any T >= 1, every key valid (cross-attention's prompt pass).
//
// Head dims and tiles.  Five tiles are instantiated: (32, 32), (64, 64),
// (128, 128), (192, 128) -- MLA -- and (256, 256).  Any other equal head
// dim d on TMA's 16-byte grid (d % 4 == 0, d <= 256) runs in the smallest
// square tile that holds it (32 up to SMALL_TILE, then 64, 128, 256), in
// an instantiation of its own (PAD; the 32 tile exists only padded), so
// that the tiles' own head dims compile without the padded route's
// runtime dims (which cost MLA's pair 4 % in scripts/flash_ab.py's A/B on
// an H100).  The tensor maps are encoded at the true d, so TMA fills the
// columns past d with zeros, which add nothing to QK^T and give zero
// output columns, never stored; a 32-column box wholly past d is not
// loaded, and the CTA zeroes it once in every stage; the scale is the
// true d's, the output rows d wide.
//
// Precision (PRECISION below, one build per value; the routed value is
// the fastest that held every float32 check on the card,
// scripts/flash_f32_variants.py):
//   0  one TF32 pass on both products;
//   1  QK^T split, hi.hi + hi.lo + lo.hi with hi = cvt.rna.tf32(x) and
//      lo = cvt.rna.tf32(x - hi), and one pass on P.V;
//   2  both products split.
//
// Bound on an H100: S^2 (dqk + dv) operations per head (causal QK^T and
// PV) against S (2 dqk + 2 dv) elements moved, 4 bytes each.
// tinyllama-1.1b's prefill (B 1, S 1024, H 32, K 4, dh 64) needs 4.29
// GFLOP: 8.7 us at the 495 TFLOP/s TF32 tensor-core rate (26.0 us split
// on both products), against 5.6 us for its 18.9 MB, and 64 us at the
// 67 TFLOP/s float32 FMA rate of csrc/flash.cu.  recurrentgemma-2b's local
// layers (B 1, S 1024, H 10, K 1, dh 256): 5.37 GFLOP, 10.8 us at the
// TF32 rate, 80 us at the FMA rate, on 23 MB (6.9 us).  Bound by
// operations, so the products run on the tensor cores.
//
// What the card forces, and the design.  wgmma takes TF32 only K-major
// in shared memory for both operands, and V's tile (keys, dv) is
// MN-major for P.V with no TF32 transpose; so the products run on
// mma.sync.m16n8k8.tf32, whose fragments the threads load themselves,
// and each warp owns 16 query rows end to end (no warpgroup barrier in
// the tile loop).
// * One CTA per (query block of BQ = 64 rows, head, sequence), query
//   blocks issued longest first over every head; WG consumer warpgroups
//   (four warps of 16 rows each) and one producer warp.  The producer's
//   lane 0 loads the Q block once and streams K and V tiles of BK keys
//   through a ring of STAGES stages by TMA (4-d maps over (d, rows,
//   heads, B) from the tensors' strides, boxes of 32 float32 columns --
//   128 bytes -- with the 128-byte swizzle; rows past S or T read as
//   zeros), with a full mbarrier per tile and an empty one the 128
//   threads of the tile's warpgroup arrive on.  Causal tiles wholly in
//   the future of the block are never loaded, and a warp skips those
//   wholly in the future of its rows.
// * At dh 128 two warpgroups share the block's 64 rows and take
//   alternate key tiles, each with its own online softmax and two stages
//   of the ring; at the end the second hands its O, m and l to the first
//   through the freed stages, which joins them.  Eight consumer warps an
//   SM, and the longest causal blocks -- the grid's critical path at 12
//   heads, where all the blocks run at once -- take half as long
//   (scripts/flash_ab.py against one warpgroup, in turns: PERF.md).
// * S = Q K^T: A fragments from the Q block, B fragments from the K tile
//   (row = key, column = dim).  The 128-byte swizzle puts the eight rows
//   a fragment load touches in eight different 16-byte chunks, so each
//   32-bit load is free of bank conflicts.
// * The softmax runs on the m16n8 accumulator in registers (two rows a
//   thread, a row's max and sum over the four threads of a quad, the
//   scale folded into one FMA before ex2.approx), as in flash_sm90.cu.
// * P.V: the accumulator holds keys 2t and 2t+1 of each 8-key group where
//   the TF32 A fragment wants keys t and t + 4.  Rather than shuffle P,
//   the k index of the product is permuted: logical k t reads key 2t and
//   t + 4 reads key 2t + 1, in A (the accumulator as it stands) and in B
//   (each thread loads V rows 2t and 2t + 1); the sum over keys does not
//   depend on their order.  V's swizzled rows keep these loads free of
//   bank conflicts as well.
// * Key tiles: 64 keys at dh 32 (one warpgroup, two stages, 41 KB) and
//   at dh 64 (81 KB, two CTAs an SM); 32 at dh 128 (two warpgroups, four
//   stages, 160 KB), at MLA's 192 / 128 (one warpgroup, two stages, 128
//   KB) and at dh 256 (192 KB: the Q block alone is 64 KB, and the O
//   accumulator 128 registers a thread; one CTA an SM).
// Inputs it does not take (a head dim off the 16-byte grid or unequal
// but MLA's, a head dim that is not contiguous, strides or pointers off
// TMA's 16-byte grid) go to csrc/flash.cu; the wrapper decides by shape
// before the launch.

#include <cuda.h>            // CUtensorMap and the driver's enums only
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PRECISION = 0;        // 0, 1 or 2: see the header
// head dims up to SMALL_TILE run in the (32, 32) tile, and the rest up
// to 64 in (64, 64); 64 sends every d <= 64 to (64, 64) (the A/B of
// scripts/flash_pad_sweep.py: 32 where it was faster)
constexpr int SMALL_TILE = 32;
constexpr int BQ = 64;              // query rows of a CTA (four warps)
constexpr int BK_DH32 = 64;         // keys of one ring stage at dh 32
constexpr int BK_DH64 = 64;         // and at dh 64
constexpr int BK_DH128 = 32;        // at dh 128
constexpr int BK_WIDE = 32;         // at MLA's 192 / 128 and at dh 256
constexpr int WARPGROUP = 128;      // four consumer warps, 16 rows each
constexpr int BOX_COLS = 32;        // float32 columns of one TMA box
constexpr int ROW_BYTES = 128;      // a box row, the swizzle span
constexpr int SM_SMEM = 233472;     // an SM's shared memory (228 KB)
constexpr int CTA_SMEM = 232448;    // the most one CTA may take (227 KB)
constexpr float NEG = -1e30f;       // the masked score of the TPU kernel

template <int DQK, int DV>
struct Cfg {
  // consumer warpgroups, each over every WG-th key tile of the same 64
  // rows: two at dh 128 (one CTA an SM), one elsewhere (at dh 256 the
  // 288 threads of two cap a thread at 168 registers and O spills; at
  // MLA's 192 / 128 two, on 16-key tiles to fit, were slower)
  static constexpr int WG = DQK == 128 ? 2 : 1;
  static constexpr int BK = DQK == 32    ? BK_DH32
                            : DQK == 64  ? BK_DH64
                            : DQK == 128 ? BK_DH128
                                         : BK_WIDE;
  // two stages a warpgroup: tile t goes to stage t % STAGES, which only
  // warpgroup t % WG reads
  static constexpr int STAGES = 2 * WG;
  static constexpr int CONSUMERS = WG * WARPGROUP;
  static constexpr int THREADS = CONSUMERS + 32;   // and the producer warp
  static constexpr int Q_BOXES = DQK / BOX_COLS;        // Q's and K's
  static constexpr int V_BOXES = DV / BOX_COLS;
  static constexpr int Q_TILE = Q_BOXES * BQ * ROW_BYTES;
  static constexpr int KV_BOX = BK * ROW_BYTES;         // BK rows of a box
  static constexpr int K_TILE = Q_BOXES * KV_BOX;
  static constexpr int V_TILE = V_BOXES * KV_BOX;
  static constexpr int K_OFF = Q_TILE;
  static constexpr int V_OFF = K_OFF + STAGES * K_TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * V_TILE;
  // + the barriers, + slack to align the base to the swizzle's 1024 B
  static constexpr int SMEM = BAR_OFF + 128 + 1024;
  static constexpr int MIN_BLOCKS =
      WG == 1 && 2 * (SMEM + 1024) <= SM_SMEM ? 2 : 1;
  static_assert(DQK % BOX_COLS == 0 && DV % BOX_COLS == 0 && BK % 16 == 0,
                "tiles of whole boxes; a 16-row warp never meets a tile "
                "that masks all its keys for one row and not another");
  static_assert(8 * (1 + 3 * STAGES) <= 128, "the barriers' 128 bytes");
  static_assert(SMEM <= CTA_SMEM, "a CTA's shared memory");
  // the second warpgroup's O, m and l, through the stages at the end
  static_assert(WG == 1 || STAGES * (K_TILE + V_TILE) >=
                               (DV / 2 + 4) * WARPGROUP * 4,
                "the merge buffer");
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

// a float32 of the tiles, `off` bytes past the aligned base (a plain
// load: the mbarrier waits' memory clobbers keep it after the wait)
__device__ __forceinline__ float lds(const uint8_t* tiles, uint32_t off) {
  return *reinterpret_cast<const float*>(tiles + off);
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

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// an operand in TF32: hi alone, or hi and the rest lo when split
template <bool SPLIT>
struct Op {
  uint32_t hi, lo;
  __device__ __forceinline__ explicit Op(float x) : hi(tf32(x)), lo(0u) {
    if (SPLIT) lo = tf32(x - __uint_as_float(hi));
  }
  __device__ __forceinline__ Op() : hi(0u), lo(0u) {}
};

// D += A B, m16n8k8, TF32 in, float32 accumulator: d the four
// accumulators from `i` on
template <int N>
__device__ __forceinline__ void mma(float (&d)[N], int i, uint32_t a0,
                                    uint32_t a1, uint32_t a2, uint32_t a3,
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// one product at the precision of SPLIT: the small terms first
template <bool SPLIT, int N>
__device__ __forceinline__ void mma_tf32(float (&d)[N], int i,
                                         const Op<SPLIT> (&a)[4],
                                         const Op<SPLIT>& b0,
                                         const Op<SPLIT>& b1) {
  if (SPLIT) {
    mma(d, i, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b0.hi, b1.hi);
    mma(d, i, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.lo, b1.lo);
  }
  mma(d, i, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.hi, b1.hi);
}

// a barrier of `count` threads (the consumers), apart from __syncthreads'
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the byte offset of element (r, c) of a tile of ROWS rows written by TMA
// in 32-column boxes with the 128-byte swizzle: box c / 32, row r, 16-byte
// chunk (c % 32) / 4 xor r % 8
template <int ROWS>
__device__ __forceinline__ uint32_t at(uint32_t tile, int r, int c) {
  return tile + (c / BOX_COLS) * ROWS * ROW_BYTES + r * ROW_BYTES +
         ((((c % BOX_COLS) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// Grid: one CTA per (query block, head, sequence), flattened so that the
// longest query blocks of every head come first.  PAD: the head dims dqk
// / dv are below the tile's DQK / DV (the padded route); without it they
// are the tile's own and the kernel compiles as if it had none.
template <int DQK, int DV, bool CAUSAL, bool PAD>
__global__ void __launch_bounds__(Cfg<DQK, DV>::THREADS,
                                  Cfg<DQK, DV>::MIN_BLOCKS)
    flash_attention_kernel_sm90_f32(const __grid_constant__ CUtensorMap tq,
                                    const __grid_constant__ CUtensorMap tk,
                                    const __grid_constant__ CUtensorMap tv,
                                    float* __restrict__ o, int S, int T,
                                    int H, int G, int B, int n_qb,
                                    int dqk, int dv, float scale_log2) {
  using C = Cfg<DQK, DV>;
  constexpr int BK = C::BK, STAGES = C::STAGES, WG = C::WG;
  constexpr bool SPLIT_QK = PRECISION >= 1;
  constexpr bool SPLIT_PV = PRECISION >= 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms: 1024 B
  uint8_t* tiles = smem_raw + (base - raw);  // the same, generic
  const uint32_t sq = base;
  const uint32_t sk = base + C::K_OFF;
  const uint32_t sv = base + C::V_OFF;
  const uint32_t bar = base + C::BAR_OFF;
  // barriers, 8 bytes each: q_full, k_full[STAGES], v_full[STAGES],
  // empty[STAGES]
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar + 8u * (1 + 2 * STAGES + s); };

  const int hb = H * B;
  const int qb = n_qb - 1 - (int)(blockIdx.x / hb);   // longest first
  const int h = (int)(blockIdx.x % hb) % H;
  const int b = (int)(blockIdx.x % hb) / H;
  const int kvh = h / G;
  const int q0 = qb * BQ;
  // keys [0, k_end) matter; causal, the last of their tiles holds q0
  const int k_end = CAUSAL ? min(q0 + BQ, S) : T;
  const int n_tiles = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), WARPGROUP);     // one warpgroup reads a stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the boxes that hold head-dim columns: TMA loads only those (columns
  // past dqk / dv in them read as zeros); a tile wider than the head dim
  // by a box or more keeps its other boxes at the zeros written here
  const int q_boxes = PAD ? (dqk + BOX_COLS - 1) / BOX_COLS : C::Q_BOXES;
  const int v_boxes = PAD ? (dv + BOX_COLS - 1) / BOX_COLS : C::V_BOXES;
  if (PAD) {
    for (int x = q_boxes; x < C::Q_BOXES; ++x) {
      zero_smem(tiles + x * BQ * ROW_BYTES, BQ * ROW_BYTES, C::THREADS);
      for (int s = 0; s < STAGES; ++s)
        zero_smem(tiles + C::K_OFF + s * C::K_TILE + x * C::KV_BOX,
                  C::KV_BOX, C::THREADS);
    }
    for (int x = v_boxes; x < C::V_BOXES; ++x)
      for (int s = 0; s < STAGES; ++s)
        zero_smem(tiles + C::V_OFF + s * C::V_TILE + x * C::KV_BOX,
                  C::KV_BOX, C::THREADS);
  }
  __syncthreads();

  if (threadIdx.x >= C::CONSUMERS) {
    // ---- producer: lane 0 of the last warp issues every load ----
    if (threadIdx.x == C::CONSUMERS) {
      mbar_expect_tx(q_full, q_boxes * BQ * ROW_BYTES);
#pragma unroll
      for (int x = 0; x < q_boxes; ++x)
        tma_load(sq + x * BQ * ROW_BYTES, &tq, q_full, x * BOX_COLS, q0, h,
                 b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES, n = t / STAGES;
        if (n > 0) mbar_wait(empty(s), (n - 1) & 1);   // stage used up
        mbar_expect_tx(k_full(s), q_boxes * C::KV_BOX);
#pragma unroll
        for (int x = 0; x < q_boxes; ++x)
          tma_load(sk + s * C::K_TILE + x * C::KV_BOX, &tk, k_full(s),
                   x * BOX_COLS, t * BK, kvh, b);
        mbar_expect_tx(v_full(s), v_boxes * C::KV_BOX);
#pragma unroll
        for (int x = 0; x < v_boxes; ++x)
          tma_load(sv + s * C::V_TILE + x * C::KV_BOX, &tv, v_full(s),
                   x * BOX_COLS, t * BK, kvh, b);
      }
    }
    return;
  }

  // ---- consumers: 16 rows a warp, rows g and g + 8 of them a thread;
  // warpgroup wg takes key tiles wg, wg + WG, ... ----
  const int wg = threadIdx.x / WARPGROUP;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, tq4 = lane % 4;
  const int wrow = warp * 16;                   // the warp's first row
  const int row0 = q0 + wrow + g;               // and row0 + 8
  const int warp_last = q0 + wrow + 15;

  float acc[DV / 2];                            // DV / 8 blocks of 4
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;   // l: this thread's part
  float sc[BK / 2];                             // BK / 8 blocks of 4

  mbar_wait(q_full, 0);
  for (int t = wg; t < n_tiles; t += WG) {
    const int s = t % STAGES;
    const uint32_t parity = (t / STAGES) & 1;
    mbar_wait(k_full(s), parity);
    // every key of the tile in the future of the warp's rows (the waits
    // first: no arrival counts toward the stage's earlier use, and no
    // load is in flight when the stages take the merge)
    if (CAUSAL && t * BK > warp_last) {
      mbar_wait(v_full(s), parity);
      mbar_arrive(empty(s));
      continue;
    }

    // S = Q K^T over dqk in steps of 8
    const uint32_t kt = C::K_OFF + s * C::K_TILE;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQK / 8; ++kk) {
      const int c = 8 * kk + tq4;
      const Op<SPLIT_QK> a[4] = {
          Op<SPLIT_QK>(lds(tiles, at<BQ>(0, wrow + g, c))),
          Op<SPLIT_QK>(lds(tiles, at<BQ>(0, wrow + g + 8, c))),
          Op<SPLIT_QK>(lds(tiles, at<BQ>(0, wrow + g, c + 4))),
          Op<SPLIT_QK>(lds(tiles, at<BQ>(0, wrow + g + 8, c + 4)))};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const Op<SPLIT_QK> b0(lds(tiles, at<BK>(kt, 8 * j + g, c)));
        const Op<SPLIT_QK> b1(lds(tiles, at<BK>(kt, 8 * j + g, c + 4)));
        mma_tf32<SPLIT_QK>(sc, 4 * j, a, b0, b1);
      }
    }

    // online softmax; m in log2 units, the scale folded into one FMA per
    // score.  Masked: causal, the keys past each row in the tiles that
    // reach past the warp's first row; otherwise the keys past T, in the
    // last tile
    const bool edge = CAUSAL ? (t + 1) * BK - 1 > q0 + wrow
                             : t == n_tiles - 1;
    if (edge) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = t * BK + 8 * j + 2 * tq4 + e;
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

    // O += P V over the tile's keys in steps of 8.  k index t of the
    // product is key 2t of the step, t + 4 is key 2t + 1: A is the score
    // block as it stands (rows g, g + 8; keys 2t, 2t + 1), B rows 2t and
    // 2t + 1 of the V tile
    mbar_wait(v_full(s), parity);
    const uint32_t vt = C::V_OFF + s * C::V_TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const Op<SPLIT_PV> a[4] = {
          Op<SPLIT_PV>(sc[4 * kk]), Op<SPLIT_PV>(sc[4 * kk + 2]),
          Op<SPLIT_PV>(sc[4 * kk + 1]), Op<SPLIT_PV>(sc[4 * kk + 3])};
      const int key = 8 * kk + 2 * tq4;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const Op<SPLIT_PV> b0(lds(tiles, at<BK>(vt, key, 8 * j + g)));
        const Op<SPLIT_PV> b1(lds(tiles, at<BK>(vt, key + 1, 8 * j + g)));
        mma_tf32<SPLIT_PV>(acc, 4 * j, a, b0, b1);
      }
    }
    mbar_arrive(empty(s));
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (WG == 2) {
    // the second warpgroup's O, m and l to the first through the stages,
    // free once both have consumed every tile (each waited for every
    // load of its tiles); its thread i holds what the first's thread i
    // does, the same rows and columns
    float* buf = reinterpret_cast<float*>(tiles + C::K_OFF);
    const int i = threadIdx.x % WARPGROUP;
    named_barrier(1, C::CONSUMERS);
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < DV / 2; ++j) buf[j * WARPGROUP + i] = acc[j];
      buf[(DV / 2) * WARPGROUP + i] = m0;
      buf[(DV / 2 + 1) * WARPGROUP + i] = m1;
      buf[(DV / 2 + 2) * WARPGROUP + i] = l0;
      buf[(DV / 2 + 3) * WARPGROUP + i] = l1;
    }
    named_barrier(1, C::CONSUMERS);
    if (wg == 1) return;
    // the two online softmaxes joined: a part with no key of a row (m
    // still -1e30) scales to 0
    const float M0 = buf[(DV / 2) * WARPGROUP + i];
    const float M1 = buf[(DV / 2 + 1) * WARPGROUP + i];
    const float n0 = fmaxf(m0, M0), n1 = fmaxf(m1, M1);
    const float a0 = ex2(m0 - n0), b0 = ex2(M0 - n0);
    const float a1 = ex2(m1 - n1), b1 = ex2(M1 - n1);
    l0 = l0 * a0 + buf[(DV / 2 + 2) * WARPGROUP + i] * b0;
    l1 = l1 * a1 + buf[(DV / 2 + 3) * WARPGROUP + i] * b1;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      acc[4 * j] = acc[4 * j] * a0 + buf[(4 * j) * WARPGROUP + i] * b0;
      acc[4 * j + 1] =
          acc[4 * j + 1] * a0 + buf[(4 * j + 1) * WARPGROUP + i] * b0;
      acc[4 * j + 2] =
          acc[4 * j + 2] * a1 + buf[(4 * j + 2) * WARPGROUP + i] * b1;
      acc[4 * j + 3] =
          acc[4 * j + 3] * a1 + buf[(4 * j + 3) * WARPGROUP + i] * b1;
    }
  }

  // epilogue: acc / max(l, 1e-30), rows < S and v's dv columns (those
  // past them, in a padded tile, are zeros; dv is even, so a thread's
  // pair of columns is in or out together), straight from registers; o
  // is (B, S, H, dv)
  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
  const int d_out = PAD ? dv : DV;
  float* o0 = o + (((long long)b * S + row0) * H + h) * d_out + 2 * tq4;
  float* o1 = o0 + 8LL * H * d_out;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    if (PAD && 8 * j + 2 * tq4 >= dv) break;
    if (row0 < S)
      *reinterpret_cast<float2*>(o0 + 8 * j) =
          make_float2(acc[4 * j] / d0, acc[4 * j + 1] / d0);
    if (row0 + 8 < S)
      *reinterpret_cast<float2*>(o1 + 8 * j) =
          make_float2(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
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

// a (B, rows, heads, d) float32 tensor with element strides {b, s, h, 1}
// as a 4-d map (d, rows, heads, B) of 32-column boxes of box_rows rows,
// 128-byte swizzle; rows past `rows` and columns past `d` (a tile wider
// than the head dim) read as zeros
int encode(CUtensorMap* map, const void* ptr, int B, int rows, int heads,
           int d, const long long* st, int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 4,
                                 (cuuint64_t)st[2] * 4,
                                 (cuuint64_t)st[0] * 4};
  const cuuint32_t box[4] = {BOX_COLS, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// TMA's grid: a 16-byte aligned pointer, the head dim contiguous and the
// other strides positive multiples of 16 bytes (4 float32)
bool on_grid(const void* p, const long long* st) {
  return (reinterpret_cast<uintptr_t>(p) % 16) == 0 && st[3] == 1 &&
         st[0] % 4 == 0 && st[1] % 4 == 0 && st[2] % 4 == 0 && st[0] > 0 &&
         st[1] > 0 && st[2] > 0;
}

template <int DQK, int DV, bool CAUSAL, bool PAD>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           void* o, int B, int S, int T, int H, int K, int dqk, int dv,
           cudaStream_t st) {
  using C = Cfg<DQK, DV>;
  auto kernel = flash_attention_kernel_sm90_f32<DQK, DV, CAUSAL, PAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_qb = (S + BQ - 1) / BQ;
  // the scale is q's true head dim's: 1 / sqrt(192) for MLA, not v's
  // 128, and 1 / sqrt(80) for d 80 in the 128 tile
  const float scale_log2 =
      (float)(1.0 / sqrt((double)dqk) * 1.4426950408889634);
  kernel<<<n_qb * H * B, C::THREADS, C::SMEM, st>>>(
      tq, tk, tv, (float*)o, S, T, H, H / K, B, n_qb, dqk, dv,
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
  constexpr int BK = Cfg<DQK, DV>::BK;
  CUtensorMap tq, tk, tv;
  int r = encode(&tq, q, B, S, H, dqk, q_strides, BQ);
  if (r == 0) r = encode(&tk, k, B, T, K, dqk, k_strides, BK);
  if (r == 0) r = encode(&tv, v, B, T, K, dv, v_strides, BK);
  if (r != 0) return r;
  return causal ? launch<DQK, DV, true, PAD>(tq, tk, tv, o, B, S, T, H, K,
                                             dqk, dv, st)
                : launch<DQK, DV, false, PAD>(tq, tk, tv, o, B, S, T, H, K,
                                              dqk, dv, st);
}

}  // namespace

extern "C" {

// q (B, S, H, dh), k (B, T, K, dh) and v (B, T, K, dv), float32, element
// strides {b, s, h, d} with d == 1, the others multiples of 4 (16 bytes),
// and 16-byte aligned pointers; o a contiguous (B, S, H, dv).  (dh, dv)
// is (192, 128) or equal, a multiple of 4 up to 256 (run in the tile of
// 32, 64, 128 or 256 that holds it).  causal: 1 (T == S,
// query s reads keys t <= s) or 0 (every key).  Returns 0 when the launch
// was accepted, a cudaError_t, or one of this file's negative codes
// (flash_sm90_f32_error_string).
int flash_attention_sm90_f32_fwd(const void* q, const void* k, const void* v,
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
#define FLASH_F32_RUN(DQK, DV, PAD)                                         \
  return run<DQK, DV, PAD>(q, k, v, o, B, S, T, H, K, dh, dv, q_strides,    \
                           k_strides, v_strides, causal, st);
  // the tiles' own head dims (the 32 tile's too runs as a padded one)
  if (dh == 64 && dv == 64) FLASH_F32_RUN(64, 64, false)
  if (dh == 128 && dv == 128) FLASH_F32_RUN(128, 128, false)
  if (dh == 192 && dv == 128) FLASH_F32_RUN(192, 128, false)
  if (dh == 256 && dv == 256) FLASH_F32_RUN(256, 256, false)
  // any other equal head dim on the grid, in the tile that holds it
  if (dh != dv || dh <= 0 || dh % 4 != 0 || dh > 256) return ERR_SHAPE;
  if (dh <= SMALL_TILE) FLASH_F32_RUN(SMALL_TILE, SMALL_TILE, true)
  if (dh <= 64) FLASH_F32_RUN(64, 64, true)
  if (dh <= 128) FLASH_F32_RUN(128, 128, true)
  FLASH_F32_RUN(256, 256, true)
#undef FLASH_F32_RUN
}

// which products the build splits: its PRECISION (0, 1 or 2)
int flash_sm90_f32_precision() { return PRECISION; }

const char* flash_sm90_f32_error_string(int code) {
  switch (code) {
    case ERR_NO_ENCODE:
      return "cuTensorMapEncodeTiled not found in the CUDA driver";
    case ERR_ENCODE:
      return "cuTensorMapEncodeTiled refused a tensor map";
    case ERR_SHAPE:
      return "an input the sm90 float32 kernel does not take";
    default:
      return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
