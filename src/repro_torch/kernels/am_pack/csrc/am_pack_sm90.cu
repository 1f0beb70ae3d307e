// The GAScore's DataMover redesigned for Hopper: a latency-hiding gather
// and a parallel scatter that keeps the in-order result, for 32-bit and
// 16-bit words.
//
// Replaces the Pallas TPU kernels of the JAX package
//   src/repro/kernels/am_pack/am_pack.py:41  am_pack_pallas    (gather)
//   src/repro/kernels/am_pack/am_pack.py:58  am_unpack_pallas  (scatter)
// with the same functions as csrc/am_pack.cu (the first, simple design,
// kept beside this one for A/B) and as kernels/am_pack/ref.py, bit for
// bit: each kernel row k (one Shoal kernel) has B blocks, block b moving
// min(nwords[k][b], W) words between packet row (k, b) and the segment
// at addr[k][b].
//
// Bound on an H100.  Both functions move each word once and do at most
// one operation on it, so bytes bound them (3.35 TB/s); at the GAScore's
// packet sizes (a few hundred KB per call) that bound is ~0.1 us, below
// one launch, and what sets the time is the launch and the device-memory
// round trips a CTA waits for one after the other.  The simple design
// waits for three to six of them in a row on 8 to 16 CTAs.  This one
// waits for two or three (the header words, then every data word at
// once, then the stores), on a grid that fills the card:
//
// Gather.  The lanes of every (k, b) row are tiled over CTAs so that the
// grid fills the card (kernels/am_pack/am_pack.py datamover_plan: T
// threads of VT units each, at least 132 CTAs where the rows allow).  A
// unit is V = 16 / sizeof(word) lanes.  Every thread loads the row's
// addr and nwords itself (a broadcast, so no barrier stands before the
// data loads); then it issues all its data loads before any store.  Where the segment word of a lane and its packet slot are
// congruent modulo V (a per-row test on addr, made here) and both tensors
// are 16-byte aligned, a unit is one 16-byte vector load and store; the
// ragged head and tail of a row, units that leave the segment, and rows
// that are not congruent move word by word.  out[k][b][j] = v * (j <
// nwords) as a multiply in the word's type (__fmul_rn, __hmul), never a
// select: a masked NaN or +-inf reads NaN, a masked negative -0.0; int32
// lanes past nwords are 0; a lane outside [0, S) reads 0.
//
// Scatter.  Blocks apply in order per kernel row (the last writer wins, a
// read-modify-write handler sees every earlier block), handlers 0 nop,
// 1 write, 2 add, 3 max, 4 min (op code clamped into 0..4; NaN-propagating
// max/min; int32 add wraps; 16-bit add rounds once, __hadd).  Lanes past
// nwords, of inactive blocks or outside the segment are dropped.  One
// launch on the gather's grid; a CTA holds a tile of the lanes of one
// block b, and no CTA waits for another:
//  * its payload lanes load first (they do not depend on any header);
//    meanwhile it stages its row's B headers (addr, the in-segment
//    interval [lo, hi) of the block's live lanes, the op code) in shared
//    memory with one coalesced load; a block is live if active, not nop
//    and nwords > 0;
//  * one warp ballot per 32 blocks marks, in a shared bitmask, the live
//    blocks whose interval meets b's (its neighbours);
//  * if none does, every word of b is b's alone: the CTA applies its
//    lanes at once, all loads before any store, in 16-byte vectors where
//    the row allows, and a write lane never loads the segment word;
//  * otherwise, word by word, one lane per thread: the lane walks the
//    neighbours in block order (the mask's bits); if an earlier block
//    touches its word, that block's thread holds the word and the lane
//    does nothing; else it lists the later blocks on the word, loads
//    their payload words (and the segment word if b's handler reads it)
//    at once, and folds them in block order in registers (a word that
//    more than FOLD_DEPTH blocks touch is folded in a loop).
// Each word has one writer, and that writer applies the word's lanes in
// block order, so the result is bitwise the in-order result without the
// simple design's walk: no __syncthreads() per block, no one CTA per row
// holding every block.  The ownership test costs a CTA one ballot per 32
// blocks and a lane one mask word per 32 blocks and one interval test
// per neighbour.  Past STAGE_MAX_B
// blocks (kernels/am_pack/am_pack.py; 2048 headers fill 32 of a CTA's 48
// KB) the launch walks every block of a row in order instead
// (scatter_walk_sm90_kernel, the simple design's walk for every word
// type).
//
// A scatter CTA has V threads per unit so that the shared-word path runs
// one lane per thread: its ownership test and fold are a few hundred
// instructions a lane, and with V lanes a thread they ran one after
// another on a single warp, ~0.3 us a lane (PERF.md).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int VEC_BYTES = 16;

struct F32 {
  using U = float;
  static __device__ __forceinline__ U mask(U v, bool keep) {
    return __fmul_rn(v, keep ? 1.0f : 0.0f);      // v * mask, never a select
  }
  static __device__ __forceinline__ U apply(int op, U r, U p) {
    switch (op) {
      case 1: return p;
      case 2: return __fadd_rn(r, p);
      case 3: return r != r ? r : (p != p ? p : (r > p ? r : p));   // NaN
      case 4: return r != r ? r : (p != p ? p : (r < p ? r : p));   // wins
      default: return r;
    }
  }
};

struct I32 {
  using U = int;
  static __device__ __forceinline__ U mask(U v, bool keep) {
    return keep ? v : 0;
  }
  static __device__ __forceinline__ U apply(int op, U r, U p) {
    switch (op) {
      case 1: return p;
      case 2: return (int)((unsigned)r + (unsigned)p);   // wraps like int32
      case 3: return r > p ? r : p;
      case 4: return r < p ? r : p;
      default: return r;
    }
  }
};

// 16-bit words travel as their bits (unsigned short) and are computed on
// through the type's intrinsics.  max/min compare the exact values and
// return one operand's bits, as torch.maximum / torch.minimum do.
struct BF16Bits {
  using H = __nv_bfloat16;
  static constexpr unsigned short ONE = 0x3F80;
  static __device__ __forceinline__ H h(unsigned short v) {
    return __ushort_as_bfloat16(v);
  }
  static __device__ __forceinline__ unsigned short bits(H v) {
    return __bfloat16_as_ushort(v);
  }
  static __device__ __forceinline__ float f(unsigned short v) {
    return __bfloat162float(h(v));
  }
};

struct F16Bits {
  using H = __half;
  static constexpr unsigned short ONE = 0x3C00;
  static __device__ __forceinline__ H h(unsigned short v) {
    return __ushort_as_half(v);
  }
  static __device__ __forceinline__ unsigned short bits(H v) {
    return __half_as_ushort(v);
  }
  static __device__ __forceinline__ float f(unsigned short v) {
    return __half2float(h(v));
  }
};

template <class O>
struct Half16 {
  using U = unsigned short;
  static __device__ __forceinline__ U mask(U v, bool keep) {
    return O::bits(__hmul(O::h(v), O::h(keep ? O::ONE : (U)0)));
  }
  static __device__ __forceinline__ U apply(int op, U r, U p) {
    switch (op) {
      case 1: return p;
      case 2: return O::bits(__hadd(O::h(r), O::h(p)));
      case 3: {
        const float a = O::f(r), b = O::f(p);
        return a != a ? r : (b != b ? p : (a > b ? r : p));
      }
      case 4: {
        const float a = O::f(r), b = O::f(p);
        return a != a ? r : (b != b ? p : (a < b ? r : p));
      }
      default: return r;
    }
  }
};

using BF16 = Half16<BF16Bits>;
using F16 = Half16<F16Bits>;

template <typename U>
union Vec {
  uint4 raw;
  U e[VEC_BYTES / sizeof(U)];
};

// Unit u of a packet row covers lanes [lo, hi): unit 0 the head [0, h)
// that reaches the first 16-byte boundary of the row's packet slots,
// unit u >= 1 the V lanes from h + (u - 1) V, cut at W.
__device__ __forceinline__ void unit_lanes(int u, int h, int W, int V,
                                           int& lo, int& hi) {
  lo = u == 0 ? 0 : min(W, h + (u - 1) * V);
  hi = min(W, h + u * V);
}

// Lanes before the first vector of packet row `row` (of W lanes) of a
// 16-byte aligned tensor.  V is a power of two, so 32-bit arithmetic
// that wraps keeps the low bits right.
__device__ __forceinline__ int head_lanes(unsigned row, int W, int V) {
  return (int)((0u - row * (unsigned)W) & (unsigned)(V - 1));
}

// True when segment element k * S + a and packet row `row`'s first lane
// (both from 16-byte aligned bases) sit at the same offset in 16 bytes.
__device__ __forceinline__ bool congruent(int k, int S, int a, unsigned row,
                                          int W, int V) {
  return (((unsigned)k * (unsigned)S + (unsigned)a - row * (unsigned)W)
          & (unsigned)(V - 1)) == 0;
}

// The grid is (tiles, B, K): CTA (t, b, k) holds tile t of packet row
// (k, b), so no CTA divides to find its row.
template <class Tr, int VT>
__global__ void gather_sm90_kernel(const typename Tr::U* __restrict__ seg,
                                   int S, const int* __restrict__ addr,
                                   const int* __restrict__ nwords, int W,
                                   int vec_ok,
                                   typename Tr::U* __restrict__ out) {
  using U = typename Tr::U;
  constexpr int V = VEC_BYTES / sizeof(U);
  const int k = blockIdx.z;
  const unsigned row = (unsigned)k * gridDim.y + blockIdx.y;
  const int a = __ldg(addr + row);                // every thread: a broadcast
  const int nw = __ldg(nwords + row);
  const int h = head_lanes(row, W, V);
  const bool vec = vec_ok && congruent(k, S, a, row, W, V);
  const U* s = seg + (size_t)k * S;
  U* o = out + (size_t)row * W;

  U vals[VT][V];
  bool whole[VT];
#pragma unroll
  for (int t = 0; t < VT; ++t) {                  // every load first
    const int u = (int)((blockIdx.x * VT + t) * blockDim.x + threadIdx.x);
    int lo, hi;
    unit_lanes(u, h, W, V, lo, hi);
    const long long w = (long long)a + lo;
    whole[t] = vec && hi - lo == V && w >= 0 && w + V <= S;
    if (whole[t]) {
      Vec<U> x;
      x.raw = __ldg(reinterpret_cast<const uint4*>(s + w));
#pragma unroll
      for (int e = 0; e < V; ++e) vals[t][e] = x.e[e];
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        vals[t][e] = (lo + e < hi && w + e >= 0 && w + e < S) ? s[w + e]
                                                              : U(0);
    }
  }
#pragma unroll
  for (int t = 0; t < VT; ++t) {                  // then every store
    const int u = (int)((blockIdx.x * VT + t) * blockDim.x + threadIdx.x);
    int lo, hi;
    unit_lanes(u, h, W, V, lo, hi);
    if (whole[t]) {
      Vec<U> x;
#pragma unroll
      for (int e = 0; e < V; ++e) x.e[e] = Tr::mask(vals[t][e], lo + e < nw);
      *reinterpret_cast<uint4*>(o + lo) = x.raw;
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (lo + e < hi) o[lo + e] = Tr::mask(vals[t][e], lo + e < nw);
    }
  }
}

// A staged block header: x addr, [y, z) the in-segment words its live
// lanes land on (empty for a dead block), w the op code (clamped).
__device__ __forceinline__ void stage_headers(
    int4* hdr, int k, int S, int B, int W, const int* __restrict__ addr,
    const int* __restrict__ nwords, const int* __restrict__ handler,
    const int* __restrict__ active) {
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const size_t r = (size_t)k * B + b;
    const int a = addr[r];
    const int nw = min(nwords[r], W);
    const int op = min(max(handler[r], 0), 4);
    long long lo = a > 0 ? a : 0;
    long long hi = (long long)a + nw;
    if (hi > S) hi = S;
    if (!active[r] || op == 0 || hi <= lo) lo = hi = 0;
    hdr[b] = make_int4(a, (int)lo, (int)hi, op);
  }
}

__device__ __forceinline__ bool meet(int4 x, int4 y) {
  return max(x.y, y.y) < min(x.z, y.z);
}

__device__ __forceinline__ bool touches(int4 x, long long w) {
  return x.y <= w && w < x.z;
}

// The blocks that meet block b, as a bitmask over the row's blocks in
// shared memory (bit c of word c / 32): a lane's ownership test walks
// these, not all B blocks.
__device__ __forceinline__ bool mark_neighbours(const int4* hdr,
                                                unsigned* nb, int B, int b,
                                                int4 me) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool any = false;
  for (int i = warp; i * 32 < B; i += blockDim.x >> 5) {
    const int c = i * 32 + lane;
    const unsigned bits = __ballot_sync(
        0xffffffffu, c < B && c != b && meet(me, hdr[c]));
    if (lane == 0) nb[i] = bits;
    any |= bits != 0;
  }
  return any;
}

constexpr int FOLD_DEPTH = 4;   // blocks on one word folded from registers

// Word w of block b, whose block meets others: is b the first block that
// touches w, and which later blocks touch it (up to FOLD_DEPTH - 1, in
// `later`; `deep` if more do)?  Walks the neighbour mask in block order.
__device__ __forceinline__ bool first_toucher(const int4* hdr,
                                              const unsigned* nb, int B,
                                              int b, int w,
                                              int (&later)[FOLD_DEPTH - 1],
                                              int& n, bool& deep) {
  n = 0;
  deep = false;
  for (int i = 0; i * 32 < B; ++i) {
    for (unsigned bits = nb[i]; bits; bits &= bits - 1) {
      const int c = i * 32 + __ffs(bits) - 1;
      if (!touches(hdr[c], w)) continue;
      if (c < b) return false;                     // an earlier block's
      if (n == FOLD_DEPTH - 1) {
        deep = true;
        return true;
      }
#pragma unroll
      for (int d = 0; d < FOLD_DEPTH - 1; ++d)
        if (d == n) later[d] = c;
      ++n;
    }
  }
  return true;
}

// Word w that block b touches first, with other live blocks after it:
// b's lane and every later block's lane on w, folded in block order.
// The serial form, for a word more than FOLD_DEPTH blocks touch.
template <class Tr>
__device__ void fold_word(typename Tr::U* __restrict__ s,
                          const typename Tr::U* __restrict__ pay,
                          const int4* hdr, const unsigned* nb, int k, int B,
                          int W, int b, int w, typename Tr::U own) {
  const int op = hdr[b].w;
  typename Tr::U v = op == 1 ? own : Tr::apply(op, s[w], own);
  for (int i = b / 32; i * 32 < B; ++i) {
    for (unsigned bits = nb[i]; bits; bits &= bits - 1) {
      const int c = i * 32 + __ffs(bits) - 1;
      const int4 x = hdr[c];
      if (c < b || !touches(x, w)) continue;
      const typename Tr::U p = pay[((size_t)k * B + c) * W + (w - x.x)];
      v = x.w == 1 ? p : Tr::apply(x.w, v, p);
    }
  }
  s[w] = v;
}

// The grid is (tiles, B, K) as for the gather, and a CTA holds T =
// blockDim.x / V units of its packet row: thread i < T takes unit i when
// no other block meets b (V lanes, a vector where the row allows), and
// every thread takes one lane of the tile when one does, so a lane's
// ownership test and fold run on a thread of its own.
template <class Tr>
__global__ void scatter_sm90_kernel(typename Tr::U* __restrict__ seg, int S,
                                    const typename Tr::U* __restrict__ pay,
                                    const int* __restrict__ addr,
                                    const int* __restrict__ nwords,
                                    const int* __restrict__ handler,
                                    const int* __restrict__ active, int W,
                                    int vec_ok) {
  using U = typename Tr::U;
  constexpr int V = VEC_BYTES / sizeof(U);
  extern __shared__ int4 hdr[];          // the row's B headers, then nb
  const int B = gridDim.y, b = blockIdx.y, k = blockIdx.z;
  unsigned* nb = reinterpret_cast<unsigned*>(hdr + B);
  const unsigned row = (unsigned)k * B + b;
  const int h = head_lanes(row, W, V);
  const int T = blockDim.x / V;
  const bool unit_thread = threadIdx.x < T;
  int lo, hi;
  unit_lanes((int)(blockIdx.x * T + threadIdx.x), h, W, V, lo, hi);
  const U* p = pay + (size_t)row * W;

  // A unit's payload lanes do not depend on the headers: their loads go
  // out first, and the header round trip overlaps them.
  U pv[V];
  if (unit_thread) {
    if (vec_ok && hi - lo == V) {
      Vec<U> x;
      x.raw = __ldg(reinterpret_cast<const uint4*>(p + lo));
#pragma unroll
      for (int e = 0; e < V; ++e) pv[e] = x.e[e];
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) pv[e] = lo + e < hi ? p[lo + e] : U(0);
    }
  }
  stage_headers(hdr, k, S, B, W, addr, nwords, handler, active);
  __syncthreads();
  const int4 me = hdr[b];
  if (me.y >= me.z) return;                        // uniform: a dead block
  const bool shared_words = __syncthreads_or(
      mark_neighbours(hdr, nb, B, b, me));

  U* s = seg + (size_t)k * S;
  const int op = me.w;
  const int a = me.x;
  if (shared_words) {
    // One lane per thread: the tile's lanes start at its first unit's.
    int tlo, unused;
    unit_lanes((int)(blockIdx.x * T), h, W, V, tlo, unused);
    const int j = tlo + threadIdx.x;
    int last_lo, last_hi;
    unit_lanes((int)(blockIdx.x * T + T - 1), h, W, V, last_lo, last_hi);
    const long long wl = (long long)a + j;
    if (j >= last_hi || !touches(me, wl)) return;
    const int w = (int)wl;
    int later[FOLD_DEPTH - 1], n;
    bool deep;
    if (!first_toucher(hdr, nb, B, b, w, later, n, deep)) return;
    const U own = p[j];
    if (deep) {
      fold_word<Tr>(s, pay, hdr, nb, k, B, W, b, w, own);
      return;
    }
    U q[FOLD_DEPTH - 1];                          // every load at once
#pragma unroll
    for (int d = 0; d < FOLD_DEPTH - 1; ++d)
      if (d < n)
        q[d] = pay[((size_t)k * B + later[d]) * W + (w - hdr[later[d]].x)];
    U v = op == 1 ? own : Tr::apply(op, s[w], own);
#pragma unroll
    for (int d = 0; d < FOLD_DEPTH - 1; ++d)
      if (d < n) {
        const int opc = hdr[later[d]].w;
        v = opc == 1 ? q[d] : Tr::apply(opc, v, q[d]);
      }
    s[w] = v;
    return;
  }
  // Every word of block b is b's alone.
  if (!unit_thread) return;
  const long long w = (long long)a + lo;
  const bool whole = vec_ok && congruent(k, S, a, row, W, V) && hi - lo == V
                     && w >= me.y && w + V <= me.z;
  unsigned take = 0;
  U sv[V];
  if (whole) {                                     // the segment load
    take = (1u << V) - 1;
    if (op != 1) {
      Vec<U> x;
      x.raw = *reinterpret_cast<const uint4*>(s + w);
#pragma unroll
      for (int e = 0; e < V; ++e) sv[e] = x.e[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (lo + e < hi && w + e >= me.y && w + e < me.z) {
        take |= 1u << e;
        if (op != 1) sv[e] = s[w + e];
      }
  }
  if (!take) return;
  if (op != 1) {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (take >> e & 1u) pv[e] = Tr::apply(op, sv[e], pv[e]);
  }
  if (whole) {                                     // then the store
    Vec<U> x;
#pragma unroll
    for (int e = 0; e < V; ++e) x.e[e] = pv[e];
    *reinterpret_cast<uint4*>(s + w) = x.raw;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (take >> e & 1u) s[w + e] = pv[e];
  }
}

// Past the staged design's B: one CTA per kernel row walks every block
// in order, headers from global memory (csrc/am_pack.cu's design).
template <class Tr>
__global__ void scatter_walk_sm90_kernel(typename Tr::U* __restrict__ seg,
                                         int S,
                                         const typename Tr::U* __restrict__ pay,
                                         const int* __restrict__ addr,
                                         const int* __restrict__ nwords,
                                         const int* __restrict__ handler,
                                         const int* __restrict__ active,
                                         int B, int W) {
  const int k = blockIdx.x;
  typename Tr::U* s = seg + (size_t)k * S;
  for (int b = 0; b < B; ++b) {
    const size_t row = (size_t)k * B + b;
    const int op = min(max(handler[row], 0), 4);
    if (active[row] && op != 0) {
      const long long a = addr[row];
      const int nw = min(nwords[row], W);
      const typename Tr::U* p = pay + row * W;
      for (int j = threadIdx.x; j < nw; j += blockDim.x) {
        const long long idx = a + j;
        if (idx >= 0 && idx < S) s[idx] = Tr::apply(op, s[idx], p[j]);
      }
    }
    __syncthreads();   // block b lands before block b+1 reads
  }
}

__global__ void empty_sm90_kernel() {}

// The staged scatter's shared memory: B headers and the neighbour mask.
size_t scatter_smem(int B) {
  return (size_t)B * sizeof(int4) + (B + 31) / 32 * 4;
}

template <class Tr>
cudaError_t launch_gather(const void* seg, int K, int S, const int* addr,
                          const int* nwords, int B, int W, void* out,
                          int threads, int vt, int tiles, int vec_ok,
                          cudaStream_t st) {
  using U = typename Tr::U;
  const dim3 grid(tiles, B, K);
  if (vt == 1) {
    gather_sm90_kernel<Tr, 1><<<grid, threads, 0, st>>>(
        (const U*)seg, S, addr, nwords, W, vec_ok, (U*)out);
  } else if (vt == 2) {
    gather_sm90_kernel<Tr, 2><<<grid, threads, 0, st>>>(
        (const U*)seg, S, addr, nwords, W, vec_ok, (U*)out);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <class Tr>
cudaError_t launch_scatter(void* seg, int K, int S, const void* pay,
                           const int* addr, const int* nwords,
                           const int* handler, const int* active, int B,
                           int W, int threads, int tiles, int walk,
                           int vec_ok, cudaStream_t st) {
  using U = typename Tr::U;
  if (walk) {
    scatter_walk_sm90_kernel<Tr><<<K, threads, 0, st>>>(
        (U*)seg, S, (const U*)pay, addr, nwords, handler, active, B, W);
  } else {
    if (threads % (VEC_BYTES / sizeof(U))) return cudaErrorInvalidValue;
    scatter_sm90_kernel<Tr><<<dim3(tiles, B, K), threads, scatter_smem(B),
                              st>>>((U*)seg, S, (const U*)pay, addr, nwords,
                                    handler, active, W, vec_ok);
  }
  return cudaGetLastError();
}

// The grid (tiles, B, K) holds B and K up to 65535; the walk's grid is K.
bool plan_ok(int K, int B, int W, int threads, int tiles, bool walk) {
  return K > 0 && B > 0 && W > 0 && tiles > 0 && threads >= 32
         && threads <= 1024 && threads % 32 == 0
         && (walk || (K <= 65535 && B <= 65535));
}

}  // namespace

extern "C" {

// seg (K, S); addr, nwords (K, B) int32; out (K, B, W) of the segment's
// type.  dtype: 0 float32, 1 int32, 2 bfloat16, 3 float16.  The plan
// (threads, vt units per thread, tiles per row) is
// kernels/am_pack/am_pack.py datamover_plan's; vec_ok: seg and out are
// 16-byte aligned.
int datamover_gather_sm90(const void* seg, int K, int S, const int* addr,
                          const int* nwords, int B, int W, void* out,
                          int dtype, int threads, int vt, int tiles,
                          int vec_ok, void* stream) {
  if (!plan_ok(K, B, W, threads, tiles, false))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch_gather<F32>(seg, K, S, addr, nwords, B, W, out,
                                           threads, vt, tiles, vec_ok, st);
    case 1: return (int)launch_gather<I32>(seg, K, S, addr, nwords, B, W, out,
                                           threads, vt, tiles, vec_ok, st);
    case 2: return (int)launch_gather<BF16>(seg, K, S, addr, nwords, B, W,
                                            out, threads, vt, tiles, vec_ok,
                                            st);
    case 3: return (int)launch_gather<F16>(seg, K, S, addr, nwords, B, W, out,
                                           threads, vt, tiles, vec_ok, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// seg (K, S) updated in place; pay (K, B, W) of the segment's type; addr,
// nwords, handler, active (K, B) int32.  dtype as for the gather.  The
// plan: threads per CTA (V per unit of a tile), tiles per packet row;
// walk: the in-order walk of every block (any B) instead of the staged
// design (B headers in shared memory); vec_ok: seg and pay are 16-byte
// aligned.
int datamover_scatter_sm90(void* seg, int K, int S, const void* pay,
                           const int* addr, const int* nwords,
                           const int* handler, const int* active, int B,
                           int W, int dtype, int threads, int tiles,
                           int walk, int vec_ok, void* stream) {
  if (!plan_ok(K, B, W, threads, tiles, walk))
    return (int)cudaErrorInvalidValue;
  if (!walk && scatter_smem(B) > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch_scatter<F32>(
        seg, K, S, pay, addr, nwords, handler, active, B, W, threads,
        tiles, walk, vec_ok, st);
    case 1: return (int)launch_scatter<I32>(
        seg, K, S, pay, addr, nwords, handler, active, B, W, threads,
        tiles, walk, vec_ok, st);
    case 2: return (int)launch_scatter<BF16>(
        seg, K, S, pay, addr, nwords, handler, active, B, W, threads,
        tiles, walk, vec_ok, st);
    case 3: return (int)launch_scatter<F16>(
        seg, K, S, pay, addr, nwords, handler, active, B, W, threads,
        tiles, walk, vec_ok, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One empty CTA: the launch floor a DataMover time is read against.
int datamover_empty_sm90(void* stream) {
  empty_sm90_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* datamover_sm90_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
