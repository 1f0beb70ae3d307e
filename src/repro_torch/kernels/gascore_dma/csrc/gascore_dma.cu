// The GAScore's RDMA ring on Hopper: ring all-reduce and the ring
// collectives by one-sided puts, ADD on arrival.
//
// Replaces the Pallas TPU kernel of the JAX package
//   src/repro/kernels/gascore_dma/gascore_dma.py  ring_allreduce_dma_local
//   (_ring_kernel: every device puts its carry into its right
//   neighbour's double-buffered inbox by remote DMA, then adds what
//   arrived from its left, n-1 steps)
// and serves the ring schedules of src/repro/core/collectives.py
// (reduce-scatter, all-gather, all-reduce = the two in sequence).
//
// The n = K Shoal kernels are the leading axis of one tensor.  Word w
// of kernel k only ever meets word w of the other kernels, so a CTA owns
// a tile of words FOR ALL K KERNELS: thread (k, r) plays kernel k on
// V words of the tile.  A put is a store into the right neighbour's
// inbox slot in shared memory, and __syncthreads() is the receive
// semaphore.  The inbox is double-buffered, so one barrier per step is
// enough: the next store into a slot comes two steps later, after a
// barrier that every reader of the slot has passed.  No CTA depends on
// another, so the reverse capacity semaphore that the TPU kernel leaves
// out (gascore_dma.py:15-18) is not needed either.
//
// Schedules (argument `schedule`):
//   0 dma            x (K, C) -> (K, C): o = carry = x; K-1 steps of
//                    carry <- left's carry, o <- o + carry.
//   1 reduce_scatter x (K, n, C) -> (K, C): step t, kernel k sends chunk
//                    (k-t-1) mod n and adds what arrived onto its chunk
//                    (k-t-2) mod n (cur + recv); kernel k keeps chunk k.
//   2 all_gather     x (K, C) -> (K, n, C): step t, kernel k sends row
//                    (k-t) mod n and overwrites row (k-t-1) mod n.
//   3 all_reduce     x (K, n, C) -> (K, n, C): 1 then 2, one launch.
// For 1-3 the chunk index j's word w is the independent unit; a thread
// keeps its kernel's n chunk words in shared memory.  Every schedule
// adds in the reference's order and rounds to the type after each add:
// float32 plain adds, bfloat16 through float32 and back (round to
// nearest even, as PyTorch's and XLA's bfloat16 adds), int32 wrapping.
// Indices take C's truncating % only of non-negative numbers (n is
// added first): the reference's jnp.mod is a floor mod.
//
// Bound on an H100: one add per word per step is nothing beside the
// bytes (x read once, the result written once, 3.35 TB/s), so every
// schedule is bound by bytes.  Loads and stores are 16-byte vectors
// (V words) when the chunk allows, and the steps run in shared memory.
// Shared memory limits K: the collective schedules keep K * n * R
// vectors per CTA, the wrapper picks the threads per kernel R from K
// and refuses a K that does not fit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;      // 227 KB of dynamic shared memory
constexpr int kDefaultSmem = 49152;   // above this, opt in per kernel

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ int add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);   // wraps like int32
}

__device__ __forceinline__ uint16_t add(uint16_t a, uint16_t b) {
  const float s = __fadd_rn(__bfloat162float(__ushort_as_bfloat16(a)),
                            __bfloat162float(__ushort_as_bfloat16(b)));
  return __bfloat16_as_ushort(__float2bfloat16_rn(s));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> add(const Pack<T, V>& a,
                                          const Pack<T, V>& b) {
  Pack<T, V> s;
#pragma unroll
  for (int i = 0; i < V; ++i) s.v[i] = add(a.v[i], b.v[i]);
  return s;
}

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> zero_pack() {
  Pack<T, V> p;
#pragma unroll
  for (int i = 0; i < V; ++i) p.v[i] = T(0);
  return p;
}

__device__ __forceinline__ int mod(int a, int n) { return (a + 2 * n) % n; }

// x and out hold Pack<T, V> vectors; C counts vectors per chunk row.
template <typename T, int V, int SCHED>
__global__ void ring_kernel(const Pack<T, V>* __restrict__ x,
                            Pack<T, V>* __restrict__ out, int K,
                            long long C, int R) {
  using P = Pack<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  P* inbox = reinterpret_cast<P*>(smem);            // [2][K][R]
  P* buf = inbox + 2 * K * R;                       // [n][K][R]
  const int n = K;
  const int k = threadIdx.x / R;
  const int r = threadIdx.x % R;
  const long long w = (long long)blockIdx.x * R + r;
  const bool live = w < C;
  const int right = (k + 1) % n;
  int g = 0;   // global step: slot parity runs on across phases

  if (SCHED == 0) {
    P o = live ? x[(size_t)k * C + w] : zero_pack<T, V>();
    P carry = o;
    for (int t = 0; t < n - 1; ++t, ++g) {
      P* slot = inbox + (g & 1) * K * R;
      slot[right * R + r] = carry;          // one-sided put to the right
      __syncthreads();                      // the receive semaphore
      carry = slot[k * R + r];              // what my left sent
      o = add(o, carry);                    // the ADD handler
    }
    if (live) out[(size_t)k * C + w] = o;
    return;
  }

  P* mine = buf + k * R + r;                // my chunk j at mine[j*K*R]
  const int stride = K * R;
  if (SCHED == 2) {
    mine[k * stride] = live ? x[(size_t)k * C + w] : zero_pack<T, V>();
  } else {
    for (int j = 0; j < n; ++j)
      mine[j * stride] = live ? x[((size_t)k * n + j) * C + w]
                              : zero_pack<T, V>();
  }
  if (SCHED == 1 || SCHED == 3) {           // reduce-scatter
    for (int t = 0; t < n - 1; ++t, ++g) {
      P* slot = inbox + (g & 1) * K * R;
      slot[right * R + r] = mine[mod(k - t - 1, n) * stride];
      __syncthreads();
      P* cur = mine + mod(k - t - 2, n) * stride;
      *cur = add(*cur, slot[k * R + r]);    // cur + recv
    }
  }
  if (SCHED == 1) {
    if (live) out[(size_t)k * C + w] = mine[k * stride];
    return;
  }
  for (int t = 0; t < n - 1; ++t, ++g) {    // all-gather
    P* slot = inbox + (g & 1) * K * R;
    slot[right * R + r] = mine[mod(k - t, n) * stride];
    __syncthreads();
    mine[mod(k - t - 1, n) * stride] = slot[k * R + r];
  }
  if (live)
    for (int j = 0; j < n; ++j)
      out[((size_t)k * n + j) * C + w] = mine[j * stride];
}

template <typename T, int V, int SCHED>
int launch(const void* x, void* out, int K, long long words, int R,
           size_t smem, cudaStream_t st) {
  auto kern = ring_kernel<T, V, SCHED>;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long C = words / V;
  const long long tiles = (C + R - 1) / R;
  kern<<<(unsigned)tiles, K * R, smem, st>>>(
      (const Pack<T, V>*)x, (Pack<T, V>*)out, K, C, R);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int dispatch(int schedule, const void* x, void* out, int K, long long words,
             int R, size_t smem, cudaStream_t st) {
  switch (schedule) {
    case 0: return launch<T, V, 0>(x, out, K, words, R, smem, st);
    case 1: return launch<T, V, 1>(x, out, K, words, R, smem, st);
    case 2: return launch<T, V, 2>(x, out, K, words, R, smem, st);
    case 3: return launch<T, V, 3>(x, out, K, words, R, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_vec(int vec, int schedule, const void* x, void* out, int K,
                 long long words, int R, size_t smem, cudaStream_t st) {
  constexpr int VMAX = 16 / sizeof(T);
  if (vec == 1) return dispatch<T, 1>(schedule, x, out, K, words, R, smem, st);
  if (vec == VMAX)
    return dispatch<T, VMAX>(schedule, x, out, K, words, R, smem, st);
  return (int)cudaErrorInvalidValue;
}

// Shared memory bytes of one CTA: the inbox [2][K][R] vectors, plus the
// kernel's chunks [n][K][R] for the collective schedules (1-3).  The
// wrapper's smem_bytes() plans with the same formula.
long long smem_bytes(int K, int R, int vec_bytes, int schedule) {
  const long long per = (long long)K * R * vec_bytes;
  return schedule == 0 ? 2 * per : (2 + (long long)K) * per;
}

}  // namespace

extern "C" {

// x, out: see the schedules above; `words` is the chunk length C in
// elements, a multiple of `vec`.  dtype: 0 float32, 1 bfloat16, 2 int32.
// R threads per kernel row, K * R threads per CTA.
int ring_collective(const void* x, void* out, int K, long long words,
                    int dtype, int schedule, int R, int vec, void* stream) {
  static const int elt[] = {4, 2, 4};
  if (K < 1 || R < 1 || vec < 1 || words < 1 || dtype < 0 || dtype > 2 ||
      schedule < 0 || schedule > 3 || words % vec != 0 ||
      (long long)K * R > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(K, R, vec * elt[dtype], schedule);
  if (smem > kMaxSmem || (words / vec + R - 1) / R > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return dispatch_vec<float>(vec, schedule, x, out, K, words, R,
                                       (size_t)smem, st);
    case 1: return dispatch_vec<uint16_t>(vec, schedule, x, out, K, words,
                                          R, (size_t)smem, st);
    default: return dispatch_vec<int>(vec, schedule, x, out, K, words, R,
                                      (size_t)smem, st);
  }
}

const char* ring_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
