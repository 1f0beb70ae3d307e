// The GAScore's RDMA ring on Hopper as a thread-block cluster: one CTA per
// Shoal kernel, puts into the other CTAs' shared memory (distributed shared
// memory, DSMEM), an mbarrier as the receive semaphore and a credit mbarrier
// as the capacity semaphore.
//
// Replaces the Pallas TPU kernel of the JAX package
//   src/repro/kernels/gascore_dma/gascore_dma.py:62  ring_allreduce_dma_local
//   (_ring_kernel: every device puts its carry into its right
//   neighbour's double-buffered inbox by remote DMA, guarded by a receive
//   semaphore, then adds what arrived from its left, n-1 steps)
// and serves the ring schedules of src/repro/core/collectives.py:43-101
// (reduce-scatter, all-gather, all-reduce = the two in sequence), as
// csrc/gascore_dma.cu does.  It gives that kernel's results bit for bit:
// the reference's add order, and a rounding to the type after each add.
//
// Design.  The grid is K x tiles CTAs in clusters of K (2 <= K <= 8, the
// portable cluster size).  Cluster rank k plays Shoal kernel k on one
// tile of words: T threads (32..256) of VT vectors of V words each.  The
// words of a tile only meet the same words of the other kernels, so the
// clusters never wait on each other.
// * Every load of a CTA (for the reduce-scatter all n of kernel k's
//   chunks of the tile) is issued before the cluster's first barrier,
//   into registers.
// * A put is a one-sided copy into another CTA's inbox, warp w to warp w:
//   16-byte `st.async` DSMEM stores that complete the receiver's
//   `full[w]` mbarrier with the bytes they carry -- the twin of the TPU
//   kernel's make_async_remote_copy + recv_sem.  The inbox has one slot
//   per other rank.
// * A put goes straight to the rank that adds it, not around the ring:
//   each word crosses the cluster once per phase, so a schedule is one
//   hop (two for the all-reduce) where the ring takes n - 1 (2 (n - 1))
//   in a row.  The receiver then folds its slots in the ring's order, so
//   every sum is the reference's, add for add: the ring's order is a
//   property of the sums, its n - 1 hops one way of moving the words.
//   (The first design of this kernel put only to the right neighbour, as
//   the TPU does; its hops in a row, each a put across SMs and a wake-up,
//   lost to csrc/gascore_dma.cu at every size measured, PERF.md.)
// * The receiver waits on its own full[w] (acquire, cluster scope).  The
//   all-reduce puts its reduced chunk into the slots its reduce-scatter
//   used: after reading them, each warp re-arms full[w] and gives the
//   slots back (a release arrive, cluster scope, on every sender's
//   empty[w]); a sender waits on its own empty[w] before it writes into
//   any of them again.  That credit is the capacity semaphore the TPU
//   kernel leaves out (gascore_dma.py:15-18).  Each warp waits only on
//   the same warp of the other ranks, never on a whole CTA.
// * A cluster barrier at the start (after the mbarriers are initialised,
//   before any remote access) and one at the end (arrive after the last
//   remote access, wait before exit) keep every CTA's shared memory alive
//   while another rank can still reach it.
// Schedules (argument `schedule`); slot i of rank k holds what rank
// k + 1 + i put (mod n):
//   0 dma            x (K, C) -> (K, C): rank k puts x[k] to all; its
//                    o = x[k] + x[k-1] + ... + x[k-n+1], left to right
//                    (slots n-2 .. 0).
//   1 reduce_scatter x (K, n, C) -> (K, C): rank k puts x[k, c] to rank
//                    c; rank c folds s = x[c+1, c], s = x[c+i, c] + s for
//                    i = 2 .. n (cur + recv, slots 0 .. n-2, then its own).
//   2 all_gather     x (K, C) -> (K, n, C): rank k puts x[k] to all and
//                    writes out[k, j] from slot j - k - 1, out[k, k] = x[k].
//   3 all_reduce     1 then 2 in one launch, the slots reused.
// Indices are mod n, with n = K.  bfloat16 adds are packed
// (add.rn.bf16x2): one rounding of the exact sum, which equals the float32
// add rounded to bfloat16 on finite inputs (24 >= 2 * 8 + 2 bits).  float32
// adds are __fadd_rn, int32 adds wrap.
//
// Bound on an H100: one add per word per step is nothing beside the bytes
// (x read once, the result written once, at 3.35 TB/s), so every schedule
// is bound by bytes -- device memory's, and the cluster's own: the dma
// schedule moves every word through distributed shared memory n - 1
// times, the all-reduce 2 (n - 1) / n times.  The plan
// (cluster_tile_plan in gascore_dma.py) fills the card: at least 132
// CTAs wherever the words allow (small tiles for small leaves, where the
// simple kernel ran a few CTAs).  Measured (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md, scripts/ring_sweep.py): chunks of 1-16 KiB are bound by the
// launch, the cluster barrier and one hop, and there the cluster kernel
// beats csrc/gascore_dma.cu for the collective schedules on 8 kernels
// (the reduce-scatter from 2); ring_kernel_for sends it only those.
// Larger chunks are bound by distributed shared memory's bandwidth,
// where the simple kernel's ring stays inside one SM.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>
#include <type_traits>

namespace {

constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr int kMaxThreads = 256;      // threads of one CTA
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kBarBytes = 2 * kMaxWarps * 8;   // full[w], empty[w]
constexpr int kMaxSmem = 232448;      // 227 KB of dynamic shared memory
constexpr int kDefaultSmem = 49152;   // above this, opt in per kernel

// -- the adds: the reference's, rounded to the type after each ----------

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ int add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);   // wraps like int32
}

__device__ __forceinline__ uint16_t add(uint16_t a, uint16_t b) {
  uint16_t s;
  asm("add.rn.bf16 %0, %1, %2;" : "=h"(s) : "h"(a), "h"(b));
  return s;
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t s;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(s) : "r"(a), "r"(b));
  return s;
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> add(const Pack<T, V>& a,
                                          const Pack<T, V>& b) {
  Pack<T, V> s;
  if constexpr (std::is_same<T, uint16_t>::value && V % 2 == 0) {
    const uint32_t* pa = reinterpret_cast<const uint32_t*>(a.v);
    const uint32_t* pb = reinterpret_cast<const uint32_t*>(b.v);
    uint32_t* ps = reinterpret_cast<uint32_t*>(s.v);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) ps[i] = add_bf16x2(pa[i], pb[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) s.v[i] = add(a.v[i], b.v[i]);
  }
  return s;
}

template <typename P>
__device__ __forceinline__ P zero_pack() {
  P p;
  memset(&p, 0, sizeof(P));
  return p;
}

// A pack on the wire: itself, or a 32-bit word for a 2-byte pack (the
// DSMEM stores move 4 or 16 bytes).
template <typename P>
using Wire = typename std::conditional<(sizeof(P) < 4), uint32_t, P>::type;

template <typename P>
__device__ __forceinline__ Wire<P> to_wire(const P& p) {
  Wire<P> w;
  if constexpr (sizeof(P) < 4) {
    w = 0;
    memcpy(&w, &p, sizeof(P));
  } else {
    w = p;
  }
  return w;
}

template <typename P>
__device__ __forceinline__ P from_wire(const Wire<P>& w) {
  P p;
  memcpy(&p, &w, sizeof(P));
  return p;
}

// -- PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// the shared::cluster address of `addr` (own shared memory) in CTA `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
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

// arrive on a barrier of another CTA of the cluster, releasing at cluster
// scope what this thread (and, through __syncwarp, its warp) read before
__device__ __forceinline__ void mbar_arrive_remote(uint32_t cluster_bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          cluster_bar)
      : "memory");
}

// returns once the phase of parity `parity` has completed; acquires at
// cluster scope what the other ranks released into it
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// relaxed: the mbarriers' initialisation is released by
// fence.mbarrier_init, and every remote access is ordered by them, so
// the arrive need not wait for this thread's loads and stores
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// DSMEM store into another CTA's shared memory that completes `bar` (a
// barrier of that CTA) with its bytes
__device__ __forceinline__ void st_async(uint32_t addr, const uint4& v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, uint32_t v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "r"(v), "r"(bar)
      : "memory");
}

template <typename W>
__device__ __forceinline__ void put_word(uint32_t addr, const W& w,
                                         uint32_t bar) {
  if constexpr (sizeof(W) == 16) {
    st_async(addr, reinterpret_cast<const uint4&>(w), bar);
  } else {
    st_async(addr, reinterpret_cast<const uint32_t&>(w), bar);
  }
}

// -- the cluster: one warp's puts, receives and credits ---------------------

// Shared memory of a CTA: kBarBytes of mbarriers (full[w], then empty[w])
// and the inbox [n - 1 slots][nw][VT][32] wire words.  Warp w of rank k
// puts into warp w's part of slot (k - dst - 1) mod n of rank dst.
template <typename P, int VT>
struct Cluster {
  using W = Wire<P>;
  static constexpr uint32_t kWarpBytes = VT * 32 * sizeof(W);  // a slot's
  W* inbox;
  uint32_t bars;
  int n, k, nw, warp, lane;

  __device__ __forceinline__ uint32_t full() const { return bars + warp * 8; }
  __device__ __forceinline__ uint32_t empty() const {
    return bars + (kMaxWarps + warp) * 8;
  }
  __device__ __forceinline__ int word(int slot, int j) const {
    return ((slot * nw + warp) * VT + j) * 32 + lane;
  }
  // bytes that every phase puts into one warp's slots
  __device__ __forceinline__ uint32_t phase_bytes() const {
    return (uint32_t)(n - 1) * kWarpBytes;
  }

  // lane 0 of each warp: its barriers, the first phase armed
  __device__ __forceinline__ void init() const {
    if (lane != 0) return;
    mbar_init(full(), 1);
    mbar_init(empty(), n - 1);
    mbar_expect_tx(full(), phase_bytes());
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // put v into rank dst's slot for this rank
  __device__ __forceinline__ void put(int dst, const P (&v)[VT]) const {
    const int slot = (k - dst - 1 + n) % n;
    const uint32_t base = map_rank(bars, dst);
    const uint32_t bar = base + (full() - bars);
    const uint32_t addr = base + kBarBytes + word(slot, 0) * sizeof(W);
#pragma unroll
    for (int j = 0; j < VT; ++j)
      put_word(addr + j * 32 * sizeof(W), to_wire(v[j]), bar);
  }

  // returns once the other ranks' puts of phase `phase` have landed
  __device__ __forceinline__ void receive(int phase) const {
    mbar_wait(full(), phase & 1);
  }

  __device__ __forceinline__ P slot(int s, int j) const {
    return from_wire<P>(inbox[word(s, j)]);
  }

  // after every lane has read the slots: arm the next phase and give the
  // slots back to every sender, lane d to rank k + d (a release at
  // cluster scope waits for the thread's stores in flight: n - 1 lanes
  // wait side by side, not in a row), then wait until every receiver has
  // given this warp's slots back (the capacity semaphore)
  __device__ __forceinline__ void credit() const {
    if (lane == 0) mbar_expect_tx(full(), phase_bytes());
    __syncwarp();
    if (lane >= 1 && lane < n)
      mbar_arrive_remote(map_rank(empty(), (k + lane) % n));
    mbar_wait(empty(), 0);
  }
};

// x and out hold Pack<T, V> vectors; C counts vectors per chunk row.
template <typename T, int V, int VT, int SCHED>
__global__ void __launch_bounds__(kMaxThreads)
    ring_cluster_kernel_sm90(const void* __restrict__ xv,
                             void* __restrict__ outv, int n, long long C) {
  using P = Pack<T, V>;
  using W = Wire<P>;
  constexpr bool kReduce = SCHED == 1 || SCHED == 3;
  constexpr int kRows = kReduce ? kMaxCluster : 1;
  const P* x = static_cast<const P*>(xv);
  P* out = static_cast<P*>(outv);
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = (int)cluster_rank();
  const int T_ = blockDim.x;
  const long long base =
      (long long)(blockIdx.x / n) * VT * T_ + threadIdx.x;   // vector j: + j*T_
  bool live[VT];
#pragma unroll
  for (int j = 0; j < VT; ++j) live[j] = base + (long long)j * T_ < C;
  auto at = [&](long long row, int j) {
    return (size_t)row * C + base + (long long)j * T_;
  };

  Cluster<P, VT> cl;
  cl.n = n;
  cl.k = k;
  cl.nw = T_ / 32;
  cl.warp = threadIdx.x / 32;
  cl.lane = threadIdx.x % 32;
  cl.bars = smem_u32(smem);
  cl.inbox = reinterpret_cast<W*>(smem + kBarBytes);

  // every load of the CTA: kernel k's row, or for the reduce-scatter its
  // n chunks, chunk c at c
  P pre[kRows][VT];
#pragma unroll
  for (int c = 0; c < kRows; ++c) {
    if (c < (kReduce ? n : 1)) {
      const long long row = kReduce ? (long long)k * n + c : k;
#pragma unroll
      for (int j = 0; j < VT; ++j)
        pre[c][j] = live[j] ? x[at(row, j)] : zero_pack<P>();
    }
  }

  // the semaphores: one receive and one capacity barrier per warp
  cl.init();
  cluster_arrive();   // no remote access before every CTA of the
  cluster_wait();     // cluster runs and has its barriers

  P own[VT];          // what this rank holds: its row, or its reduced chunk
  if constexpr (kReduce) {                   // reduce-scatter
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < n && c != k) cl.put(c, pre[c]);
    cl.receive(0);
#pragma unroll
    for (int j = 0; j < VT; ++j) {
      P s = cl.slot(0, j);                   // x[k+1, k]
      for (int i = 1; i < n - 1; ++i) s = add(cl.slot(i, j), s);
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c)  // cur + recv, cur = x[k, k]
        if (c == k) s = add(pre[c][j], s);
      own[j] = s;
    }
    if constexpr (SCHED == 1) {
      cluster_arrive();
#pragma unroll
      for (int j = 0; j < VT; ++j)
        if (live[j]) out[at(k, j)] = own[j];
      cluster_wait();
      return;
    }
    cl.credit();      // the all-gather below reuses the slots
  } else {
#pragma unroll
    for (int j = 0; j < VT; ++j) own[j] = pre[0][j];
  }
  const int phase = kReduce ? 1 : 0;
  for (int d = 1; d < n; ++d) cl.put((k + d) % n, own);
  cl.receive(phase);
  if constexpr (SCHED == 0) {                // dma: o + x[k-1] + x[k-2] ...
#pragma unroll
    for (int j = 0; j < VT; ++j) {
      P o = own[j];
      for (int i = n - 2; i >= 0; --i) o = add(o, cl.slot(i, j));
      own[j] = o;
    }
    cluster_arrive();
#pragma unroll
    for (int j = 0; j < VT; ++j)
      if (live[j]) out[at(k, j)] = own[j];
    cluster_wait();
    return;
  }
  // all-gather: row j of kernel k's output is rank j's chunk
  cluster_arrive();
#pragma unroll
  for (int j = 0; j < VT; ++j) {
    if (!live[j]) continue;
    out[at((long long)k * n + k, j)] = own[j];
    for (int i = 0; i < n - 1; ++i)
      out[at((long long)k * n + (k + 1 + i) % n, j)] = cl.slot(i, j);
  }
  cluster_wait();
}

// -- host side ---------------------------------------------------------------

using Kern = void (*)(const void*, void*, int, long long);

template <typename T, int V, int VT>
Kern pick_schedule(int schedule) {
  if constexpr (VT == 1) {   // the reduce-scatter keeps n chunks in flight
    if (schedule == 1) return ring_cluster_kernel_sm90<T, V, 1, 1>;
    if (schedule == 3) return ring_cluster_kernel_sm90<T, V, 1, 3>;
  }
  if (schedule == 0) return ring_cluster_kernel_sm90<T, V, VT, 0>;
  if (schedule == 2) return ring_cluster_kernel_sm90<T, V, VT, 2>;
  return nullptr;
}

template <typename T, int V>
Kern pick_vt(int vt, int schedule) {
  switch (vt) {
    case 1: return pick_schedule<T, V, 1>(schedule);
    case 2: return pick_schedule<T, V, 2>(schedule);
    case 4: return pick_schedule<T, V, 4>(schedule);
    default: return nullptr;
  }
}

template <typename T>
Kern pick_vec(int vec, int vt, int schedule) {
  constexpr int VMAX = 16 / sizeof(T);
  if (vec == 1) return pick_vt<T, 1>(vt, schedule);
  if (vec == VMAX) return pick_vt<T, VMAX>(vt, schedule);
  return nullptr;
}

Kern pick_dtype(int dtype, int vec, int vt, int schedule) {
  switch (dtype) {
    case 0: return pick_vec<float>(vec, vt, schedule);
    case 1: return pick_vec<uint16_t>(vec, vt, schedule);
    case 2: return pick_vec<int>(vec, vt, schedule);
    default: return nullptr;
  }
}

// Shared memory bytes of one CTA: the barriers and the inbox
// [K - 1][threads][vt] wire words.  The wrapper's cluster_smem_bytes()
// plans with the same formula.
long long smem_bytes(int K, int threads, int vt, int wire_bytes) {
  return kBarBytes + (long long)(K - 1) * threads * vt * wire_bytes;
}

// Checks the plan and fills the launch configuration; returns 0 or a
// cudaError_t.
int configure(int K, long long words, int dtype, int schedule, int threads,
              int vt, int vec, void* stream, Kern* kern,
              cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
              long long* C) {
  static const int elt[] = {4, 2, 4};
  if (K < 2 || K > kMaxCluster || dtype < 0 || dtype > 2 || schedule < 0 ||
      schedule > 3 || words < 1 || vec < 1 || words % vec != 0 ||
      (threads != 32 && threads != 64 && threads != 128 && threads != 256))
    return (int)cudaErrorInvalidValue;
  *kern = pick_dtype(dtype, vec, vt, schedule);
  if (*kern == nullptr) return (int)cudaErrorInvalidValue;
  *C = words / vec;
  const long long tiles = (*C + (long long)threads * vt - 1) / (threads * vt);
  const int wire = vec * elt[dtype] < 4 ? 4 : vec * elt[dtype];
  const long long smem = smem_bytes(K, threads, vt, wire);
  if (smem > kMaxSmem || tiles * K > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        *kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  memset(cfg, 0, sizeof(*cfg));
  cfg->gridDim = dim3((unsigned)(tiles * K), 1, 1);
  cfg->blockDim = dim3((unsigned)threads, 1, 1);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)K;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

}  // namespace

extern "C" {

// x, out: see the schedules above; `words` is the chunk length C in
// elements, a multiple of `vec` (1, or 16 bytes of elements with 16-byte
// aligned pointers).  dtype: 0 float32, 1 bfloat16, 2 int32.  K = n
// kernels, 2..8, one CTA each in a cluster of K; `threads` per CTA (32,
// 64, 128 or 256), `vt` vectors per thread (1, 2 or 4; 1 for schedules 1
// and 3).  One cluster per tile.
// Returns 0 when the launch was accepted, else a cudaError_t (a refused
// cluster launch included).
int ring_cluster_sm90(const void* x, void* out, int K, long long words,
                      int dtype, int schedule, int threads, int vt, int vec,
                      void* stream) {
  Kern kern;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  long long C;
  int r = configure(K, words, dtype, schedule, threads, vt, vec, stream,
                    &kern, &cfg, &attr, &C);
  if (r != 0) return r;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, x, out, K, C);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of this plan the card holds at once
// (cudaOccupancyMaxActiveClusters), into *clusters.
int ring_cluster_sm90_max_active(int K, long long words, int dtype,
                                 int schedule, int threads, int vt, int vec,
                                 int* clusters) {
  Kern kern;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  long long C;
  int r = configure(K, words, dtype, schedule, threads, vt, vec, nullptr,
                    &kern, &cfg, &attr, &C);
  if (r != 0) return r;
  return (int)cudaOccupancyMaxActiveClusters(clusters, (const void*)kern,
                                             &cfg);
}

const char* ring_cluster_sm90_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
