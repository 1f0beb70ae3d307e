// The GAScore's DataMover on Hopper: header-driven gather and scatter.
//
// Replaces the Pallas TPU kernels of the JAX package
//   src/repro/kernels/am_pack/am_pack.py  am_pack_pallas    (gather)
//   src/repro/kernels/am_pack/am_pack.py  am_unpack_pallas  (scatter)
// and serves the whole GAScore, not only strided AMs: each kernel row k
// (one Shoal kernel on the leading axis) has B blocks, block b moving
// nwords[k][b] <= W words between a packet row and the segment at
// addr[k][b].  am_pack / am_unpack are the special case
// addr_b = addr + b*stride, nwords_b = blk_words, handler = write.
//
// Gather: v = seg[k][addr+j] for addr+j inside the segment, else 0, and
// out[k][b][j] = v * (j < nwords), as the reference GAScore masks a
// packet (`rows * mask`): a float32 lane past nwords is v * 0, so NaN
// and +-inf give NaN and a negative word gives -0.0; every lane is
// multiplied, so the kernel and the plain version round alike on the
// card.  int32 lanes past nwords are 0.  Fully parallel: one CTA per
// (block, kernel row), threads over lanes, so loads and stores coalesce.
//
// Scatter: for every kernel row, blocks apply IN ORDER (last writer
// wins; a read-modify-write handler sees every earlier block), which is
// what am_unpack_pallas's fori_loop and the GAScore's scanned ingress
// do.  One CTA per kernel row walks the blocks with a __syncthreads()
// between them; lanes of one block never alias, so they run in
// parallel.  Lanes past nwords, of inactive blocks, or outside the
// segment are dropped.  The handler op code is the built-in handler ID:
// 0 nop, 1 write, 2 add, 3 max, 4 min (NaN-propagating, like
// torch.maximum / jnp.maximum).
//
// Bound on an H100: both move a few words per lane and do at most one
// operation per word, so they are bound by bytes (3.35 TB/s), and at the
// GAScore's packet sizes (KiB per row) by launch latency.  The scatter
// runs only K CTAs, one per kernel row: in-order blocks trade occupancy
// for the ordering guarantee.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float lane_mask(float v, bool keep) {
  return __fmul_rn(v, keep ? 1.0f : 0.0f);    // v * mask, never a select
}

__device__ __forceinline__ int lane_mask(int v, bool keep) {
  return keep ? v : 0;
}

template <typename T>
__global__ void gather_kernel(const T* __restrict__ seg, int S,
                              const int* __restrict__ addr,
                              const int* __restrict__ nwords, int B, int W,
                              T* __restrict__ out) {
  const int b = blockIdx.x;
  const int k = blockIdx.y;
  const size_t row = (size_t)k * B + b;
  const long long a = addr[row];
  const int nw = nwords[row];
  const T* s = seg + (size_t)k * S;
  T* o = out + row * W;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const long long idx = a + j;
    const T v = (idx >= 0 && idx < S) ? s[idx] : T(0);
    o[j] = lane_mask(v, j < nw);
  }
}

__device__ __forceinline__ float apply_op(int op, float r, float p) {
  switch (op) {
    case 1: return p;
    case 2: return r + p;
    case 3: return r != r ? r : (p != p ? p : (r > p ? r : p));   // NaN
    case 4: return r != r ? r : (p != p ? p : (r < p ? r : p));   // wins
    default: return r;
  }
}

__device__ __forceinline__ int apply_op(int op, int r, int p) {
  switch (op) {
    case 1: return p;
    case 2: return (int)((unsigned)r + (unsigned)p);   // wraps like int32
    case 3: return r > p ? r : p;
    case 4: return r < p ? r : p;
    default: return r;
  }
}

template <typename T>
__global__ void scatter_kernel(T* __restrict__ seg, int S,
                               const T* __restrict__ pay,
                               const int* __restrict__ addr,
                               const int* __restrict__ nwords,
                               const int* __restrict__ handler,
                               const int* __restrict__ active, int B, int W) {
  const int k = blockIdx.x;
  T* s = seg + (size_t)k * S;
  for (int b = 0; b < B; ++b) {
    const size_t row = (size_t)k * B + b;
    if (active[row]) {
      const long long a = addr[row];
      const int nw = min(nwords[row], W);
      const int op = min(max(handler[row], 0), 4);
      const T* p = pay + row * W;
      for (int j = threadIdx.x; j < nw; j += blockDim.x) {
        const long long idx = a + j;
        if (idx >= 0 && idx < S) s[idx] = apply_op(op, s[idx], p[j]);
      }
    }
    __syncthreads();   // block b lands before block b+1 reads
  }
}

int threads_for(int W) {
  int t = ((W + 31) / 32) * 32;
  if (t < 32) t = 32;
  return t > 1024 ? 1024 : t;
}

}  // namespace

extern "C" {

// seg (K, S); addr, nwords (K, B) int32; out (K, B, W) of the segment's
// type.  dtype: 0 float32, 1 int32.
int datamover_gather(const void* seg, int K, int S, const int* addr,
                     const int* nwords, int B, int W, void* out, int dtype,
                     void* stream) {
  if (K <= 0 || B <= 0 || W <= 0 || K > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(B, K);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    gather_kernel<float><<<grid, threads_for(W), 0, st>>>(
        (const float*)seg, S, addr, nwords, B, W, (float*)out);
  } else if (dtype == 1) {
    gather_kernel<int><<<grid, threads_for(W), 0, st>>>(
        (const int*)seg, S, addr, nwords, B, W, (int*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// seg (K, S) updated in place; pay (K, B, W) of the segment's type;
// addr, nwords, handler, active (K, B) int32.  dtype: 0 float32, 1 int32.
int datamover_scatter(void* seg, int K, int S, const void* pay,
                      const int* addr, const int* nwords, const int* handler,
                      const int* active, int B, int W, int dtype,
                      void* stream) {
  if (K <= 0 || B <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    scatter_kernel<float><<<K, threads_for(W), 0, st>>>(
        (float*)seg, S, (const float*)pay, addr, nwords, handler, active,
        B, W);
  } else if (dtype == 1) {
    scatter_kernel<int><<<K, threads_for(W), 0, st>>>(
        (int*)seg, S, (const int*)pay, addr, nwords, handler, active, B, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* datamover_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
