// Flash attention (forward) on Hopper, GQA layout, float32 and bfloat16,
// causal or over every key.
//
// Replaces the Pallas TPU kernel of the JAX package
//   src/repro/kernels/attention/flash.py  flash_attention_pallas
// (blocked attention with an online softmax: running max m, normaliser
// l, float32 accumulator; p rounded to v's type before P.V; output
// acc / max(l, 1e-30); the `causal` flag masks the diagonal block).  It
// computes the same function by index with scale 1/sqrt(dh), on the
// port's layout: q (B, S, H, dh), k (B, T, K, dh), v (B, T, K, dv), any
// element strides; dv is dh (up to 256), or 128 at dh 192 (MLA's prompt
// pass: nope 128 + rope 64 for q.k, 128 for v).  Causal: T == S and
// query s reads keys t <= s.  Not causal: any T >= 1, every key valid
// (cross-attention over image tokens, T apart from the S text tokens).
// Query head h reads kv head h / (H / K), so kv heads are shared without
// a copy.  Neither S nor T need be a multiple of a block: the last blocks
// are bound-checked, not padded.  Causal key tiles wholly in the future of a
// warp's rows are skipped, where the TPU kernel only masks them; the
// function is the same.
//
// Design (a first, simple kernel): one CTA per (query block of BQ = 64
// rows, head, sequence), query blocks issued longest first.  TPR threads
// per query row, each holding 1 / TPR of the head dim of q and of the
// float32 accumulator in registers; the TPR threads of a row add their
// partial dot products with log2(TPR) xor shuffles (commutative adds, so
// every thread of the row holds the same score, bit for bit) and run the
// same online softmax.  K and V tiles of BK keys are staged in shared
// memory as float32, each part-row padded by 4 words so the TPR parts a
// warp reads fall in different banks.  Up to dh 128, and at MLA's 192 /
// 128, TPR = 2 and BK = 32: at 192 / 128 the tiles take 25,600 + 17,408
// bytes (under the 48 KB static limit) and a thread holds 96 + 64 + 32
// floats of q, the accumulator and the scores.  Above dh 128 (dh 256:
// recurrentgemma's local attention) two threads a row would hold 128 +
// 128 + 32 floats, past the 255-register cap, and BK = 32 tiles would
// take 67,584 bytes: so TPR = 4 (256 threads a CTA, 64 + 64 + 16 floats a
// thread, as at dh 128) and BK = 16 keys (17,408 + 17,408 bytes).  Every
// product is a float32 FMA on the CUDA cores; wgmma, TMA and warp
// specialisation are later work.
//
// Bound on an H100: 2 * S^2 * dh operations per head (causal QK^T and
// PV) against (3 + 1) * S * dh elements moved, so at S = 1024, dh = 64
// it is bound by operations: tinyllama-1.1b's prefill (B 1, S 1024,
// H 32, dh 64) needs 4.3 GFLOP, 4.3 us at the bf16 tensor-core rate and
// 64 us at the float32 rate this kernel uses.  deepseek-v2's (H 128,
// 192 / 128) needs S^2 (dh + dv) per head, 42.9 GFLOP: 43 us at the bf16
// rate, 641 us at the float32 rate, against 50 us to move its 168 MB.
// Without causality a head needs 2 S T (dh + dv) operations:
// llama-3.2-vision's cross-attention prompt pass (B 4, S 1024, T 1600,
// H 64, dh 128) 214.7 GFLOP, 217 us at the bf16 rate and 3.2 ms at the
// float32 rate.  recurrentgemma-2b's local-attention prefill (B 1, S 1024,
// H 10, K 1, dh 256) needs 5.37 GFLOP: 5.4 us at the bf16 rate, 80 us at
// the float32 rate, against 3.4 us to move its 11.5 MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;              // query rows of one CTA
constexpr float NEG = -1e30f;       // the masked score of the TPU kernel

struct Strides {
  long long b, s, h, d;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p rounded to the value type before the product with v
template <typename T>
__device__ __forceinline__ float round_p(float p) {
  return to_f32(from_f32<T>(p));
}

// TPR threads per query row; DQP: the part of the padded q.k head dim
// one thread holds (8, 16, 32, 64 or 96), DVP of the v head dim (DQP,
// or 64 at DQP 96); d >= dh (dv) reads 0.  BK keys a tile.
template <typename T, int TPR, int DQP, int DVP, int BK>
__global__ void __launch_bounds__(TPR * BQ)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int S,
                           int Tk, int H, int G, int dh, int dv, Strides qs,
                           Strides ks, Strides vs, float scale_log2,
                           bool causal) {
  constexpr int THREADS = TPR * BQ;
  constexpr int ROWS_PER_WARP = 32 / TPR;
  constexpr int DQ = TPR * DQP, DV = TPR * DVP;   // padded head dims
  constexpr int QROW = DQP + 4;     // padded part-rows in shared memory
  constexpr int VROW = DVP + 4;
  __shared__ __align__(16) float ksm[BK][TPR][QROW];
  __shared__ __align__(16) float vsm[BK][TPR][VROW];

  const int qb = gridDim.x - 1 - blockIdx.x;   // longest blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int q0 = qb * BQ;
  const int row = q0 + tid / TPR;
  const int warp_last = q0 + (tid >> 5) * ROWS_PER_WARP + ROWS_PER_WARP - 1;

  float qr[DQP], acc[DVP];
  const bool row_in = row < S;
  const T* qp = q + b * qs.b + h * qs.h;
#pragma unroll
  for (int i = 0; i < DQP; ++i) {
    const int d = part * DQP + i;
    qr[i] = (row_in && d < dh) ? to_f32(qp[row * qs.s + d * qs.d]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < DVP; ++i) acc[i] = 0.f;
  float m = NEG, l = 0.f;

  const T* kp = k + b * ks.b + kvh * ks.h;
  const T* vp = v + b * vs.b + kvh * vs.h;
  // keys [0, k_end) matter; this row reads keys [0, last_key]: one
  // compare a score, causal or not
  const int k_end = causal ? min(q0 + BQ, S) : Tk;
  const int last_key = causal ? row : Tk - 1;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                           // the last tile is used up
    // Equal head dims stage k and v in one pass, unequal ones in a pass
    // each.  Measured on an H100 (scripts/flash_simple_ab.py): two passes
    // at equal dims were slower at the GQA shapes, and one pass at (96, 64)
    // with the v store guarded by d < DVP took 1.37x the time of two.
    if constexpr (DQP == DVP) {
      for (int e = tid; e < BK * DQ; e += THREADS) {
        const int j = e / DQ, d = e % DQ;
        const int key = k0 + j;
        const bool in = key < Tk && d < dh;
        ksm[j][d / DQP][d % DQP] =
            in ? to_f32(kp[key * ks.s + d * ks.d]) : 0.f;
        vsm[j][d / DVP][d % DVP] =
            in ? to_f32(vp[key * vs.s + d * vs.d]) : 0.f;
      }
    } else {
      for (int e = tid; e < BK * DQ; e += THREADS) {
        const int j = e / DQ, d = e % DQ;
        const int key = k0 + j;
        const bool in = key < Tk && d < dh;
        ksm[j][d / DQP][d % DQP] =
            in ? to_f32(kp[key * ks.s + d * ks.d]) : 0.f;
      }
      for (int e = tid; e < BK * DV; e += THREADS) {
        const int j = e / DV, d = e % DV;
        const int key = k0 + j;
        const bool in = key < Tk && d < dv;
        vsm[j][d / DVP][d % DVP] =
            in ? to_f32(vp[key * vs.s + d * vs.d]) : 0.f;
      }
    }
    __syncthreads();
    // warp-uniform: every key is future
    if (causal && k0 > warp_last) continue;

    float s[BK];
    float tile_max = NEG;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float* kr = ksm[j][part];
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DQP; ++i) dot = fmaf(qr[i], kr[i], dot);
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[j] = (k0 + j <= last_key) ? dot * scale_log2 : NEG;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // key 0 is in every row's first tile (T >= 1), so m is a real score
    // from the first tile on and alpha = 2^(NEG - m) = 0 there, never NaN
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2f(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = (k0 + j <= last_key) ? exp2f(s[j] - m_new) : 0.f;
      psum += p;
      s[j] = round_p<T>(p);
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < DVP; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float* vr = vsm[j][part];
#pragma unroll
      for (int i = 0; i < DVP; ++i) acc[i] = fmaf(s[j], vr[i], acc[i]);
    }
    m = m_new;
  }

  if (!row_in) return;
  const float denom = fmaxf(l, 1e-30f);
  T* op = o + (((long long)b * S + row) * H + h) * dv;
#pragma unroll
  for (int i = 0; i < DVP; ++i) {
    const int d = part * DVP + i;
    if (d < dv) op[d] = from_f32<T>(acc[i] / denom);
  }
}

template <typename T, int TPR, int DQP, int DVP, int BK>
void launch_one(dim3 grid, cudaStream_t st, const void* q, const void* k,
                const void* v, void* o, int S, int Tk, int H, int G, int dh,
                int dv, Strides qs, Strides ks, Strides vs, float scale_log2,
                bool causal) {
  flash_attention_kernel<T, TPR, DQP, DVP, BK><<<grid, TPR * BQ, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, Tk, H, G, dh, dv, qs,
      ks, vs, scale_log2, causal);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Tk, int H, int K, int dh, int dv, Strides qs,
           Strides ks, Strides vs, bool causal, cudaStream_t st) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  const float scale_log2 =
      (float)(1.0 / sqrt((double)dh) * 1.4426950408889634);
  const int G = H / K;
  if (dv != dh) {   // MLA: checked to be (192, 128) by the caller
    launch_one<T, 2, 96, 64, 32>(grid, st, q, k, v, o, S, Tk, H, G, dh, dv,
                                 qs, ks, vs, scale_log2, causal);
  } else if (dh <= 16) {
    launch_one<T, 2, 8, 8, 32>(grid, st, q, k, v, o, S, Tk, H, G, dh, dv, qs,
                               ks, vs, scale_log2, causal);
  } else if (dh <= 32) {
    launch_one<T, 2, 16, 16, 32>(grid, st, q, k, v, o, S, Tk, H, G, dh, dv,
                                 qs, ks, vs, scale_log2, causal);
  } else if (dh <= 64) {
    launch_one<T, 2, 32, 32, 32>(grid, st, q, k, v, o, S, Tk, H, G, dh, dv,
                                 qs, ks, vs, scale_log2, causal);
  } else if (dh <= 128) {
    launch_one<T, 2, 64, 64, 32>(grid, st, q, k, v, o, S, Tk, H, G, dh, dv,
                                 qs, ks, vs, scale_log2, causal);
  } else {          // up to 256: four threads a row, 16-key tiles
    launch_one<T, 4, 64, 64, 16>(grid, st, q, k, v, o, S, Tk, H, G, dh, dv,
                                 qs, ks, vs, scale_log2, causal);
  }
  return (int)cudaGetLastError();
}

Strides strides(const long long* s) { return Strides{s[0], s[1], s[2], s[3]}; }

}  // namespace

extern "C" {

// q (B, S, H, dh), k (B, T, K, dh) and v (B, T, K, dv) with element
// strides {b, s, h, d}; o a contiguous (B, S, H, dv).  dv == dh <= 256,
// or (dh, dv) == (192, 128).  causal: 1 (T == S, query s reads keys
// t <= s) or 0 (every key).  dtype: 0 float32, 1 bfloat16.  Returns a
// cudaError_t (0 when the launch was accepted).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T, int H, int K, int dh, int dv,
                        const long long* q_strides,
                        const long long* k_strides,
                        const long long* v_strides, int causal, int dtype,
                        void* stream) {
  const bool dims_ok =
      (dv == dh && dh > 0 && dh <= 256) || (dh == 192 && dv == 128);
  if (B <= 0 || S <= 0 || T <= 0 || (causal && T != S) || H <= 0 ||
      K <= 0 || H % K != 0 || !dims_ok || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Strides qs = strides(q_strides), ks = strides(k_strides),
                vs = strides(v_strides);
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, S, T, H, K, dh, dv, qs, ks, vs,
                         causal != 0, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, S, T, H, K, dh, dv, qs, ks,
                                 vs, causal != 0, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
