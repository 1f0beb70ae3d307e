// One 5-point Jacobi sweep on Hopper, full-grid and banded forms.
//
// Replaces the Pallas TPU kernel of the JAX package
//   src/repro/kernels/jacobi/jacobi.py  jacobi_step_pallas
// and the jnp stencil of src/repro/apps/jacobi.py JacobiApp._stencil:
// out = 0.25*(((up+down)+left)+right) on interior cells; the global
// first/last row and column keep their value.  The sum runs in the
// working type in that order (bf16 rounds after every operation, as the
// plain PyTorch version does), so results match it exactly.
//
// One kernel serves both forms.  The input holds K bands of in_band
// elements; output row r of band k reads input rows r+in_row0-1,
// r+in_row0, r+in_row0+1 of that band and is global row k*rows + r of a
// total_rows-row grid.
//   full grid (M, N):        K = 1, rows = M, in_row0 = 0
//   band (K, rows+2, N):     halo rows attached, in_row0 = 1
// Output band k starts out_band elements after band k-1 (rows of n
// elements), so a band can land in the interior of a padded buffer.
//
// Design: each thread owns one column of a strip of ROWS_PER_THREAD
// rows and walks down it; the up/down/left/right loads of neighbouring
// threads and rows hit L1/L2, so device memory sees each input element
// about once.  All K bands go in one launch (grid z = K).
//
// Bound on an H100: 4 operations per cell against 8 bytes moved (f32),
// far below the card's 67 TFLOP/s f32 rate per 3.35 TB/s, so it is
// bound by bytes: a 4096x4096 f32 grid reads 64 MiB and writes 64 MiB,
// about 40 us at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS_PER_THREAD = 8;

__device__ __forceinline__ float stencil(float up, float down, float left,
                                         float right) {
  return 0.25f * (((up + down) + left) + right);
}

__device__ __forceinline__ __nv_bfloat16 stencil(__nv_bfloat16 up,
                                                 __nv_bfloat16 down,
                                                 __nv_bfloat16 left,
                                                 __nv_bfloat16 right) {
  // every partial result rounds to bf16, as elementwise bf16 ops do
  float s = __bfloat162float(__float2bfloat16(__bfloat162float(up) +
                                              __bfloat162float(down)));
  s = __bfloat162float(__float2bfloat16(s + __bfloat162float(left)));
  s = __bfloat162float(__float2bfloat16(s + __bfloat162float(right)));
  return __float2bfloat16(0.25f * s);
}

template <typename T>
__global__ void jacobi_kernel(const T* __restrict__ in, long long in_band,
                              int in_row0, T* __restrict__ out,
                              long long out_band, int rows, int n,
                              int total_rows) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.z;
  if (c >= n) return;
  const T* src = in + (size_t)k * in_band;
  T* dst = out + (size_t)k * out_band;
  const int r0 = blockIdx.y * ROWS_PER_THREAD;
  const int r1 = min(r0 + ROWS_PER_THREAD, rows);
  const bool col_in = c > 0 && c < n - 1;
  for (int r = r0; r < r1; ++r) {
    const size_t m = (size_t)(r + in_row0) * n + c;
    const int g = k * rows + r;
    T v = src[m];
    if (col_in && g > 0 && g < total_rows - 1) {
      v = stencil(src[m - n], src[m + n], src[m - 1], src[m + 1]);
    }
    dst[(size_t)r * n + c] = v;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.
int jacobi_sweep(const void* in, long long in_band, int in_row0, void* out,
                 long long out_band, int K, int rows, int n, int total_rows,
                 int dtype, void* stream) {
  if (K <= 0 || rows <= 0 || n <= 0 || K > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((n + THREADS - 1) / THREADS,
            (rows + ROWS_PER_THREAD - 1) / ROWS_PER_THREAD, K);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    jacobi_kernel<float><<<grid, THREADS, 0, st>>>(
        (const float*)in, in_band, in_row0, (float*)out, out_band, rows, n,
        total_rows);
  } else if (dtype == 1) {
    jacobi_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)in, in_band, in_row0, (__nv_bfloat16*)out,
        out_band, rows, n, total_rows);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* jacobi_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
