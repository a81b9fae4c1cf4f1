// LayerNorm forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: apex_tpu/ops/layer_norm.py `_ln_forward` (Pallas kernel
// `_ln_fwd_kernel`): row LayerNorm over (rows, hidden) with fp32
// statistics, output in x's dtype, optional fp32 (or x-dtype) gamma/beta
// over low-precision x (the mixed variant), plus the fp32 per-row mean
// and rstd the backward will read.
//
// What bounds it on the H100: bytes.  Each row is read once and written
// once, about 8 operations per element against 4 bytes moved in bf16,
// far below the ~295 operations per byte where the tensor cores (or even
// the 67 TFLOP/s fp32 pipes) would be the limit.
//
// What the simple design does about it: one block per row (256
// threads), the row is read from device memory exactly once into shared
// memory as fp32, mean and then the centred variance are reduced from
// there (two passes over shared memory, never over device memory, which
// keeps the JAX kernel's two-pass numerics), and y is written once.
// Later work: several rows per block and 16-byte vector loads for the
// small-row decode case.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

// Sum of v over the block; every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  const float total = red[32];
  __syncthreads();  // red is reused by the next reduction
  return total;
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
              const W* __restrict__ beta, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int hidden, float eps) {
  extern __shared__ float row[];  // hidden floats
  __shared__ float red[33];
  const size_t base = (size_t)blockIdx.x * hidden;
  const T* xr = x + base;
  float s = 0.f;
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    const float v = to_f<T>(xr[i]);
    row[i] = v;  // each thread reads back only the entries it wrote
    s += v;
  }
  const float mean = block_sum(s, red) / (float)hidden;
  float ss = 0.f;
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    const float c = row[i] - mean;
    ss = fmaf(c, c, ss);
  }
  const float var = block_sum(ss, red) / (float)hidden;
  const float rstd = 1.0f / sqrtf(var + eps);  // rsqrtf is approximate
  T* yr = y + base;
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    float v = (row[i] - mean) * rstd;
    if (gamma != nullptr) v = v * to_f<W>(gamma[i]) + to_f<W>(beta[i]);
    yr[i] = from_f<T>(v);
  }
  if (threadIdx.x == 0) {
    mean_out[blockIdx.x] = mean;
    rstd_out[blockIdx.x] = rstd;
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y,
                   void* mean, void* rstd, int rows, int hidden, float eps,
                   cudaStream_t stream) {
  const size_t smem = (size_t)hidden * sizeof(float);
  ln_fwd_kernel<T, W><<<rows, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(gamma),
      static_cast<const W*>(beta), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), hidden, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// dtype codes: 0 float32, 1 bfloat16, 2 float16.  gamma/beta may be
// null (no affine); w_dtype is then ignored.  hidden * 4 bytes (at most
// 8192 floats) plus the reduction scratch fit 48 KB of shared memory.
int apex_layer_norm_fwd(const void* x, const void* gamma, const void* beta,
                        void* y, void* mean, void* rstd, int rows, int hidden,
                        float eps, int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || hidden <= 0 || hidden > 8192) return cudaErrorInvalidValue;
  if (gamma == nullptr) w_dtype = 0;
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, gamma, beta, y, mean, rstd, rows, hidden, eps, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, mean, rstd, rows,
                                                hidden, eps, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, gamma, beta, y, mean, rstd, rows, hidden,
                                        eps, s);
  if (x_dtype == 2 && w_dtype == 2)
    return launch<__half, __half>(x, gamma, beta, y, mean, rstd, rows, hidden, eps, s);
  if (x_dtype == 2 && w_dtype == 0)
    return launch<__half, float>(x, gamma, beta, y, mean, rstd, rows, hidden, eps, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
