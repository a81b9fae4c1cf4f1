// LayerNorm forward and backward for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Forward replaces: apex_tpu/ops/layer_norm.py `_ln_forward` (Pallas
// kernel `_ln_fwd_kernel`): row LayerNorm over (rows, hidden) with fp32
// statistics, output in x's dtype, optional fp32 (or x-dtype) gamma/beta
// over low-precision x (the mixed variant), plus the fp32 per-row mean
// and rstd the backward reads.
//
// Backward replaces: apex_tpu/ops/layer_norm.py `_ln_backward` (Pallas
// kernel `_ln_bwd_kernel` plus the XLA sum of its per-block partials):
// dx = rstd * (gdy - mean(gdy) - xhat * mean(gdy * xhat)) with gdy =
// dy * gamma, all in fp32, and dgamma = sum(dy * xhat), dbeta = sum(dy)
// over rows, summed in fp32 and cast once to gamma's dtype.
//
// What bounds both on the H100: bytes.  Each row is read once and written
// once, about 8 (forward) or 12 (backward) operations per element against
// 4 or 6 bytes moved in bf16, far below the ~295 operations per byte
// where the tensor cores (or even the 67 TFLOP/s fp32 pipes) would be the
// limit.
//
// What the simple designs do about it.  Forward: one block per row (256
// threads), the row is read from device memory exactly once into shared
// memory as fp32, mean and then the centred variance are reduced from
// there (two passes over shared memory, never over device memory, which
// keeps the JAX kernel's two-pass numerics), and y is written once.
// Backward: a fixed number of blocks, each walking rows blockIdx.x,
// blockIdx.x + gridDim.x, ...; a thread owns the same columns in every
// row, keeps xhat and gdy for them in shared memory between the row's
// one reduction (mean(gdy), mean(gdy * xhat) together) and the dx write,
// and accumulates its columns' dgamma/dbeta partials in shared memory
// across the block's rows.  Each block writes one fp32 partial row; a
// second small kernel sums the partial rows per column in a fixed order,
// so the result is deterministic (no atomics).  Later work: several rows
// per block and 16-byte vector loads.
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

// The two sums a and b over the block; every thread gets both.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < (int)(blockDim.x >> 5);
    float ta = in ? red[lane] : 0.f;
    float tb = in ? red[32 + lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ta += __shfl_xor_sync(0xffffffffu, ta, o);
      tb += __shfl_xor_sync(0xffffffffu, tb, o);
    }
    if (lane == 0) {
      red[64] = ta;
      red[65] = tb;
    }
  }
  __syncthreads();
  const float2 total = make_float2(red[64], red[65]);
  __syncthreads();  // red is reused by the next row
  return total;
}

// dx for rows blockIdx.x, blockIdx.x + gridDim.x, ...; with gamma, this
// block's dgamma/dbeta partial rows (fp32, one row of `hidden` each).
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
              const T* __restrict__ dy, const float* __restrict__ mean,
              const float* __restrict__ rstd, T* __restrict__ dx,
              float* __restrict__ dgamma_part, float* __restrict__ dbeta_part,
              int rows, int hidden) {
  extern __shared__ float sm[];  // xhat, gdy, dgamma part, dbeta part
  float* xh = sm;
  float* gd = sm + hidden;
  float* pg = sm + 2 * hidden;
  float* pb = sm + 3 * hidden;
  __shared__ float red[66];
  const bool affine = gamma != nullptr;
  const float inv_h = 1.0f / (float)hidden;
  if (affine) {
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
      pg[i] = 0.f;
      pb[i] = 0.f;
    }
  }
  // every shared entry is read back only by the thread that wrote it
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const size_t base = (size_t)r * hidden;
    const float mu = mean[r];
    const float rs = rstd[r];
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
      const float xv = (to_f<T>(x[base + i]) - mu) * rs;
      const float dyv = to_f<T>(dy[base + i]);
      const float g = affine ? dyv * to_f<W>(gamma[i]) : dyv;
      xh[i] = xv;
      gd[i] = g;
      s1 += g;
      s2 = fmaf(g, xv, s2);
      if (affine) {
        pg[i] = fmaf(dyv, xv, pg[i]);
        pb[i] += dyv;
      }
    }
    const float2 t = block_sum2(s1, s2, red);
    const float m1 = t.x * inv_h;
    const float m2 = t.y * inv_h;
    for (int i = threadIdx.x; i < hidden; i += blockDim.x)
      dx[base + i] = from_f<T>(rs * (gd[i] - m1 - xh[i] * m2));
  }
  if (affine) {
    const size_t prow = (size_t)blockIdx.x * hidden;
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
      dgamma_part[prow + i] = pg[i];
      dbeta_part[prow + i] = pb[i];
    }
  }
}

constexpr int kColTile = 32;  // columns per block of the partial sum
constexpr int kPartLanes = 8;  // partial rows summed in parallel per column

// dgamma/dbeta = the per-column sums of the parts partial rows, in a
// fixed order, cast once to gamma's dtype.
template <typename W>
__global__ void __launch_bounds__(kColTile * kPartLanes)
ln_bwd_wgrad_kernel(const float* __restrict__ dgamma_part,
                    const float* __restrict__ dbeta_part, W* __restrict__ dgamma,
                    W* __restrict__ dbeta, int parts, int hidden) {
  __shared__ float sg[kPartLanes][kColTile];
  __shared__ float sb[kPartLanes][kColTile];
  const int c = threadIdx.x % kColTile;
  const int lane = threadIdx.x / kColTile;
  const int col = blockIdx.x * kColTile + c;
  float a = 0.f, b = 0.f;
  if (col < hidden) {
    for (int p = lane; p < parts; p += kPartLanes) {
      a += dgamma_part[(size_t)p * hidden + col];
      b += dbeta_part[(size_t)p * hidden + col];
    }
  }
  sg[lane][c] = a;
  sb[lane][c] = b;
  __syncthreads();
  if (lane == 0 && col < hidden) {
#pragma unroll
    for (int k = 1; k < kPartLanes; ++k) {
      a += sg[k][c];
      b += sb[k][c];
    }
    dgamma[col] = from_f<W>(a);
    dbeta[col] = from_f<W>(b);
  }
}

template <typename T, typename W>
cudaError_t launch_bwd(const void* x, const void* gamma, const void* dy,
                       const void* mean, const void* rstd, void* dx,
                       void* dgamma_part, void* dbeta_part, void* dgamma,
                       void* dbeta, int rows, int hidden, int parts,
                       cudaStream_t stream) {
  const size_t smem = (size_t)4 * hidden * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ln_bwd_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  ln_bwd_kernel<T, W><<<parts, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(gamma),
      static_cast<const T*>(dy), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<T*>(dx),
      static_cast<float*>(dgamma_part), static_cast<float*>(dbeta_part), rows,
      hidden);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || gamma == nullptr) return e;
  const int blocks = (hidden + kColTile - 1) / kColTile;
  ln_bwd_wgrad_kernel<W><<<blocks, kColTile * kPartLanes, 0, stream>>>(
      static_cast<const float*>(dgamma_part),
      static_cast<const float*>(dbeta_part), static_cast<W*>(dgamma),
      static_cast<W*>(dbeta), parts, hidden);
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

// Backward.  x, dy, dx (rows, hidden) of dtype x_dtype; mean/rstd (rows,)
// fp32 from the forward; gamma (hidden,) of w_dtype (x's or float32) or
// null (no affine: dgamma/dbeta and the partial buffers are then not
// touched).  dgamma_part/dbeta_part: fp32 scratch of parts * hidden,
// where parts (1..rows) is the number of row-walking blocks; dgamma and
// dbeta (hidden,) of w_dtype.  hidden <= 8192 (4 * hidden floats of
// shared memory per block).
int apex_layer_norm_bwd(const void* x, const void* gamma, const void* dy,
                        const void* mean, const void* rstd, void* dx,
                        void* dgamma_part, void* dbeta_part, void* dgamma,
                        void* dbeta, int rows, int hidden, int parts,
                        int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || hidden <= 0 || hidden > 8192 || parts <= 0 || parts > rows)
    return cudaErrorInvalidValue;
  if (gamma == nullptr) w_dtype = 0;
#define APEX_LN_BWD(T, W)                                                      \
  return launch_bwd<T, W>(x, gamma, dy, mean, rstd, dx, dgamma_part, dbeta_part, \
                          dgamma, dbeta, rows, hidden, parts, s)
  if (x_dtype == 0 && w_dtype == 0) APEX_LN_BWD(float, float);
  if (x_dtype == 1 && w_dtype == 1) APEX_LN_BWD(__nv_bfloat16, __nv_bfloat16);
  if (x_dtype == 1 && w_dtype == 0) APEX_LN_BWD(__nv_bfloat16, float);
  if (x_dtype == 2 && w_dtype == 2) APEX_LN_BWD(__half, __half);
  if (x_dtype == 2 && w_dtype == 0) APEX_LN_BWD(__half, float);
#undef APEX_LN_BWD
  return cudaErrorInvalidValue;
}

}  // extern "C"
