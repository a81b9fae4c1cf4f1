// What the flash kernels' sources share: element conversions, the
// (b, h, s) strides of a strided (b, h, s, d) view, and the dims a thread
// owns when kTPR threads share a row.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

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

struct Strides {
  long long b, h, s;
};

// dims of a row owned by thread part t (of kTPR), in float4 chunks:
// chunk c is dims 4 * kTPR * c + 4 * t .. + 3 (contiguous at kTPR = 1)
template <int kTPR>
__device__ __forceinline__ int dim_of(int c, int t) { return 4 * kTPR * c + 4 * t; }

// run launch(T) for the dtype code (0 float32, 1 bfloat16, 2 float16)
template <typename F>
cudaError_t by_dtype(int dtype, F&& launch) {
  switch (dtype) {
    case 0:
      return launch(float{});
    case 1:
      return launch(__nv_bfloat16{});
    case 2:
      return launch(__half{});
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
