// The norm/finite sweep of the packed optimizer pipeline for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces: apex_tpu/ops/fused_pipeline.py `_norm_finite_pallas` (Pallas
// kernel `_norm_finite_kernel` plus the XLA reduction of its per-block
// partials): over one flat gradient buffer, the fp32 sum of (g * inv)^2
// and whether every g * inv is finite (NaN, +inf and -inf all count as
// not finite).  The caller takes the square root of the sum over its
// buffers and ANDs their flags.
//
// What bounds it on the H100: bytes.  Three operations per element
// against 2 bytes read (fp16 g): one read-only stream, 0.21 ms at
// 3.35 TB/s for GPT-345M's 355M fp16 gradients.
//
// What the simple design does about it: a grid-stride pass over a grid
// sized to fill the card (8 blocks of 256 threads per SM), 16-byte loads
// (8 fp16 or bf16, 4 fp32) where the buffer is aligned for them and a
// scalar loop for the tail; each thread keeps its sum and its flag in
// registers, each block reduces them in a fixed tree and writes one
// partial and one flag.  A second launch of one block sums the partials
// in a fixed order and ANDs the flags.  No atomics, so the sum is the
// same bits from run to run on the same card.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFinalThreads = 1024;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}

__device__ __forceinline__ void accumulate(float g, float inv, float& s, int& fin) {
  const float u = g * inv;
  s = fmaf(u, u, s);
  fin &= isfinite(u) ? 1 : 0;
}

// block-wide sum of s and AND of fin, in a fixed order; thread 0 gets both
template <int kBlock>
__device__ __forceinline__ void block_reduce(float& s, int& fin) {
  __shared__ float ps[kBlock / 32];
  __shared__ int pf[kBlock / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    fin &= __shfl_xor_sync(0xffffffffu, fin, o);
  }
  if (lane == 0) {
    ps[warp] = s;
    pf[warp] = fin;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kBlock / 32 ? ps[lane] : 0.f;
    fin = lane < kBlock / 32 ? pf[lane] : 1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      fin &= __shfl_xor_sync(0xffffffffu, fin, o);
    }
  }
}

// 16 bytes of T as fp32
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <typename H> struct Vec16Half {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const H* p, float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const H* h = reinterpret_cast<const H*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = to_f<H>(h[e]);
  }
};
template <> struct Vec16<__nv_bfloat16> : Vec16Half<__nv_bfloat16> {};
template <> struct Vec16<__half> : Vec16Half<__half> {};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
norm_partials_kernel(const T* __restrict__ g, long long n, float inv,
                     float* __restrict__ part, int* __restrict__ fin_part) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float s = 0.f;
  int fin = 1;
  long long tail = 0;
  if (kVec) {
    constexpr int kN = Vec16<T>::kN;
    const long long nv = n / kN;
    for (long long q = first; q < nv; q += stride) {
      float v[kN];
      Vec16<T>::load(g + kN * q, v);
#pragma unroll
      for (int e = 0; e < kN; ++e) accumulate(v[e], inv, s, fin);
    }
    tail = kN * nv;
  }
  for (long long i = tail + first; i < n; i += stride) accumulate(to_f<T>(g[i]), inv, s, fin);
  block_reduce<kThreads>(s, fin);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = s;
    fin_part[blockIdx.x] = fin;
  }
}

__global__ void __launch_bounds__(kFinalThreads)
norm_final_kernel(const float* __restrict__ part, const int* __restrict__ fin_part,
                  int blocks, float* __restrict__ out) {
  float s = 0.f;
  int fin = 1;
  for (int i = threadIdx.x; i < blocks; i += kFinalThreads) {
    s += part[i];
    fin &= fin_part[i];
  }
  block_reduce<kFinalThreads>(s, fin);
  if (threadIdx.x == 0) {
    out[0] = s;
    out[1] = fin ? 1.f : 0.f;
  }
}

template <typename T>
cudaError_t launch(const void* g, long long n, float inv, float* part, int* fin_part,
                   int blocks, float* out, cudaStream_t st) {
  const T* gp = static_cast<const T*>(g);
  const bool vec = (reinterpret_cast<uintptr_t>(g) % 16) == 0;
  if (vec)
    norm_partials_kernel<T, true><<<blocks, kThreads, 0, st>>>(gp, n, inv, part, fin_part);
  else
    norm_partials_kernel<T, false><<<blocks, kThreads, 0, st>>>(gp, n, inv, part, fin_part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  norm_final_kernel<<<1, kFinalThreads, 0, st>>>(part, fin_part, blocks, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// The number of partial slots the sweep over n elements uses: the caller
// allocates that many floats and ints of scratch.
int apex_norm_finite_blocks(long long n) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 8LL * sms;  // 8 resident blocks of 256 per SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}

// g (n,) of dtype (0 float32, 1 bfloat16, 2 float16); part (blocks,) fp32
// and fin_part (blocks,) int32 scratch; out (2,) fp32 receives
// [sum of (g * inv)^2, 1 if every g * inv is finite else 0].
int apex_norm_finite(const void* g, long long n, float inv, void* part, void* fin_part,
                     int blocks, void* out, int dtype, void* stream) {
  if (n < 0 || blocks < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  int* fp = static_cast<int*>(fin_part);
  float* op = static_cast<float*>(out);
  switch (dtype) {
    case 0: return launch<float>(g, n, inv, pp, fp, blocks, op, s);
    case 1: return launch<__nv_bfloat16>(g, n, inv, pp, fp, blocks, op, s);
    case 2: return launch<__half>(g, n, inv, pp, fp, blocks, op, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
