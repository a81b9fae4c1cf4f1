// LAMB phase 1 for Hopper (sm_90a), plain C interface.
//
// Replaces: apex_tpu/ops/fused_optim.py `_elementwise_call` running
// `_lamb_phase1_kernel` (`lamb_phase1`, :262-305; the reference's
// csrc/multi_tensor_lamb.cu LAMBStage1) — the LAMB body of row 19 of the
// kernel table: over one flat group it reads the gradient g (the model's
// dtype), the fp32 master p and moments m, v, scales g by gscale (amp's
// unscale times the global-norm clip factor), forms the Adam moments with
// beta3 = 1 - beta1 under grad averaging, and writes the update direction
// u = m^/(sqrt(v^) + eps) (+ wd * p in AdamW mode; L2 mode folds wd * p
// into g) as a separate fp32 buffer, with m and v updated in place.  p is
// only read: phase 2 (the per-tensor trust ratio, plain torch over views
// of u and p, as it is jnp in JAX) needs the old master's norms before
// p -= lr * ratio * u.
//
// gscale comes as a device fp32 scalar, as the JAX kernel reads its
// hyperparameter vector from SMEM: under a static loss scale the clip
// factor is computed on the device from the norm sweep's output, and the
// step reads nothing back to the host.
//
// What bounds it on the H100: bytes.  About 20 operations per element
// against 26 bytes moved (2 for a bf16 g, 12 read for p, m, v, 12 written
// for m, v, u): ~2.6 ms at 3.35 TB/s for BERT-large's 336M elements.
//
// What the simple design does about it: the Adam sweep's pattern
// (csrc/fused_adam.cu): one pass, every element read and written once,
// four elements per thread per iteration with 16-byte loads of p/m/v and
// 8-byte loads of a 16-bit g (a scalar loop takes over when a pointer is
// not aligned for that, and for the tail), a grid-stride loop over a grid
// sized to fill the card.  Math is fp32 in the order of the JAX kernel.
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

struct Hyp {
  float b1, b2, b3, eps, wd, bc1, bc2;
};

constexpr int kThreads = 256;

// four elements of T at p (aligned for the vector width) as fp32
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* i) {
    *reinterpret_cast<float4*>(p) = make_float4(i[0], i[1], i[2], i[3]);
  }
};
template <typename H> struct Vec4Half {
  static __device__ __forceinline__ void load(const H* p, float* o) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const H* h = reinterpret_cast<const H*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = to_f<H>(h[e]);
  }
};
template <> struct Vec4<__nv_bfloat16> : Vec4Half<__nv_bfloat16> {};
template <> struct Vec4<__half> : Vec4Half<__half> {};

// one element: the `_lamb_phase1_kernel` expression, in its order
__device__ __forceinline__ float lamb_one(float g, float p, float& m, float& v,
                                          float gscale, const Hyp& h, bool adam_w) {
  g = g * gscale;
  if (!adam_w) g = g + h.wd * p;
  m = h.b1 * m + h.b3 * g;
  v = h.b2 * v + (1.0f - h.b2) * g * g;
  float u = (m / h.bc1) / (sqrtf(v / h.bc2) + h.eps);
  if (adam_w) u = u + h.wd * p;
  return u;
}

template <typename G, bool kVec>
__global__ void __launch_bounds__(kThreads)
lamb_phase1_kernel(const G* __restrict__ g, const float* __restrict__ p,
                   float* __restrict__ m, float* __restrict__ v, float* __restrict__ u,
                   const float* __restrict__ gscale_ptr, long long n, Hyp h,
                   int adam_w) {
  const float gscale = *gscale_ptr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (kVec) {
    const long long n4 = n / 4;
    for (long long q = first; q < n4; q += stride) {
      const long long i = 4 * q;
      float gg[4], pp[4], mm[4], vv[4], uu[4];
      Vec4<G>::load(g + i, gg);
      Vec4<float>::load(p + i, pp);
      Vec4<float>::load(m + i, mm);
      Vec4<float>::load(v + i, vv);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        uu[e] = lamb_one(gg[e], pp[e], mm[e], vv[e], gscale, h, adam_w);
      Vec4<float>::store(m + i, mm);
      Vec4<float>::store(v + i, vv);
      Vec4<float>::store(u + i, uu);
    }
    tail = 4 * n4;
  }
  for (long long i = tail + first; i < n; i += stride) {
    float mm = m[i], vv = v[i];
    u[i] = lamb_one(to_f<G>(g[i]), p[i], mm, vv, gscale, h, adam_w);
    m[i] = mm;
    v[i] = vv;
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) % bytes) == 0;
}

template <typename G>
cudaError_t launch(const void* g, const void* p, void* m, void* v, void* u,
                   const void* gscale, long long n, const Hyp& h, int adam_w,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const bool vec = aligned(g, 4 * sizeof(G)) && aligned(p, 16) && aligned(m, 16) &&
                   aligned(v, 16) && aligned(u, 16);
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 8;  // 8 resident blocks of 256 per SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const G* gp = static_cast<const G*>(g);
  const float* pp = static_cast<const float*>(p);
  float* mp = static_cast<float*>(m);
  float* vp = static_cast<float*>(v);
  float* up = static_cast<float*>(u);
  const float* sp = static_cast<const float*>(gscale);
  if (vec)
    lamb_phase1_kernel<G, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        gp, pp, mp, vp, up, sp, n, h, adam_w);
  else
    lamb_phase1_kernel<G, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        gp, pp, mp, vp, up, sp, n, h, adam_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// g (n,) of g_dtype; p (n,) fp32, read only; m, v (n,) fp32, updated in
// place; u (n,) fp32, written; gscale a device fp32 scalar.  The other
// hyperparameters are those of `_lamb_phase1_kernel`: beta1, beta2, beta3
// (1 - beta1 with grad averaging, else 1), eps, weight_decay and the bias
// corrections bc1, bc2.  adam_w_mode 1: decoupled decay joins u, 0: L2
// decay folded into g.  dtype codes: 0 float32, 1 bfloat16, 2 float16.
int apex_lamb_phase1(const void* g, const void* p, void* m, void* v, void* u,
                     const void* gscale, long long n, float beta1, float beta2,
                     float beta3, float eps, float weight_decay, float bc1, float bc2,
                     int adam_w_mode, int g_dtype, void* stream) {
  if (n < 0 || gscale == nullptr) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Hyp h{beta1, beta2, beta3, eps, weight_decay, bc1, bc2};
  switch (g_dtype) {
    case 0:
      return launch<float>(g, p, m, v, u, gscale, n, h, adam_w_mode, s);
    case 1:
      return launch<__nv_bfloat16>(g, p, m, v, u, gscale, n, h, adam_w_mode, s);
    case 2:
      return launch<__half>(g, p, m, v, u, gscale, n, h, adam_w_mode, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
