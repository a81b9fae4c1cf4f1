// The Adam pipeline sweep for Hopper (sm_90a), plain C interface.
//
// Replaces: apex_tpu/ops/fused_optim.py `_elementwise_call` running
// apex_tpu/ops/fused_pipeline.py `_adam_pipeline_kernel` — the
// persistent packed optimizer's update sweep: over one flat group it
// reads the gradient g (the model's dtype) and the fp32 master p and
// moments m, v, scales g by gscale (amp's unscale times any clip),
// applies Adam or AdamW with bias corrections bc1/bc2, selects the
// update or the old state by `keep` (the overflow skip: keep = 0 leaves
// p, m and v bitwise as they were), and writes p, m, v in place plus the
// master->model cast of p into the model's low-precision flat buffer.
// The other `_elementwise_call` bodies (plain Adam, SGD, LAMB, Adagrad,
// NovoGrad, the SGD pipeline) are not ported yet.
//
// What bounds it on the H100: bytes.  About 20 operations per element
// against 28 bytes moved (2 for a bf16 g, 12 read and 12 written for p,
// m, v, 2 for the bf16 copy): one stream with no reuse, ~3 ms at
// 3.35 TB/s for GPT-345M's 355M elements.
//
// What the simple design does about it: one pass, each element read and
// written exactly once, four elements per thread per iteration with
// 16-byte loads of p/m/v and 8-byte loads of a 16-bit g (a scalar loop
// takes over when a pointer is not aligned for that, and for the tail),
// and a grid-stride loop over a grid sized to fill the card.  Math is
// fp32 in the order of the JAX kernel.
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

struct Hyp {
  float lr, b1, b2, eps, wd, bc1, bc2, gscale, keep;
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
  static __device__ __forceinline__ void store(H* p, const float* i) {
    uint2 u;
    H* h = reinterpret_cast<H*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = from_f<H>(i[e]);
    *reinterpret_cast<uint2*>(p) = u;
  }
};
template <> struct Vec4<__nv_bfloat16> : Vec4Half<__nv_bfloat16> {};
template <> struct Vec4<__half> : Vec4Half<__half> {};

// one element: the `_adam_pipeline_kernel` expression, in its order
__device__ __forceinline__ void adam_one(float g, float& p, float& m, float& v,
                                         const Hyp& h, bool adam_w, bool keep) {
  g = g * h.gscale;
  if (!adam_w) g = g + h.wd * p;
  const float m_new = h.b1 * m + (1.0f - h.b1) * g;
  const float v_new = h.b2 * v + (1.0f - h.b2) * g * g;
  float upd = (m_new / h.bc1) / (sqrtf(v_new / h.bc2) + h.eps);
  if (adam_w) upd = upd + h.wd * p;
  if (keep) {
    p = p - h.lr * upd;
    m = m_new;
    v = v_new;
  }
}

template <typename G, typename L, bool kVec>
__global__ void __launch_bounds__(kThreads)
adam_pipeline_kernel(const G* __restrict__ g, float* __restrict__ p,
                     float* __restrict__ m, float* __restrict__ v,
                     L* __restrict__ lowp, long long n, Hyp h, int adam_w) {
  const bool keep = h.keep > 0.5f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (kVec) {
    const long long n4 = n / 4;
    for (long long q = first; q < n4; q += stride) {
      const long long i = 4 * q;
      float gg[4], pp[4], mm[4], vv[4];
      Vec4<G>::load(g + i, gg);
      Vec4<float>::load(p + i, pp);
      Vec4<float>::load(m + i, mm);
      Vec4<float>::load(v + i, vv);
#pragma unroll
      for (int e = 0; e < 4; ++e) adam_one(gg[e], pp[e], mm[e], vv[e], h, adam_w, keep);
      Vec4<float>::store(p + i, pp);
      Vec4<float>::store(m + i, mm);
      Vec4<float>::store(v + i, vv);
      if (lowp != nullptr) Vec4<L>::store(lowp + i, pp);
    }
    tail = 4 * n4;
  }
  for (long long i = tail + first; i < n; i += stride) {
    float pp = p[i], mm = m[i], vv = v[i];
    adam_one(to_f<G>(g[i]), pp, mm, vv, h, adam_w, keep);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
    if (lowp != nullptr) lowp[i] = from_f<L>(pp);
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return ptr == nullptr || (reinterpret_cast<uintptr_t>(ptr) % bytes) == 0;
}

template <typename G, typename L>
cudaError_t launch(const void* g, void* p, void* m, void* v, void* lowp, long long n,
                   const Hyp& h, int adam_w, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const bool vec = aligned(g, 4 * sizeof(G)) && aligned(p, 16) && aligned(m, 16) &&
                   aligned(v, 16) && aligned(lowp, 4 * sizeof(L));
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 8;  // 8 resident blocks of 256 per SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (vec)
    adam_pipeline_kernel<G, L, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const G*>(g), static_cast<float*>(p), static_cast<float*>(m),
        static_cast<float*>(v), static_cast<L*>(lowp), n, h, adam_w);
  else
    adam_pipeline_kernel<G, L, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const G*>(g), static_cast<float*>(p), static_cast<float*>(m),
        static_cast<float*>(v), static_cast<L*>(lowp), n, h, adam_w);
  return cudaGetLastError();
}

template <typename G>
cudaError_t launch_g(const void* g, void* p, void* m, void* v, void* lowp,
                     long long n, const Hyp& h, int adam_w, int lowp_dtype,
                     cudaStream_t stream) {
  if (lowp == nullptr) return launch<G, float>(g, p, m, v, nullptr, n, h, adam_w, stream);
  switch (lowp_dtype) {
    case 1:
      return launch<G, __nv_bfloat16>(g, p, m, v, lowp, n, h, adam_w, stream);
    case 2:
      return launch<G, __half>(g, p, m, v, lowp, n, h, adam_w, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// g (n,) of g_dtype; p, m, v (n,) fp32, updated in place; lowp (n,) of
// lowp_dtype (1 bfloat16, 2 float16) or null for an fp32 group whose
// master is the model copy.  The nine hyperparameters are those of
// `_adam_pipeline_kernel`: lr, beta1, beta2, eps, weight_decay, the bias
// corrections bc1 and bc2, gscale, and keep (> 0.5 steps, else the state
// stays as it was).  adam_w_mode 1: decoupled decay (AdamW), 0: L2 decay
// folded into g.  dtype codes: 0 float32, 1 bfloat16, 2 float16.
int apex_adam_pipeline(const void* g, void* p, void* m, void* v, void* lowp,
                       long long n, float lr, float beta1, float beta2, float eps,
                       float weight_decay, float bc1, float bc2, float gscale,
                       float keep, int adam_w_mode, int g_dtype, int lowp_dtype,
                       void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Hyp h{lr, beta1, beta2, eps, weight_decay, bc1, bc2, gscale, keep};
  switch (g_dtype) {
    case 0:
      return launch_g<float>(g, p, m, v, lowp, n, h, adam_w_mode, lowp_dtype, s);
    case 1:
      return launch_g<__nv_bfloat16>(g, p, m, v, lowp, n, h, adam_w_mode, lowp_dtype,
                                     s);
    case 2:
      return launch_g<__half>(g, p, m, v, lowp, n, h, adam_w_mode, lowp_dtype, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
