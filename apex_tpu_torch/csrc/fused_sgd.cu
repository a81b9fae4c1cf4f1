// Momentum SGD for Hopper (sm_90a), plain C interface: the per-leaf
// step and the packed-pipeline sweep.
//
// Replaces: apex_tpu/ops/fused_optim.py `_elementwise_call` running
// `_sgd_step_kernel` (`sgd_step`, :368-416) and
// apex_tpu/ops/fused_pipeline.py `_sgd_pipeline_kernel` (`sgd_pipeline`,
// :409-479) — two SGD bodies of row 19 of the kernel table.  Over one flat
// buffer each reads the gradient g (bf16, fp16 or fp32), the fp32 master
// p and the fp32 momentum buffer, and computes in fp32
//
//     g    = g * gscale                      (pipeline only)
//     g    = g + wd * p                      (wd before the momentum)
//     mom  = first_run ? g : momentum * mom + (1 - dampening) * g
//     upd  = nesterov ? g + momentum * mom : mom
//     upd  = upd + wd * p                    (wd after the momentum)
//     p    = p - lr * upd
//
// writing p and mom in place and, when the model keeps a low-precision
// copy, that copy cast from the new p.  The pipeline sweep also selects
// by `keep` (the overflow skip: keep = 0 leaves p and mom bitwise as they
// were, and the copy is the cast of the old p).  Its gscale and keep are
// read from device memory, as the JAX kernel reads its hyperparameter
// vector from SMEM, so a flag measured on the device needs no host read.
//
// Every operation is written with an explicit round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn), in the order of the plain PyTorch
// version (apex_tpu_torch/ops/fused_optim.py, fused_pipeline.py): nvcc
// may not contract them into an FMA, and eager PyTorch rounds after every
// operation, so the kernel and its plain version agree bit for bit.
//
// What bounds it on the H100: bytes.  About 8 operations per element
// against 20 bytes moved on a bf16-model leaf (2 for g, 8 read and 8
// written for p and mom, 2 for the copy; an fp32 leaf: 4 for g, no copy):
// ResNet-50's 25.6M parameters, 511 MB, 0.153 ms at 3.35 TB/s.
//
// What the simple design does about it: one pass, every element read and
// written once, four elements per thread per iteration with 16-byte loads
// of p/mom (and of an fp32 g) and 8-byte loads of a 16-bit g (a scalar
// loop takes over when a pointer is not aligned for that, and for the
// tail), and a grid-stride loop over a grid sized to fill the card.  A
// ResNet-50 leaf is small (a 64-channel BN vector to 2.4M elements), so
// the per-leaf step is one launch a leaf and its cost is the launch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// lr, momentum, 1 - dampening (formed in fp32 by the caller), weight
// decay; the three flags
struct Hyp {
  float lr, momentum, omd, wd;
  int first_run, nesterov, wd_after;
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

// one element, in the plain version's order; g arrives already scaled
__device__ __forceinline__ void sgd_one(float g, float& p, float& mom, const Hyp& h,
                                        bool keep) {
  if (!h.wd_after) g = __fadd_rn(g, __fmul_rn(h.wd, p));
  const float m = h.first_run ? g
                              : __fadd_rn(__fmul_rn(h.momentum, mom), __fmul_rn(h.omd, g));
  float upd = h.nesterov ? __fadd_rn(g, __fmul_rn(h.momentum, m)) : m;
  if (h.wd_after) upd = __fadd_rn(upd, __fmul_rn(h.wd, p));
  if (keep) {
    p = __fsub_rn(p, __fmul_rn(h.lr, upd));
    mom = m;
  }
}

// kScaled: the pipeline sweep (g * *gscale, the select by *keep); else the
// per-leaf step (gscale and keep null)
template <typename G, typename L, bool kVec, bool kScaled>
__global__ void __launch_bounds__(kThreads)
sgd_kernel(const G* __restrict__ g, float* __restrict__ p, float* __restrict__ mom,
           L* __restrict__ lowp, long long n, Hyp h, const float* __restrict__ gscale,
           const float* __restrict__ keep_flag) {
  const float gs = kScaled ? *gscale : 1.0f;
  const bool keep = kScaled ? (*keep_flag > 0.5f) : true;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (kVec) {
    const long long n4 = n / 4;
    for (long long q = first; q < n4; q += stride) {
      const long long i = 4 * q;
      float gg[4], pp[4], mm[4];
      Vec4<G>::load(g + i, gg);
      Vec4<float>::load(p + i, pp);
      Vec4<float>::load(mom + i, mm);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ge = kScaled ? __fmul_rn(gg[e], gs) : gg[e];
        sgd_one(ge, pp[e], mm[e], h, keep);
      }
      if (keep) {
        Vec4<float>::store(p + i, pp);
        Vec4<float>::store(mom + i, mm);
      }
      if (lowp != nullptr) Vec4<L>::store(lowp + i, pp);
    }
    tail = 4 * n4;
  }
  for (long long i = tail + first; i < n; i += stride) {
    float pp = p[i], mm = mom[i];
    const float ge = kScaled ? __fmul_rn(to_f<G>(g[i]), gs) : to_f<G>(g[i]);
    sgd_one(ge, pp, mm, h, keep);
    if (keep) {
      p[i] = pp;
      mom[i] = mm;
    }
    if (lowp != nullptr) lowp[i] = from_f<L>(pp);
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return ptr == nullptr || (reinterpret_cast<uintptr_t>(ptr) % bytes) == 0;
}

template <typename G, typename L, bool kScaled>
cudaError_t launch(const void* g, void* p, void* mom, void* lowp, long long n,
                   const Hyp& h, const float* gscale, const float* keep,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const bool vec = aligned(g, 4 * sizeof(G)) && aligned(p, 16) && aligned(mom, 16) &&
                   aligned(lowp, 4 * sizeof(L));
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 8;  // 8 resident blocks of 256 per SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (vec)
    sgd_kernel<G, L, true, kScaled><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const G*>(g), static_cast<float*>(p), static_cast<float*>(mom),
        static_cast<L*>(lowp), n, h, gscale, keep);
  else
    sgd_kernel<G, L, false, kScaled><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const G*>(g), static_cast<float*>(p), static_cast<float*>(mom),
        static_cast<L*>(lowp), n, h, gscale, keep);
  return cudaGetLastError();
}

template <bool kScaled, typename G>
cudaError_t launch_g(const void* g, void* p, void* mom, void* lowp, long long n,
                     const Hyp& h, const float* gscale, const float* keep, int lowp_dtype,
                     cudaStream_t stream) {
  if (lowp == nullptr)
    return launch<G, float, kScaled>(g, p, mom, nullptr, n, h, gscale, keep, stream);
  switch (lowp_dtype) {
    case 1:
      return launch<G, __nv_bfloat16, kScaled>(g, p, mom, lowp, n, h, gscale, keep, stream);
    case 2:
      return launch<G, __half, kScaled>(g, p, mom, lowp, n, h, gscale, keep, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kScaled>
cudaError_t dispatch(const void* g, void* p, void* mom, void* lowp, long long n,
                     const Hyp& h, const float* gscale, const float* keep, int g_dtype,
                     int lowp_dtype, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g_dtype) {
    case 0:
      return launch_g<kScaled, float>(g, p, mom, lowp, n, h, gscale, keep, lowp_dtype, s);
    case 1:
      return launch_g<kScaled, __nv_bfloat16>(g, p, mom, lowp, n, h, gscale, keep,
                                              lowp_dtype, s);
    case 2:
      return launch_g<kScaled, __half>(g, p, mom, lowp, n, h, gscale, keep, lowp_dtype, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// The per-leaf step (`_sgd_step_kernel`).  g (n,) of g_dtype; p, mom (n,)
// fp32, updated in place; lowp (n,) of lowp_dtype (1 bfloat16, 2 float16)
// or null when the master is the model copy.  omd is 1 - dampening in
// fp32.  first_run 1: mom <- g (torch's first step).  dtype codes: 0
// float32, 1 bfloat16, 2 float16.
int apex_sgd_step(const void* g, void* p, void* mom, void* lowp, long long n, float lr,
                  float momentum, float omd, float weight_decay, int first_run,
                  int nesterov, int wd_after_momentum, int g_dtype, int lowp_dtype,
                  void* stream) {
  const Hyp h{lr, momentum, omd, weight_decay, first_run, nesterov, wd_after_momentum};
  return dispatch<false>(g, p, mom, lowp, n, h, nullptr, nullptr, g_dtype, lowp_dtype,
                         stream);
}

// The pipeline sweep (`_sgd_pipeline_kernel`): the step above on g scaled
// by *gscale, with p and mom kept as they were unless *keep > 0.5; gscale
// and keep are fp32 scalars in device memory.
int apex_sgd_pipeline(const void* g, void* p, void* mom, void* lowp, const void* gscale,
                      const void* keep, long long n, float lr, float momentum, float omd,
                      float weight_decay, int first_run, int nesterov,
                      int wd_after_momentum, int g_dtype, int lowp_dtype, void* stream) {
  if (gscale == nullptr || keep == nullptr) return cudaErrorInvalidValue;
  const Hyp h{lr, momentum, omd, weight_decay, first_run, nesterov, wd_after_momentum};
  return dispatch<true>(g, p, mom, lowp, n, h, static_cast<const float*>(gscale),
                        static_cast<const float*>(keep), g_dtype, lowp_dtype, stream);
}

}  // extern "C"
