// The optax-style update bodies for Hopper (sm_90a), plain C interface:
// Adam, Adagrad, NovoGrad and momentum SGD, each returning a delta.
//
// Replaces: apex_tpu/ops/fused_optim.py `_elementwise_call` running
// `_adam_kernel` (`adam_update`, :148-170), `_adagrad_kernel`
// (`adagrad_update`, :242-253), `_novograd_kernel` (`novograd_update`,
// :309-323) and `_sgd_kernel` (`sgd_update`, :338-356) — four bodies of row
// 19 of the kernel table.  Over one flat buffer of n elements each reads
// the gradient g and the parameter p (each fp32, bf16 or fp16) and its fp32
// state, computes in fp32
//
//   adam:     g = g + wd * p                              (L2 mode)
//             m = b1 * m + (1 - b1) * g
//             v = b2 * v + (1 - b2) * g * g
//             u = (m / bc1) / (sqrt(v / bc2) + eps)  (+ wd * p, AdamW mode)
//             delta = -lr * u
//   adagrad:  g = g + wd * p;  h = h + g * g
//             delta = -lr * g / (sqrt(h) + eps)
//   novograd: scaled = g / denom + wd * p     (denom per element, fp32)
//             m = b1 * m + b3 * scaled;  delta = -lr * m / bc1
//   sgd:      g = g + wd * p                 (wd before the momentum)
//             mom = first_run ? g : momentum * mom + (1 - dampening) * g
//             upd = nesterov ? g + momentum * mom : mom
//             upd = upd + wd * p             (wd after the momentum)
//             delta = -lr * upd
//
// and writes the delta in p's dtype (the one rounding a low-precision delta
// has, as the JAX kernels cast it) and the new state into separate output
// buffers: the update forms return new arrays, as JAX's do.  The (1 - x)
// terms arrive formed in fp32 by the caller (NovoGrad's b3 as the caller
// forms it).
//
// Every operation is written with an explicit round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn) in the order of the plain
// PyTorch version (apex_tpu_torch/ops/fused_optim.py): nvcc may not contract
// them into an FMA, and eager PyTorch rounds after every operation, so the
// kernel and its plain version agree bit for bit.
//
// What bounds it on the H100: bytes.  At most ~20 operations per element
// against 14-28 bytes moved (Adam with fp32 g and p: 16 read, 12 written;
// with a bf16 g 26; Adagrad and SGD 18 and NovoGrad 22 at bf16 g, fp32 p),
// one stream with no reuse: GPT-345M's 355M fp32 elements move 9.94 GB
// through Adam, 2.97 ms at 3.35 TB/s.
//
// What the simple design does about it: one pass, each element read and
// written exactly once, four elements per thread per iteration with
// 16-byte loads of fp32 buffers and 8-byte loads of 16-bit ones (a scalar
// loop takes over when a pointer is not aligned for that, and for the
// tail), and a grid-stride loop over a grid sized to fill the card.
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

// Each body: kIn fp32 state buffers read, kOut written; apply() takes one
// element's g, p and state and gives its delta (fp32, before the cast) and
// new state, every operation rounded in the plain version's order.

struct Adam {
  static constexpr int kIn = 2, kOut = 2;
  // 1 - beta1 and 1 - beta2 formed in fp32 by the caller
  struct Hyp {
    float lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2;
    int adam_w;
  };
  static __device__ __forceinline__ void apply(float g, float p, const float* in,
                                               float& d, float* out, const Hyp& h) {
    if (!h.adam_w) g = __fadd_rn(g, __fmul_rn(h.wd, p));
    const float m = __fadd_rn(__fmul_rn(h.b1, in[0]), __fmul_rn(h.omb1, g));
    const float v = __fadd_rn(__fmul_rn(h.b2, in[1]), __fmul_rn(__fmul_rn(h.omb2, g), g));
    float u = __fdiv_rn(__fdiv_rn(m, h.bc1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps));
    if (h.adam_w) u = __fadd_rn(u, __fmul_rn(h.wd, p));
    d = __fmul_rn(-h.lr, u);
    out[0] = m;
    out[1] = v;
  }
};

struct Adagrad {
  static constexpr int kIn = 1, kOut = 1;
  struct Hyp {
    float lr, eps, wd;
  };
  static __device__ __forceinline__ void apply(float g, float p, const float* in,
                                               float& d, float* out, const Hyp& h) {
    g = __fadd_rn(g, __fmul_rn(h.wd, p));
    const float s = __fadd_rn(in[0], __fmul_rn(g, g));
    d = __fdiv_rn(__fmul_rn(-h.lr, g), __fadd_rn(__fsqrt_rn(s), h.eps));
    out[0] = s;
  }
};

// in[1] is the per-element denominator (the tensor's sqrt(v / bc2) + eps)
struct NovoGrad {
  static constexpr int kIn = 2, kOut = 1;
  struct Hyp {
    float lr, b1, b3, wd, bc1;
  };
  static __device__ __forceinline__ void apply(float g, float p, const float* in,
                                               float& d, float* out, const Hyp& h) {
    const float scaled = __fadd_rn(__fdiv_rn(g, in[1]), __fmul_rn(h.wd, p));
    const float m = __fadd_rn(__fmul_rn(h.b1, in[0]), __fmul_rn(h.b3, scaled));
    d = __fdiv_rn(__fmul_rn(-h.lr, m), h.bc1);
    out[0] = m;
  }
};

struct Sgd {
  static constexpr int kIn = 1, kOut = 1;
  // 1 - dampening formed in fp32 by the caller
  struct Hyp {
    float lr, momentum, omd, wd;
    int first_run, nesterov, wd_after;
  };
  static __device__ __forceinline__ void apply(float g, float p, const float* in,
                                               float& d, float* out, const Hyp& h) {
    if (!h.wd_after) g = __fadd_rn(g, __fmul_rn(h.wd, p));
    const float mom = h.first_run
                          ? g
                          : __fadd_rn(__fmul_rn(h.momentum, in[0]), __fmul_rn(h.omd, g));
    float upd = h.nesterov ? __fadd_rn(g, __fmul_rn(h.momentum, mom)) : mom;
    if (h.wd_after) upd = __fadd_rn(upd, __fmul_rn(h.wd, p));
    d = __fmul_rn(-h.lr, upd);
    out[0] = mom;
  }
};

// the buffers of one call: state in (s0, s1) and out (o0, o1), the unused
// ones null
struct Bufs {
  const void* g;
  const void* p;
  const float* s0;
  const float* s1;
  void* delta;
  float* o0;
  float* o1;
};

template <typename Op, typename G, typename P, bool kVec>
__global__ void __launch_bounds__(kThreads)
update_kernel(const G* __restrict__ g, const P* __restrict__ p,
              const float* __restrict__ s0, const float* __restrict__ s1,
              P* __restrict__ delta, float* __restrict__ o0, float* __restrict__ o1,
              long long n, typename Op::Hyp h) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (kVec) {
    const long long n4 = n / 4;
    for (long long q = first; q < n4; q += stride) {
      const long long i = 4 * q;
      float gg[4], pp[4], a[4], b[4], dd[4], x[4], y[4];
      Vec4<G>::load(g + i, gg);
      Vec4<P>::load(p + i, pp);
      Vec4<float>::load(s0 + i, a);
      if constexpr (Op::kIn > 1) Vec4<float>::load(s1 + i, b);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float in[2] = {a[e], Op::kIn > 1 ? b[e] : 0.0f};
        float out[2] = {0.0f, 0.0f};
        Op::apply(gg[e], pp[e], in, dd[e], out, h);
        x[e] = out[0];
        y[e] = out[1];
      }
      Vec4<P>::store(delta + i, dd);
      Vec4<float>::store(o0 + i, x);
      if constexpr (Op::kOut > 1) Vec4<float>::store(o1 + i, y);
    }
    tail = 4 * n4;
  }
  for (long long i = tail + first; i < n; i += stride) {
    float in[2] = {s0[i], 0.0f};
    if constexpr (Op::kIn > 1) in[1] = s1[i];
    float out[2] = {0.0f, 0.0f};
    float d = 0.0f;
    Op::apply(to_f<G>(g[i]), to_f<P>(p[i]), in, d, out, h);
    delta[i] = from_f<P>(d);
    o0[i] = out[0];
    if constexpr (Op::kOut > 1) o1[i] = out[1];
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return ptr == nullptr || (reinterpret_cast<uintptr_t>(ptr) % bytes) == 0;
}

template <typename Op, typename G, typename P>
cudaError_t launch(const Bufs& b, long long n, const typename Op::Hyp& h,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const bool vec = aligned(b.g, 4 * sizeof(G)) && aligned(b.p, 4 * sizeof(P)) &&
                   aligned(b.delta, 4 * sizeof(P)) && aligned(b.s0, 16) &&
                   aligned(b.s1, 16) && aligned(b.o0, 16) && aligned(b.o1, 16);
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 8;  // 8 resident blocks of 256 per SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const G* g = static_cast<const G*>(b.g);
  const P* p = static_cast<const P*>(b.p);
  P* d = static_cast<P*>(b.delta);
  if (vec)
    update_kernel<Op, G, P, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        g, p, b.s0, b.s1, d, b.o0, b.o1, n, h);
  else
    update_kernel<Op, G, P, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        g, p, b.s0, b.s1, d, b.o0, b.o1, n, h);
  return cudaGetLastError();
}

template <typename Op, typename G>
cudaError_t launch_p(const Bufs& b, long long n, const typename Op::Hyp& h, int p_dtype,
                     cudaStream_t stream) {
  switch (p_dtype) {
    case 0:
      return launch<Op, G, float>(b, n, h, stream);
    case 1:
      return launch<Op, G, __nv_bfloat16>(b, n, h, stream);
    case 2:
      return launch<Op, G, __half>(b, n, h, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename Op>
cudaError_t dispatch(const Bufs& b, long long n, const typename Op::Hyp& h, int g_dtype,
                     int p_dtype, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g_dtype) {
    case 0:
      return launch_p<Op, float>(b, n, h, p_dtype, s);
    case 1:
      return launch_p<Op, __nv_bfloat16>(b, n, h, p_dtype, s);
    case 2:
      return launch_p<Op, __half>(b, n, h, p_dtype, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Every launcher: g (n,) of g_dtype, p (n,) of p_dtype, the fp32 state
// (n,) read, the delta (n,) of p_dtype and the new fp32 state (n,) written
// into buffers that alias no input.  dtype codes: 0 float32, 1 bfloat16,
// 2 float16.

// `_adam_kernel`: state m, v; omb1 = 1 - beta1, omb2 = 1 - beta2 in fp32;
// adam_w_mode 1: decoupled decay (AdamW), 0: L2 decay folded into g.
int apex_adam_update(const void* g, const void* p, const void* m, const void* v,
                     void* delta, void* m_out, void* v_out, long long n, float lr,
                     float beta1, float omb1, float beta2, float omb2, float eps,
                     float weight_decay, float bc1, float bc2, int adam_w_mode,
                     int g_dtype, int p_dtype, void* stream) {
  const Bufs b{g, p, static_cast<const float*>(m), static_cast<const float*>(v), delta,
               static_cast<float*>(m_out), static_cast<float*>(v_out)};
  const Adam::Hyp h{lr, beta1, omb1, beta2, omb2, eps, weight_decay, bc1, bc2,
                    adam_w_mode};
  return dispatch<Adam>(b, n, h, g_dtype, p_dtype, stream);
}

// `_adagrad_kernel`: state h, the accumulated squared gradients.
int apex_adagrad_update(const void* g, const void* p, const void* h, void* delta,
                        void* h_out, long long n, float lr, float eps,
                        float weight_decay, int g_dtype, int p_dtype, void* stream) {
  const Bufs b{g, p, static_cast<const float*>(h), nullptr, delta,
               static_cast<float*>(h_out), nullptr};
  const Adagrad::Hyp hy{lr, eps, weight_decay};
  return dispatch<Adagrad>(b, n, hy, g_dtype, p_dtype, stream);
}

// `_novograd_kernel`: state m and the per-element fp32 denominator (read
// only); beta3 = 1 - beta1 under grad averaging, else 1.
int apex_novograd_update(const void* g, const void* p, const void* m, const void* denom,
                         void* delta, void* m_out, long long n, float lr, float beta1,
                         float beta3, float weight_decay, float bc1, int g_dtype,
                         int p_dtype, void* stream) {
  const Bufs b{g, p, static_cast<const float*>(m), static_cast<const float*>(denom),
               delta, static_cast<float*>(m_out), nullptr};
  const NovoGrad::Hyp h{lr, beta1, beta3, weight_decay, bc1};
  return dispatch<NovoGrad>(b, n, h, g_dtype, p_dtype, stream);
}

// `_sgd_kernel`: state mom; omd = 1 - dampening in fp32; first_run 1:
// mom <- g (torch's first step).
int apex_sgd_update(const void* g, const void* p, const void* mom, void* delta,
                    void* mom_out, long long n, float lr, float momentum, float omd,
                    float weight_decay, int first_run, int nesterov,
                    int wd_after_momentum, int g_dtype, int p_dtype, void* stream) {
  const Bufs b{g, p, static_cast<const float*>(mom), nullptr, delta,
               static_cast<float*>(mom_out), nullptr};
  const Sgd::Hyp h{lr, momentum, omd, weight_decay, first_run, nesterov,
                   wd_after_momentum};
  return dispatch<Sgd>(b, n, h, g_dtype, p_dtype, stream);
}

}  // extern "C"
