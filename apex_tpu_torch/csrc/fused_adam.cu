// Adam for Hopper (sm_90a), plain C interface: the pipeline sweep and the
// staged step over a table of leaves.
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
//
// Also replaces `_adam_step_kernel` (`adam_step`, fused_optim.py:196-246),
// the per-leaf step of the staged amp route: the same Adam or AdamW update
// on each leaf with no scale and no skip (amp unscales before and skips
// around it), writing p, m, v in place and the model-dtype copy.  p is an
// fp32 master, or (the policies without master weights, O3's fp16) the
// bf16/fp16 parameter itself: read into fp32, stepped by the same fp32
// body, rounded back once into its dtype, with no copy, as JAX's kernel
// writes `p_new.astype(p.dtype)`; m and v stay fp32.  Its
// every operation is written with an explicit round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn) in the order of the plain
// PyTorch version (apex_tpu_torch/ops/fused_optim.py), so nvcc contracts
// nothing into an FMA and the two agree bit for bit; the pipeline sweep
// keeps its plain expressions (held to 1e-6).  SGD's bodies are
// csrc/fused_sgd.cu; LAMB phase 1 csrc/fused_lamb.cu.
//
// What bounds it on the H100: bytes.  About 20 operations per element
// against 28 bytes moved (2 for a bf16 g, 12 read and 12 written for p,
// m, v, 2 for the bf16 copy): one stream with no reuse, ~3 ms at
// 3.35 TB/s for GPT-345M's 355M elements.
//
// What the design does about it: one pass, each element read and written
// exactly once, with 16-byte loads of p/m/v and 8-byte loads of a 16-bit
// g (a scalar loop takes over when a pointer is not aligned for that, and
// for the tail).  The sweep: four elements a thread an iteration, a
// grid-stride loop over a grid sized to fill the card.  The step: one
// launch walks a table of leaves, one block a chunk of a leaf, kUnroll
// vectors in flight a thread, as csrc/fused_sgd.cu's step does (the
// reasons are there).  Math is fp32 in the order of the JAX kernel.
#include "optim_step.cuh"

namespace {

struct Hyp {
  float lr, b1, b2, eps, wd, bc1, bc2, gscale, keep;
};

// the step's: 1 - beta1 and 1 - beta2 formed in fp32 by the caller;
// adam_w 1: decoupled decay (AdamW), 0: L2 decay folded into g
struct StepHyp {
  float lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2;
  int adam_w;
};

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

// one element of the per-leaf step (`_adam_step_kernel`), every operation
// rounded in the plain version's order
__device__ __forceinline__ void adam_step_one(float g, float& p, float& m, float& v,
                                              const StepHyp& h, bool adam_w) {
  if (!adam_w) g = __fadd_rn(g, __fmul_rn(h.wd, p));
  const float m_new = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  const float v_new = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  float upd = __fdiv_rn(__fdiv_rn(m_new, h.bc1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(v_new, h.bc2)), h.eps));
  if (adam_w) upd = __fadd_rn(upd, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, upd));
  m = m_new;
  v = v_new;
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

// The leaf-table step (optim_step.cuh): a leaf's g, p, m, v, lowp
using AdamTable = StepTable<StepHyp, 5>;
static_assert(sizeof(AdamTable) <= kParamBytes, "the Adam leaf table outgrows its budget");

// Block b steps one chunk of one leaf, as `sgd_leaves_kernel` does
// (csrc/fused_sgd.cu); P the stepped tensor's type (float: a master)
template <typename G, typename L, typename P>
__global__ void __launch_bounds__(kThreads)
adam_leaves_kernel(const __grid_constant__ AdamTable t) {
  const bool adam_w = t.h.adam_w != 0;
  const int l = leaf_of(t, blockIdx.x);
  const long long c0 = (long long)(blockIdx.x - t.start[l]) * t.chunk;
  const long long rest = t.n[l] - c0;
  const int len = rest < t.chunk ? (int)rest : t.chunk;
  const G* g = static_cast<const G*>(t.ptr[0][l]) + c0;
  P* p = static_cast<P*>(t.ptr[1][l]) + c0;
  float* m = static_cast<float*>(t.ptr[2][l]) + c0;
  float* v = static_cast<float*>(t.ptr[3][l]) + c0;
  L* lowp = t.ptr[4][l] == nullptr ? nullptr : static_cast<L*>(t.ptr[4][l]) + c0;
  int tail = 0;
  if (t.vec[l]) {
    const int nv = len / 4;
    for (int base = 0; base < nv; base += kThreads * kUnroll) {
      float gg[kUnroll][4], pp[kUnroll][4], mm[kUnroll][4], vv[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = base + u * kThreads + threadIdx.x;
        if (q < nv) {
          Vec4<G>::load(g + 4 * q, gg[u]);
          Vec4<P>::load(p + 4 * q, pp[u]);
          Vec4<float>::load(m + 4 * q, mm[u]);
          Vec4<float>::load(v + 4 * q, vv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = base + u * kThreads + threadIdx.x;
        if (q < nv) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            adam_step_one(gg[u][e], pp[u][e], mm[u][e], vv[u][e], t.h, adam_w);
          Vec4<P>::store(p + 4 * q, pp[u]);
          Vec4<float>::store(m + 4 * q, mm[u]);
          Vec4<float>::store(v + 4 * q, vv[u]);
          if (lowp != nullptr) Vec4<L>::store(lowp + 4 * q, pp[u]);
        }
      }
    }
    tail = 4 * nv;
  }
  for (int i = tail + threadIdx.x; i < len; i += kThreads) {
    float pp = to_f<P>(p[i]), mm = m[i], vv = v[i];
    adam_step_one(to_f<G>(g[i]), pp, mm, vv, t.h, adam_w);
    p[i] = from_f<P>(pp);
    m[i] = mm;
    v[i] = vv;
    if (lowp != nullptr) lowp[i] = from_f<L>(pp);
  }
}

template <typename G, typename L>
cudaError_t launch_pipeline(const void* g, void* p, void* m, void* v, void* lowp,
                            long long n, const Hyp& h, int adam_w, cudaStream_t stream) {
  const bool vec = aligned(g, 4 * sizeof(G)) && aligned(p, 16) && aligned(m, 16) &&
                   aligned(v, 16) && aligned(lowp, 4 * sizeof(L));
  long long blocks = 0;
  const cudaError_t e = grid_for(vec ? (n + 3) / 4 : n, &blocks);
  if (e != cudaSuccess) return e;
  const G* gp = static_cast<const G*>(g);
  float* pp = static_cast<float*>(p);
  float* mp = static_cast<float*>(m);
  float* vp = static_cast<float*>(v);
  L* lp = static_cast<L*>(lowp);
  if (vec)
    adam_pipeline_kernel<G, L, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        gp, pp, mp, vp, lp, n, h, adam_w);
  else
    adam_pipeline_kernel<G, L, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        gp, pp, mp, vp, lp, n, h, adam_w);
  return cudaGetLastError();
}

template <typename G, typename L, typename P>
cudaError_t launch_leaves(const long long* ptrs, const long long* ns, int count,
                          int chunk, const StepHyp& h, cudaStream_t stream) {
  AdamTable t{};
  t.h = h;
  const int width[5] = {4 * (int)sizeof(G), 4 * (int)sizeof(P), 16, 16,
                        4 * (int)sizeof(L)};
  const cudaError_t e = fill_table(t, ptrs, ns, count, chunk, kHasLowp<L>, width);
  if (e != cudaSuccess) return e;
  if (t.start[count] == 0) return cudaSuccess;
  adam_leaves_kernel<G, L, P><<<t.start[count], kThreads, 0, stream>>>(t);
  return cudaGetLastError();
}

// g's type for the lane of a bf16/fp16 stepped tensor P (no copy)
template <typename P>
cudaError_t launch_lowp_leaves(int g_dtype, const long long* ptrs, const long long* ns,
                               int count, int chunk, const StepHyp& h,
                               cudaStream_t stream) {
  switch (g_dtype) {
    case 0: return launch_leaves<float, float, P>(ptrs, ns, count, chunk, h, stream);
    case 1: return launch_leaves<__nv_bfloat16, float, P>(ptrs, ns, count, chunk, h, stream);
    case 2: return launch_leaves<__half, float, P>(ptrs, ns, count, chunk, h, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// g (n,) of g_dtype; p, m, v (n,) fp32, updated in place; lowp (n,) of
// lowp_dtype (1 bfloat16, 2 float16), or 0 and null for an fp32 group
// whose master is the model copy.  The nine hyperparameters are those of
// `_adam_pipeline_kernel`: lr, beta1, beta2, eps, weight_decay, the bias
// corrections bc1 and bc2, gscale, and keep (> 0.5 steps, else the state
// stays as it was).  adam_w_mode 1: decoupled decay (AdamW), 0: L2 decay
// folded into g.  dtype codes: 0 float32, 1 bfloat16, 2 float16.
int apex_adam_pipeline(const void* g, void* p, void* m, void* v, void* lowp,
                       long long n, float lr, float beta1, float beta2, float eps,
                       float weight_decay, float bc1, float bc2, float gscale,
                       float keep, int adam_w_mode, int g_dtype, int lowp_dtype,
                       void* stream) {
  if (n < 0 || (lowp != nullptr) != (lowp_dtype != 0)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const Hyp h{lr, beta1, beta2, eps, weight_decay, bc1, bc2, gscale, keep};
  return with_types(g_dtype, lowp_dtype, [&](auto* gt, auto* lt) {
    using G = std::remove_pointer_t<decltype(gt)>;
    using L = std::remove_pointer_t<decltype(lt)>;
    return launch_pipeline<G, L>(g, p, m, v, lowp, n, h, adam_w_mode,
                                 static_cast<cudaStream_t>(stream));
  });
}

// The leaves one `apex_adam_step_leaves` launch takes.
int apex_adam_step_capacity() { return AdamTable::kCap; }

// The step (`_adam_step_kernel`) over `count` leaves in one launch: ptrs
// (count, 5) int64 rows of g, p, m, v, lowp; ns (count,) int64 lengths;
// the buffers as above, no scale and no skip; chunk: elements a block, a
// multiple of 4; omb1 = 1 - beta1 and omb2 = 1 - beta2 formed in fp32 by
// the caller, as the plain version forms them.  p_dtype 0: p is the fp32
// master; 1 bfloat16, 2 float16: p is the parameter itself, stepped in
// fp32 and rounded back, with no copy (lowp_dtype 0, every lowp null).
int apex_adam_step_leaves(const void* ptrs, const void* ns, int count, int chunk,
                          float lr, float beta1, float omb1, float beta2, float omb2,
                          float eps, float weight_decay, float bc1, float bc2,
                          int adam_w_mode, int g_dtype, int lowp_dtype, int p_dtype,
                          void* stream) {
  const StepHyp h{lr, beta1, omb1, beta2, omb2, eps, weight_decay, bc1, bc2, adam_w_mode};
  const long long* rows = static_cast<const long long*>(ptrs);
  const long long* lens = static_cast<const long long*>(ns);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p_dtype != 0 && lowp_dtype != 0) return cudaErrorInvalidValue;
  switch (p_dtype) {
    case 0: break;
    case 1: return launch_lowp_leaves<__nv_bfloat16>(g_dtype, rows, lens, count, chunk, h, st);
    case 2: return launch_lowp_leaves<__half>(g_dtype, rows, lens, count, chunk, h, st);
    default: return cudaErrorInvalidValue;
  }
  return with_types(g_dtype, lowp_dtype, [&](auto* gt, auto* lt) {
    using G = std::remove_pointer_t<decltype(gt)>;
    using L = std::remove_pointer_t<decltype(lt)>;
    return launch_leaves<G, L, float>(rows, lens, count, chunk, h, st);
  });
}

}  // extern "C"
