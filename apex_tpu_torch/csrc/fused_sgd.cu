// Momentum SGD for Hopper (sm_90a), plain C interface: the staged step
// over a table of leaves and the packed-pipeline sweep.
//
// Replaces: apex_tpu/ops/fused_optim.py `_elementwise_call` running
// `_sgd_step_kernel` (`sgd_step`, :368-416) and
// apex_tpu/ops/fused_pipeline.py `_sgd_pipeline_kernel` (`sgd_pipeline`,
// :409-479) — two SGD bodies of row 19 of the kernel table.  Over each
// leaf (the step) or one flat buffer (the sweep) they read the gradient g
// (bf16, fp16 or fp32), the fp32 master p and the fp32 momentum buffer,
// and compute in fp32
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
// What the design does about it: every element read and written once.
// The step walks many leaves in one launch (JAX traces its per-leaf loop
// into one program; Apex's multi_tensor_apply walks a table the same
// way): a leaf table in the parameter block (optim_step.cuh), one block a
// chunk of a leaf, so ResNet-50's 161 leaves, 106 of them batch-norm
// vectors of 64-2048 elements, fill the card in two or three launches
// instead of 161 launches of one or two blocks.  A thread keeps kUnroll
// 16-byte loads of p and mom (and of an fp32 g; 8 bytes of a 16-bit g)
// in flight; a leaf not aligned for them takes a scalar loop.  The
// pipeline sweep is one flat buffer: four elements a thread an iteration
// and a grid-stride loop over a grid sized to fill the card.
#include "optim_step.cuh"

namespace {

// lr, momentum, 1 - dampening (formed in fp32 by the caller), weight
// decay; the three flags
struct Hyp {
  float lr, momentum, omd, wd;
  int first_run, nesterov, wd_after;
};

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

// The pipeline sweep: g * *gscale, the select by *keep
template <typename G, typename L, bool kVec>
__global__ void __launch_bounds__(kThreads)
sgd_kernel(const G* __restrict__ g, float* __restrict__ p, float* __restrict__ mom,
           L* __restrict__ lowp, long long n, Hyp h, const float* __restrict__ gscale,
           const float* __restrict__ keep_flag) {
  const float gs = *gscale;
  const bool keep = *keep_flag > 0.5f;
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
      for (int e = 0; e < 4; ++e) sgd_one(__fmul_rn(gg[e], gs), pp[e], mm[e], h, keep);
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
    sgd_one(__fmul_rn(to_f<G>(g[i]), gs), pp, mm, h, keep);
    if (keep) {
      p[i] = pp;
      mom[i] = mm;
    }
    if (lowp != nullptr) lowp[i] = from_f<L>(pp);
  }
}

// The leaf-table step (optim_step.cuh): a leaf's g, p, mom, lowp
using SgdTable = StepTable<Hyp, 4>;
static_assert(sizeof(SgdTable) <= kParamBytes, "the SGD leaf table outgrows its budget");

// Block b steps one chunk of one leaf.  Its threads load kUnroll vectors
// each before computing any; a leaf whose pointers are not all aligned
// for the vectors (the flag, one value for the whole block) and the
// chunk's last 0-3 elements take the scalar loop.
template <typename G, typename L>
__global__ void __launch_bounds__(kThreads)
sgd_leaves_kernel(const __grid_constant__ SgdTable t) {
  const int l = leaf_of(t, blockIdx.x);
  const long long c0 = (long long)(blockIdx.x - t.start[l]) * t.chunk;
  const long long rest = t.n[l] - c0;
  const int len = rest < t.chunk ? (int)rest : t.chunk;
  const G* g = static_cast<const G*>(t.ptr[0][l]) + c0;
  float* p = static_cast<float*>(t.ptr[1][l]) + c0;
  float* mom = static_cast<float*>(t.ptr[2][l]) + c0;
  L* lowp = t.ptr[3][l] == nullptr ? nullptr : static_cast<L*>(t.ptr[3][l]) + c0;
  int tail = 0;
  if (t.vec[l]) {
    const int nv = len / 4;
    for (int base = 0; base < nv; base += kThreads * kUnroll) {
      float gg[kUnroll][4], pp[kUnroll][4], mm[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = base + u * kThreads + threadIdx.x;
        if (q < nv) {
          Vec4<G>::load(g + 4 * q, gg[u]);
          Vec4<float>::load(p + 4 * q, pp[u]);
          Vec4<float>::load(mom + 4 * q, mm[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = base + u * kThreads + threadIdx.x;
        if (q < nv) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sgd_one(gg[u][e], pp[u][e], mm[u][e], t.h, true);
          Vec4<float>::store(p + 4 * q, pp[u]);
          Vec4<float>::store(mom + 4 * q, mm[u]);
          if (lowp != nullptr) Vec4<L>::store(lowp + 4 * q, pp[u]);
        }
      }
    }
    tail = 4 * nv;
  }
  for (int i = tail + threadIdx.x; i < len; i += kThreads) {
    float pp = p[i], mm = mom[i];
    sgd_one(to_f<G>(g[i]), pp, mm, t.h, true);
    p[i] = pp;
    mom[i] = mm;
    if (lowp != nullptr) lowp[i] = from_f<L>(pp);
  }
}

template <typename G, typename L>
cudaError_t launch_pipeline(const void* g, void* p, void* mom, void* lowp, long long n,
                            const Hyp& h, const float* gscale, const float* keep,
                            cudaStream_t stream) {
  const bool vec = aligned(g, 4 * sizeof(G)) && aligned(p, 16) && aligned(mom, 16) &&
                   aligned(lowp, 4 * sizeof(L));
  long long blocks = 0;
  const cudaError_t e = grid_for(vec ? (n + 3) / 4 : n, &blocks);
  if (e != cudaSuccess) return e;
  if (vec)
    sgd_kernel<G, L, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const G*>(g), static_cast<float*>(p), static_cast<float*>(mom),
        static_cast<L*>(lowp), n, h, gscale, keep);
  else
    sgd_kernel<G, L, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const G*>(g), static_cast<float*>(p), static_cast<float*>(mom),
        static_cast<L*>(lowp), n, h, gscale, keep);
  return cudaGetLastError();
}

template <typename G, typename L>
cudaError_t launch_leaves(const long long* ptrs, const long long* ns, int count,
                          int chunk, const Hyp& h, cudaStream_t stream) {
  SgdTable t{};
  t.h = h;
  const int width[4] = {4 * (int)sizeof(G), 16, 16, 4 * (int)sizeof(L)};
  const cudaError_t e = fill_table(t, ptrs, ns, count, chunk, kHasLowp<L>, width);
  if (e != cudaSuccess) return e;
  if (t.start[count] == 0) return cudaSuccess;
  sgd_leaves_kernel<G, L><<<t.start[count], kThreads, 0, stream>>>(t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// The leaves one `apex_sgd_step_leaves` launch takes.
int apex_sgd_step_capacity() { return SgdTable::kCap; }

// The step (`_sgd_step_kernel`) over `count` leaves in one launch: ptrs
// (count, 4) int64 rows of g, p, mom, lowp; ns (count,) int64 lengths.
// g of g_dtype; p, mom fp32, updated in place; lowp of lowp_dtype (1
// bfloat16, 2 float16), or 0 and every lowp null where the master is the
// model copy.  chunk: elements a block, a multiple of 4.  omd is 1 -
// dampening in fp32.  first_run 1: mom <- g (torch's first step).  dtype
// codes: 0 float32, 1 bfloat16, 2 float16.
int apex_sgd_step_leaves(const void* ptrs, const void* ns, int count, int chunk, float lr,
                         float momentum, float omd, float weight_decay, int first_run,
                         int nesterov, int wd_after_momentum, int g_dtype, int lowp_dtype,
                         void* stream) {
  const Hyp h{lr, momentum, omd, weight_decay, first_run, nesterov, wd_after_momentum};
  return with_types(g_dtype, lowp_dtype, [&](auto* gt, auto* lt) {
    using G = std::remove_pointer_t<decltype(gt)>;
    using L = std::remove_pointer_t<decltype(lt)>;
    return launch_leaves<G, L>(static_cast<const long long*>(ptrs),
                               static_cast<const long long*>(ns), count, chunk, h,
                               static_cast<cudaStream_t>(stream));
  });
}

// The pipeline sweep (`_sgd_pipeline_kernel`): the step above on one flat
// buffer of n elements, g scaled by *gscale, with p and mom kept as they
// were unless *keep > 0.5; gscale and keep are fp32 scalars in device
// memory.
int apex_sgd_pipeline(const void* g, void* p, void* mom, void* lowp, const void* gscale,
                      const void* keep, long long n, float lr, float momentum, float omd,
                      float weight_decay, int first_run, int nesterov,
                      int wd_after_momentum, int g_dtype, int lowp_dtype, void* stream) {
  if (gscale == nullptr || keep == nullptr || n < 0 || (lowp != nullptr) != (lowp_dtype != 0))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const Hyp h{lr, momentum, omd, weight_decay, first_run, nesterov, wd_after_momentum};
  return with_types(g_dtype, lowp_dtype, [&](auto* gt, auto* lt) {
    using G = std::remove_pointer_t<decltype(gt)>;
    using L = std::remove_pointer_t<decltype(lt)>;
    return launch_pipeline<G, L>(g, p, mom, lowp, n, h, static_cast<const float*>(gscale),
                                 static_cast<const float*>(keep),
                                 static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
