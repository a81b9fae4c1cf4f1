// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: apex_tpu/ops/flash_attention.py `_flash_fwd` — both of its
// Pallas bodies, `_fwd_single_kernel` (the whole padded sequence in one
// block) and `_fwd_kernel` (the gridded online softmax) — for the
// (b, h, s, d) layout, causal or not, without offsets — and, through the
// E-layout entry, `_flash_fwd_e` (row 10) with its kv_mask lane
// (`_fwd_e_kernel`'s has_kvm): an optional (b, sk) fp32 key mask, a key
// attended where it is > 0 — and `_flash_fwd_e_blocked` (row 11), the E
// forward the JAX package streams in (512, 512) tiles once the padded
// sequence outgrows one VMEM block: this kernel walks keys in
// shared-memory tiles whatever s is, so the same launch serves it.
// The E forward's dropout lane (`_fwd_e_kernel`'s keep at :1913 and the
// blocked walk's at :2043) drops the unnormalized p of each (q, k) pair
// whose counter hash (`flash_dropout.cuh`, JAX's `_rand_keep`) falls under the
// rate, and scales the kept ones by 1 / (1 - rate); l sums the undropped
// p, as in JAX.
// It writes o in the input dtype and the fp32 per-row log-sum-exp
// (natural log) the backward will read.  A row with no attended key
// (every key masked, or under causal masking none at or before it)
// writes o = 0 and lse = -inf.  Head dim 64 or 128.
//
// What bounds it on the H100: operations, from a few hundred tokens on.
// Attention does 4 * d operations per (q, k) pair against 4 * d * 2
// bytes per row (q, k, v, o in bf16): about s / 2 operations per byte
// without a mask and s / 4 under causal masking, against the ~295 per
// byte where the bf16 tensor cores, not memory, become the limit.  So a
// full-attention prefill is bound by operations from s ~ 600, a causal
// one from s ~ 1200; the serve's longest causal prefill (s = 1024, d =
// 64) sits just under that balance, and at its peaks the card could
// finish it in ~2.5 us either way.  Below that the launch and the
// grid's fill dominate.
//
// What the simple design does about it: one block per (b*h, 64-row q
// tile).  At d = 64 one thread owns a q row, holding it and its fp32
// output accumulator in registers (128 floats).  At d = 128 that would
// be 256 floats, past the 255-register limit, so two threads share a
// row, each owning 64 of its dims (in float4 chunks interleaved with
// its partner's, so the pair reads different shared-memory banks), and
// a score is two partial dot products joined by one warp shuffle: the
// registers a thread holds are the d = 64 kernel's.  The block walks
// k/v in 32-key tiles staged through shared memory as fp32; every row
// reads the same key at the same time, so shared memory serves
// broadcasts only, and each key costs a row 2 * d fused multiply-adds.
// The online softmax (running max m, running sum l, rescale of the
// accumulator once per tile) keeps the (s, s) score matrix out of
// device memory, exactly as the Pallas kernel does, and under causal
// masking the loop stops at the tile's last row, so k tiles wholly
// above the diagonal are never loaded.  There is no separate
// single-block body: a sequence shorter than one tile is the same loop
// run once, and a ragged last tile is masked by position.
// With a kv_mask each staged tile also stages its keys' mask values, and
// a tile whose keys are all masked (BERT's padded tails) is skipped by
// the whole block (one __syncthreads_or): padding costs no products.
// This runs on the fp32 pipes, not the tensor cores: mma/wgmma tiles and
// TMA staging are later work.
// Dropout adds no memory traffic: each (q, k) pair's keep bit is hashed
// from the pair's global coordinates (about ten integer operations beside
// the pair's 3 * d fused multiply-adds), so the kernel's 32-key tiles need
// not match JAX's (ps, ps) or (512, 512) tiles, and the backward
// regenerates the same bits.  The lane is a template parameter: the
// dropout-free instantiations carry no hash code.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "flash_dropout.cuh"

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

constexpr int kBQ = 64;  // q rows per block (kTPR threads each)
constexpr int kBK = 32;  // keys per shared-memory tile

struct Strides {
  long long b, h, s;
};

// dims of a row owned by thread part t (of kTPR), in float4 chunks:
// chunk c is dims 4 * kTPR * c + 4 * t .. + 3 (contiguous at kTPR = 1)
template <int kTPR>
__device__ __forceinline__ int dim_of(int c, int t) { return 4 * kTPR * c + 4 * t; }

// D: the head dim; kTPR: threads per q row (1 at d = 64, 2 at d = 128);
// kMask: the kv_mask lane (the unmasked instantiation has no mask code);
// kDrop: the dropout lane (likewise)
template <typename T, int D, int kTPR, bool kMask, bool kDrop>
__global__ void __launch_bounds__(kBQ * kTPR)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const float* __restrict__ kvm, int h,
                 int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os,
                 float scale, float a, int causal, Drop dr) {
  constexpr int kThreads = kBQ * kTPR;
  constexpr int kOwn = D / kTPR;  // dims a thread owns
  __shared__ __align__(16) float k_tile[kBK][D];
  __shared__ __align__(16) float v_tile[kBK][D];
  __shared__ bool key_ok[kMask ? kBK : 1];

  const int bh = blockIdx.y;
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int q0 = blockIdx.x * kBQ;
  const int t = threadIdx.x % kTPR;
  const int row = q0 + threadIdx.x / kTPR;
  const bool live = row < sq;

  const T* qb = q + bi * qs.b + hi * qs.h;
  const T* kb = k + bi * ks.b + hi * ks.h;
  const T* vb = v + bi * vs.b + hi * vs.h;
  const float* mb = kMask ? kvm + (size_t)bi * sk : nullptr;

  float qr[kOwn];
  float acc[kOwn];
#pragma unroll
  for (int c = 0; c < kOwn / 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[4 * c + e] = live ? to_f<T>(qb[row * qs.s + dim_of<kTPR>(c, t) + e]) : 0.f;
      acc[4 * c + e] = 0.f;
    }
  float m = -INFINITY;  // running max of the raw logits
  float l = 0.f;        // running sum of exp2((s - m) * a)
  DropRow drow;         // the row's part of each pair's hash
  if constexpr (kDrop) drow = drop_row(dr, bi, hi, row);

  // causal: keys past the tile's last row are in every row's future
  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  for (int j0 = 0; j0 < k_end; j0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    if constexpr (kMask) {
      bool mine = false;
      if (threadIdx.x < kBK) {
        const int kp = j0 + threadIdx.x;
        mine = kp < sk && mb[kp] > 0.f;
        key_ok[threadIdx.x] = mine;
      }
      // every key of the tile masked: nothing to add
      if (!__syncthreads_or(mine)) continue;
    }
    for (int idx = threadIdx.x; idx < kBK * D; idx += kThreads) {
      const int jj = idx / D;
      const int d = idx - jj * D;
      const int kp = j0 + jj;
      float kv = 0.f, vv = 0.f;
      if (kp < sk) {
        kv = to_f<T>(kb[kp * ks.s + d]);
        vv = to_f<T>(vb[kp * vs.s + d]);
      }
      k_tile[jj][d] = kv;
      v_tile[jj][d] = vv;
    }
    __syncthreads();

    float s[kBK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kBK; ++jj) {
      float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
      for (int c = 0; c < kOwn / 4; ++c) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&k_tile[jj][dim_of<kTPR>(c, t)]);
        dot0 = fmaf(qr[4 * c], kk.x, dot0);
        dot1 = fmaf(qr[4 * c + 1], kk.y, dot1);
        dot0 = fmaf(qr[4 * c + 2], kk.z, dot0);
        dot1 = fmaf(qr[4 * c + 3], kk.w, dot1);
      }
      float dot = dot0 + dot1;
      // the row's partial dots, summed in the same order on every part
#pragma unroll
      for (int w = 1; w < kTPR; w <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, w);
      const int kp = j0 + jj;
      const bool ok = kp < sk && (!causal || kp <= row) && (!kMask || key_ok[jj]);
      s[jj] = ok ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[jj]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new == -INFINITY) continue;  // every key so far masked
    const float corr = exp2f((m - m_new) * a);
    float psum = 0.f;
    uint32_t x0 = 0;  // the hash counter of the tile's first key
    if constexpr (kDrop) x0 = drop_counter(dr, drow, j0);
#pragma unroll
    for (int jj = 0; jj < kBK; ++jj) {
      const float p = exp2f((s[jj] - m_new) * a);  // masked: exp2(-inf) = 0
      psum += p;  // l sums the undropped p
      if constexpr (kDrop)
        s[jj] = drop_keep(x0 + (uint32_t)jj, dr.thr) ? p * dr.inv : 0.f;
      else
        s[jj] = p;
    }
    l = l * corr + psum;
#pragma unroll
    for (int e = 0; e < kOwn; ++e) acc[e] *= corr;
#pragma unroll
    for (int jj = 0; jj < kBK; ++jj) {
      const float p = s[jj];
#pragma unroll
      for (int c = 0; c < kOwn / 4; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&v_tile[jj][dim_of<kTPR>(c, t)]);
        acc[4 * c] = fmaf(p, vv.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
  }

  if (!live) return;
  const float safe_l = l > 0.f ? l : 1.f;  // a fully masked row emits 0
  const float inv = 1.f / safe_l;
  T* ob = o + bi * os.b + hi * os.h + row * os.s;
#pragma unroll
  for (int c = 0; c < kOwn / 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ob[dim_of<kTPR>(c, t) + e] = from_f<T>(acc[4 * c + e] * inv);
  if (t == 0)
    lse[(size_t)bh * sq + row] = (l > 0.f ? m * scale : -INFINITY) + logf(safe_l);
}

template <typename T, int D, int kTPR>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, void* lse,
                     const float* kvm, int b, int h, int sq, int sk, Strides qs,
                     Strides ks, Strides vs, Strides os, float scale, int causal,
                     Drop dr, cudaStream_t stream) {
  const float a = scale * 1.4426950408889634f;  // scale * log2(e)
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  auto kernel = kvm ? (dr.thr ? flash_fwd_kernel<T, D, kTPR, true, true>
                              : flash_fwd_kernel<T, D, kTPR, true, false>)
                    : (dr.thr ? flash_fwd_kernel<T, D, kTPR, false, true>
                              : flash_fwd_kernel<T, D, kTPR, false, false>);
  kernel<<<grid, kBQ * kTPR, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), kvm, h, sq, sk, qs, ks, vs, os,
      scale, a, causal, dr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   const float* kvm, int b, int h, int sq, int sk, int d, Strides qs,
                   Strides ks, Strides vs, Strides os, float scale, int causal,
                   Drop dr, cudaStream_t stream) {
  if (d == 64)
    return launch_d<T, 64, 1>(q, k, v, o, lse, kvm, b, h, sq, sk, qs, ks, vs, os, scale,
                              causal, dr, stream);
  if (d == 128)
    return launch_d<T, 128, 2>(q, k, v, o, lse, kvm, b, h, sq, sk, qs, ks, vs, os,
                               scale, causal, dr, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (b, h, sq, d), k/v (b, h, sk, d), o (b, h, sq, d) given by element
// strides over (b, h, s) with a unit stride on d; lse (b, h, sq) fp32
// contiguous; kvm null, or the (b, sk) fp32 key mask, contiguous.  dtype
// codes: 0 float32, 1 bfloat16, 2 float16.  d = 64 or 128.  Dropout
// (`flash_dropout.cuh`): drop_thr 0 runs none; else drop_seed >= 0, the
// hash's row stride and tile drop_w, a multiple of 32 or at least sq and
// sk, and drop_inv = float32(1 / (1 - rate)).
int apex_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, const void* kvm, int b, int h, int sq,
                             int sk, int d,
                             long long q_sb, long long q_sh, long long q_ss,
                             long long k_sb, long long k_sh, long long k_ss,
                             long long v_sb, long long v_sh, long long v_ss,
                             long long o_sb, long long o_sh, long long o_ss,
                             float scale, int causal, int drop_seed, int drop_w,
                             int drop_thr, float drop_inv, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0 || sk <= 0 || b * h > 65535)
    return cudaErrorInvalidValue;
  Drop dr;
  if (!make_drop(drop_seed, drop_w, drop_thr, drop_inv, sq, sk, &dr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(kvm);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, o, lse, m, b, h, sq, sk, d, qs, ks, vs, os, scale,
                           causal, dr, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, o, lse, m, b, h, sq, sk, d, qs, ks, vs, os,
                                   scale, causal, dr, s);
    case 2:
      return launch<__half>(q, k, v, o, lse, m, b, h, sq, sk, d, qs, ks, vs, os, scale,
                            causal, dr, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
