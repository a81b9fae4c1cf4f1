// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: apex_tpu/ops/flash_attention.py `_flash_fwd` — both of its
// Pallas bodies, `_fwd_single_kernel` (the whole padded sequence in one
// block) and `_fwd_kernel` (the gridded online softmax) — for the
// (b, h, s, d) layout, causal or not, without kv_mask, offsets or
// dropout.  It writes o in the input dtype and the fp32 per-row
// log-sum-exp (natural log) the backward will read.
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
// tile), one thread per q row holding its q row and its fp32 output
// accumulator in registers.  The block walks k/v in 32-key tiles staged
// through shared memory as fp32; every thread reads the same key at the
// same time, so shared memory serves broadcasts only, and each key costs
// a thread 2 * d fused multiply-adds.  The online softmax (running max
// m, running sum l, rescale of the accumulator once per tile) keeps the
// (s, s) score matrix out of device memory, exactly as the Pallas kernel
// does, and under causal masking the loop stops at the tile's last row,
// so k tiles wholly above the diagonal are never loaded.  There is no
// separate single-block body: a sequence shorter than one tile is the
// same loop run once, and a ragged last tile is masked by position.
// This runs on the fp32 pipes, not the tensor cores: mma/wgmma tiles and
// TMA staging are later work.
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

constexpr int kBQ = 64;  // q rows per block = threads per block
constexpr int kBK = 32;  // keys per shared-memory tile

struct Strides {
  long long b, h, s;
};

template <typename T, int D>
__global__ void __launch_bounds__(kBQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int h, int sq, int sk, Strides qs,
                 Strides ks, Strides vs, Strides os, float scale, float a,
                 int causal) {
  __shared__ __align__(16) float k_tile[kBK][D];
  __shared__ __align__(16) float v_tile[kBK][D];

  const int bh = blockIdx.y;
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int q0 = blockIdx.x * kBQ;
  const int row = q0 + threadIdx.x;
  const bool live = row < sq;

  const T* qb = q + bi * qs.b + hi * qs.h;
  const T* kb = k + bi * ks.b + hi * ks.h;
  const T* vb = v + bi * vs.b + hi * vs.h;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? to_f<T>(qb[row * qs.s + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;  // running max of the raw logits
  float l = 0.f;        // running sum of exp2((s - m) * a)

  // causal: keys past the tile's last row are in every row's future
  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  for (int j0 = 0; j0 < k_end; j0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < kBK * D; idx += kBQ) {
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
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_tile[jj][d]);
        dot0 = fmaf(qr[d], kk.x, dot0);
        dot1 = fmaf(qr[d + 1], kk.y, dot1);
        dot0 = fmaf(qr[d + 2], kk.z, dot0);
        dot1 = fmaf(qr[d + 3], kk.w, dot1);
      }
      const int kp = j0 + jj;
      const bool ok = kp < sk && (!causal || kp <= row);
      s[jj] = ok ? dot0 + dot1 : -INFINITY;
      tile_max = fmaxf(tile_max, s[jj]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new == -INFINITY) continue;  // every key so far masked
    const float corr = exp2f((m - m_new) * a);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kBK; ++jj) {
      const float p = exp2f((s[jj] - m_new) * a);  // masked: exp2(-inf) = 0
      s[jj] = p;
      psum += p;
    }
    l = l * corr + psum;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int jj = 0; jj < kBK; ++jj) {
      const float p = s[jj];
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_tile[jj][d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
  }

  if (!live) return;
  const float safe_l = l > 0.f ? l : 1.f;  // a fully masked row emits 0
  const float inv = 1.f / safe_l;
  T* ob = o + bi * os.b + hi * os.h + row * os.s;
#pragma unroll
  for (int d = 0; d < D; ++d) ob[d] = from_f<T>(acc[d] * inv);
  lse[(size_t)bh * sq + row] = (l > 0.f ? m * scale : -INFINITY) + logf(safe_l);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int b, int h, int sq, int sk, int d, Strides qs, Strides ks,
                   Strides vs, Strides os, float scale, int causal,
                   cudaStream_t stream) {
  const float a = scale * 1.4426950408889634f;  // scale * log2(e)
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  if (d == 64) {
    flash_fwd_kernel<T, 64><<<grid, kBQ, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
        h, sq, sk, qs, ks, vs, os, scale, a, causal);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (b, h, sq, d), k/v (b, h, sk, d), o (b, h, sq, d) given by element
// strides over (b, h, s) with a unit stride on d; lse (b, h, sq) fp32
// contiguous.  dtype codes: 0 float32, 1 bfloat16, 2 float16.  d = 64.
int apex_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int b, int h, int sq, int sk, int d,
                             long long q_sb, long long q_sh, long long q_ss,
                             long long k_sb, long long k_sh, long long k_ss,
                             long long v_sb, long long v_sh, long long v_ss,
                             long long o_sb, long long o_sh, long long o_ss,
                             float scale, int causal, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0 || sk <= 0 || b * h > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, o, lse, b, h, sq, sk, d, qs, ks, vs, os, scale,
                           causal, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, o, lse, b, h, sq, sk, d, qs, ks, vs, os,
                                   scale, causal, s);
    case 2:
      return launch<__half>(q, k, v, o, lse, b, h, sq, sk, d, qs, ks, vs, os, scale,
                            causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
