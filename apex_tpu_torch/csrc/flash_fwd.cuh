// The flash-attention forward kernel for Hopper (sm_90a), shared by the
// launchers of `flash_attention.cu` (the (b, h, s, d), packed-qkv and E
// entries) and `flash_attention_partial.cu` (the partial entry): each
// instantiates the lanes its entries take, so a lane compiles only where it
// runs and adds no code to the others.  The design and what bounds it are
// described in `flash_attention.cu`.
#pragma once

#include "flash_common.cuh"
#include "flash_dropout.cuh"

namespace {

constexpr int kBQ = 64;  // q rows per block (kTPR threads each)
constexpr int kBK = 32;  // keys per shared-memory tile

// D: the head dim; kTPR: threads per q row (1 at d = 64, 2 at d = 128);
// kMask: the kv_mask lane (the unmasked instantiation has no mask code);
// kDrop: the dropout lane, a DropMode (likewise); kOff: the partial
// entry's lane, causal offsets (diag) and a finite dead-row lse (the
// other instantiations compile as if diag were 0)
template <typename T, int D, int kTPR, bool kMask, int kDrop, bool kOff>
__global__ void __launch_bounds__(kBQ * kTPR)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const float* __restrict__ kvm, int h,
                 int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os,
                 float scale, float a, int causal, int diag, float dead_lse,
                 Drop dr) {
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
  if constexpr (kDrop != kNoDrop) drow = drop_row<kDrop>(dr, bi, hi, row);
  const int last = kOff ? row + diag : row;  // causal: its last visible key

  // causal: keys past the tile's last row are in every row's future
  const int k_end =
      causal ? (kOff ? max(0, min(sk, q0 + kBQ + diag)) : min(sk, q0 + kBQ)) : sk;
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
      const bool ok = kp < sk && (!causal || kp <= last) && (!kMask || key_ok[jj]);
      s[jj] = ok ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[jj]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new == -INFINITY) continue;  // every key so far masked
    const float corr = exp2f((m - m_new) * a);
    float psum = 0.f;
    uint32_t x0 = 0;  // the hash counter of the tile's first key
    if constexpr (kDrop != kNoDrop) x0 = drop_counter<kDrop>(dr, drow, j0);
#pragma unroll
    for (int jj = 0; jj < kBK; ++jj) {
      const float p = exp2f((s[jj] - m_new) * a);  // masked: exp2(-inf) = 0
      psum += p;  // l sums the undropped p
      if constexpr (kDrop != kNoDrop)
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
    lse[(size_t)bh * sq + row] =
        (l > 0.f ? m * scale : (kOff ? dead_lse : -INFINITY)) + logf(safe_l);
}

// The arguments of one forward launch.
struct FwdArgs {
  const void *q, *k, *v;
  void *o, *lse;
  const float* kvm;  // null: no kv_mask
  int b, h, sq, sk, d;
  Strides qs, ks, vs, os;
  float scale;
  int causal, diag;  // diag: the kOff lane's q_off - k_off, in [-sq, sk]
  float dead_lse;    // the kOff lane's lse of a row that sees no key
  Drop dr;
  cudaStream_t stream;
};

// Launch the kernel Lanes<T, D, kTPR>::pick(a) chooses.
template <template <typename, int, int> class Lanes, typename T, int D, int kTPR>
cudaError_t launch_fwd_d(const FwdArgs& a) {
  const float alpha = a.scale * 1.4426950408889634f;  // scale * log2(e)
  const dim3 grid((a.sq + kBQ - 1) / kBQ, a.b * a.h);
  const auto kernel = Lanes<T, D, kTPR>::pick(a);
  kernel<<<grid, kBQ * kTPR, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), static_cast<float*>(a.lse),
      a.kvm, a.h, a.sq, a.sk, a.qs, a.ks, a.vs, a.os, a.scale, alpha, a.causal,
      a.diag, a.dead_lse, a.dr);
  return cudaGetLastError();
}

// The forward at a's head dim (64: a thread a row; 128: two) and dtype
// code (0 float32, 1 bfloat16, 2 float16).
template <template <typename, int, int> class Lanes>
cudaError_t launch_fwd(const FwdArgs& a, int dtype) {
  return by_dtype(dtype, [&](auto tag) -> cudaError_t {
    using T = decltype(tag);
    if (a.d == 64) return launch_fwd_d<Lanes, T, 64, 1>(a);
    if (a.d == 128) return launch_fwd_d<Lanes, T, 128, 2>(a);
    return cudaErrorInvalidValue;
  });
}

}  // namespace
