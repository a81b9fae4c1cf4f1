// The flash-attention forward kernels for Hopper (sm_90a), shared by the
// launchers of `flash_attention.cu` (the (b, h, s, d), packed-qkv and E
// entries) and `flash_attention_partial.cu` (the partial entry): each
// instantiates the lanes its entries take, so a lane compiles only where it
// runs and adds no code to the others.  bf16 and fp16 operands run the
// tensor-core kernel (`mma_fwd_kernel`); fp32 operands the fp32-pipe kernel
// (`flash_fwd_kernel`), since the tensor cores take fp32 only as TF32.  The
// design and what bounds it are described in `flash_attention.cu`.
#pragma once

#include "flash_common.cuh"
#include "flash_dropout.cuh"
#include "flash_mma.cuh"

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

constexpr int kFwdWalk = 64;  // keys a walked tile of the tensor-core kernel

// The forward on the tensor cores: one block a (b * h, 64-query tile), 4
// warps of 16 queries, walking the keys in 64-key tiles (two cp.async
// stages of K and V).  Per tile, a warp forms S = Q K^T for its 16 rows
// (fp32 accumulators), masks it at each element's `frag_col`, updates each
// row's running max m and sum l (the quad's 4 lanes share a row), rescales
// its o accumulator once and adds P V, P (after the dropout keep) split
// into terms that carry its fp32 value (three in bf16, hi + lo in fp16).
// The lanes as `flash_fwd_kernel`'s; with the kv_mask, a walked tile whose
// keys are all masked is neither loaded nor multiplied.  Blocks run the
// last query tiles first: under causal masking they walk the most keys.
template <typename T, int D, bool kMask, int kDrop, bool kOff>
__global__ void __launch_bounds__(kMmaThreads, 2)
mma_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, float* __restrict__ lse, const float* __restrict__ kvm,
               int h, int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os,
               float scale, float a, int causal, int diag, float dead_lse, Drop dr) {
  constexpr int P = pitch<D>();
  constexpr int kN = kFwdWalk;
  constexpr int NB = kN / 8;
  // the terms p enters P V as: all of fp32's 24 significand bits in bf16,
  // 22 in fp16
  constexpr int kPTerms = std::is_same<T, __half>::value ? 2 : 3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [kMmaRows][P]
  T* k_s = q_s + kMmaRows * P;              // [2][kN][P]
  T* v_s = k_s + 2 * kN * P;                // [2][kN][P]
  __shared__ bool km_s[kMask ? 2 * kN : 1];

  const int bh = blockIdx.y;
  const int bi = bh / h;
  const int hd = bh - bi * h;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kMmaRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int row0 = warp * 16;  // the warp's first query in the block
  const int rows[2] = {i0 + row0 + (lane >> 2), i0 + row0 + (lane >> 2) + 8};
  const int d0 = kOff ? diag : 0;
  int last[2];       // causal: each row's last visible key
  DropRow drow[2];   // each row's part of its pairs' hash
  float m[2], l[2];  // each row's running max of the raw scores, and the
                     // thread's part of its sum of exp2((s - m) a)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    last[hh] = rows[hh] + d0;
    if constexpr (kDrop != kNoDrop) drow[hh] = drop_row<kDrop>(dr, bi, hd, rows[hh]);
    m[hh] = -INFINITY;
    l[hh] = 0.f;
  }
  const T* kb = k + bi * ks.b + hd * ks.h;
  const T* vb = v + bi * vs.b + hd * vs.h;
  const float* mb = kMask ? kvm + (size_t)bi * sk : nullptr;

  // causal: keys past the tile's last query's are in every row's future
  const int k_end = causal ? max(0, min(sk, i0 + kMmaRows + d0)) : sk;
  // the first walked tile from j on that holds a kept key (its mask
  // staged into km_s[st]), or k_end; block-uniform
  auto next_tile = [&](int j, int st) {
    if constexpr (kMask) {
      for (; j < k_end; j += kN) {
        bool mine = false;
        if (threadIdx.x < kN) {
          mine = j + (int)threadIdx.x < sk && mb[j + threadIdx.x] > 0.f;
          km_s[st * kN + threadIdx.x] = mine;
        }
        if (__syncthreads_or(mine)) return j;
      }
      return k_end;
    }
    return j;
  };
  auto load_walk = [&](int j, int st) {
    load_rows<T, D, kN>(k_s + st * kN * P, kb, ks.s, j, sk);
    load_rows<T, D, kN>(v_s + st * kN * P, vb, vs.s, j, sk);
  };

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  int j0 = next_tile(0, 0);
  if (j0 < k_end) {
    load_rows<T, D, kMmaRows>(q_s, q + bi * qs.b + hd * qs.h, qs.s, i0, sq);
    load_walk(j0, 0);
  }
  cp_async_commit();
  int st = 0;
  while (j0 < k_end) {
    const int jn = next_tile(j0 + kN, st ^ 1);
    if (jn < k_end) load_walk(jn, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // stage st has landed
    __syncthreads();
    const T* kt = k_s + st * kN * P;
    const T* vt = v_s + st * kN * P;
    float sc[NB][4];
    scores<T, D, kN>(sc, q_s, kt, row0, lane);
    // a tile past the sequence's end, across the block's diagonal or under
    // the kv_mask has masked pairs; the others need no predicate
    const bool edge = kMask || j0 + kN > sk || (causal && j0 + kN - 1 > i0 + d0);
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < NB; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = frag_col(nt, t4, e);
          const int j = j0 + c;
          const bool ok = j < sk && (!causal || j <= last[e >> 1]) &&
                          (!kMask || km_s[st * kN + c]);
          if (!ok) sc[nt][e] = -INFINITY;
        }
    }
    float base[2], corr[2];  // each row's shift m a, and its rescale
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int nt = 0; nt < NB; ++nt)
        mx = fmaxf(mx, fmaxf(sc[nt][2 * hh], sc[nt][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row that has seen no key shifts by 0: its p are exp2(-inf) = 0
      base[hh] = mx == -INFINITY ? 0.f : mx * a;
      corr[hh] = exp2f(fmaf(m[hh], a, -base[hh]));
      m[hh] = mx;
    }
    uint32_t x0[2] = {0, 0};  // the hash counter of each row's pair with key j0
    if constexpr (kDrop != kNoDrop) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) x0[hh] = drop_counter<kDrop>(dr, drow[hh], j0);
    }
    float ps[2] = {0.f, 0.f};  // the undropped p the tile adds to l
#pragma unroll
    for (int nt = 0; nt < NB; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        float p = exp2f(fmaf(sc[nt][e], a, -base[hh]));
        ps[hh] += p;
        if constexpr (kDrop != kNoDrop)
          p = drop_keep(x0[hh] + (uint32_t)frag_col(nt, t4, e), dr.thr) ? p * dr.inv : 0.f;
        sc[nt][e] = p;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * corr[hh] + ps[hh];
    uint32_t pf[kN / 16][kPTerms][4];  // P's A fragments, each k-step's terms
#pragma unroll
    for (int kq = 0; kq < kN / 16; ++kq) a_frags_n<T, kPTerms>(pf[kq], sc, kq);
    accumulate_tile<T, D, kPTerms, kN / 16>(acc, corr, pf, vt, lane);
    __syncthreads();  // stage st is read; the next prefetch may take it
    j0 = jn;
    st ^= 1;
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    inv[hh] = l[hh] > 0.f ? 1.f / l[hh] : 0.f;  // a row that sees no key emits 0
  }
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] *= inv[e >> 1];
  store_rows<T, D>(o + bi * os.b + hd * os.h, os.s, acc, rows, sq, t4);
  if (t4 == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (rows[hh] < sq)
        lse[(size_t)bh * sq + rows[hh]] =
            l[hh] > 0.f ? m[hh] * scale + logf(l[hh]) : (kOff ? dead_lse : -INFINITY);
  }
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

// The tensor-core kernel's dynamic shared memory, in bytes: the block's
// [kMmaRows][pitch] q tile and two stages of the walked k and v tiles
template <typename T, int D>
constexpr int fwd_smem() {
  return (kMmaRows + 4 * kFwdWalk) * pitch<D>() * (int)sizeof(T);
}

// Launch the kernel the lanes choose: for fp32 operands
// Lanes<T, D, kTPR>::pick(a), for bf16 and fp16 the tensor-core lane
// Lanes<T, D, kTPR>::mma(a), whose views must hold q, k and v in rows of
// 16-byte chunks (cp.async) and o in 4-byte pairs (the fragments' stores).
template <template <typename, int, int> class Lanes, typename T, int D, int kTPR>
cudaError_t launch_fwd_d(const FwdArgs& a) {
  const float alpha = a.scale * 1.4426950408889634f;  // scale * log2(e)
  if constexpr (!std::is_same<T, float>::value) {
    if (!(rows_aligned<T>(a.q, a.qs, 16) && rows_aligned<T>(a.k, a.ks, 16) &&
          rows_aligned<T>(a.v, a.vs, 16) && rows_aligned<T>(a.o, a.os, 4)))
      return cudaErrorMisalignedAddress;
    const auto kernel = Lanes<T, D, kTPR>::mma(a);
    constexpr int bytes = fwd_smem<T, D>();
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid((a.sq + kMmaRows - 1) / kMmaRows, a.b * a.h);
    kernel<<<grid, kMmaThreads, bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.o), static_cast<float*>(a.lse),
        a.kvm, a.h, a.sq, a.sk, a.qs, a.ks, a.vs, a.os, a.scale, alpha, a.causal,
        a.diag, a.dead_lse, a.dr);
  } else {
    const dim3 grid((a.sq + kBQ - 1) / kBQ, a.b * a.h);
    const auto kernel = Lanes<T, D, kTPR>::pick(a);
    kernel<<<grid, kBQ * kTPR, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.o), static_cast<float*>(a.lse),
        a.kvm, a.h, a.sq, a.sk, a.qs, a.ks, a.vs, a.os, a.scale, alpha, a.causal,
        a.diag, a.dead_lse, a.dr);
  }
  return cudaGetLastError();
}

// The forward at a's head dim (64 or 128; the fp32 kernel's threads a row,
// kTPR, 1 or 2) and dtype code (0 float32, 1 bfloat16, 2 float16).
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
