// The flash-attention backward kernels for Hopper (sm_90a), shared by the
// launchers of `flash_attention_bwd.cu` (the (b, h, s, d), packed-qkv and E
// entries) and `flash_attention_partial.cu` (the partial entry): each
// instantiates the lanes its entries take.  bf16 and fp16 operands run the
// tensor-core passes (`mma_dkv_kernel`, `mma_dq_kernel`); fp32 operands
// the fp32-pipe passes (`bwd_dkv_body`, `bwd_dq_kernel`), since the tensor
// cores take fp32 only as TF32.  The math, the three passes, the rounding
// points and what bounds them are described in `flash_attention_bwd.cu`.
#pragma once

#include <type_traits>

#include "flash_common.cuh"
#include "flash_dropout.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int kTile = 64;      // keys (dK/dV) or queries (dQ) per block
constexpr int kOwn = 16;       // dims a thread owns (D / kTPR)
constexpr int kSub = 32;       // rows per staged shared-memory tile
constexpr float kLog2e = 1.4426950408889634f;

// threads per row at head dim D: D / kOwn
template <int D> __host__ __device__ constexpr int tpr() { return D / kOwn; }

template <typename T, int kTPR>
__device__ __forceinline__ void load_own(const T* row, int t, float* out) {
#pragma unroll
  for (int c = 0; c < kOwn / 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[4 * c + e] = to_f<T>(row[dim_of<kTPR>(c, t) + e]);
}

template <typename T, int kTPR>
__device__ __forceinline__ void store_own(T* row, int t, const float* in) {
#pragma unroll
  for (int c = 0; c < kOwn / 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) row[dim_of<kTPR>(c, t) + e] = from_f<T>(in[4 * c + e]);
}

// partial dot of a staged fp32 row with the thread's own 16 dims
template <int kTPR>
__device__ __forceinline__ float dot_own(const float* srow, int t, const float* own) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kOwn / 4; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(srow + dim_of<kTPR>(c, t));
    acc = fmaf(v.x, own[4 * c], acc);
    acc = fmaf(v.y, own[4 * c + 1], acc);
    acc = fmaf(v.z, own[4 * c + 2], acc);
    acc = fmaf(v.w, own[4 * c + 3], acc);
  }
  return acc;
}

// acc += w * staged row (the thread's own 16 dims)
template <int kTPR>
__device__ __forceinline__ void axpy_own(float w, const float* srow, int t, float* acc) {
#pragma unroll
  for (int c = 0; c < kOwn / 4; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(srow + dim_of<kTPR>(c, t));
    acc[4 * c] = fmaf(w, v.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(w, v.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(w, v.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(w, v.w, acc[4 * c + 3]);
  }
}

// sum over the kTPR consecutive lanes of one row (the same order on each)
template <int kTPR>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int w = 1; w < kTPR; w <<= 1) v += __shfl_xor_sync(0xffffffffu, v, w);
  return v;
}

// delta[r] = do_r . o_r - dlse[r] (dlse null: 0) and lse2[r] = lse[r] *
// log2(e), r = (b*h + h) * sq + i
template <typename T, int D>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dlse,
             float* __restrict__ delta, float* __restrict__ lse2, int h, int sq,
             Strides os, Strides dos, long long rows) {
  const long long r = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long bh = r / sq;
  const int i = (int)(r - bh * sq);
  const int bi = (int)(bh / h);
  const int hi = (int)(bh - (long long)bi * h);
  const T* orow = o + bi * os.b + hi * os.h + i * os.s;
  const T* drow = dout + bi * dos.b + hi * dos.h + i * dos.s;
  float acc = to_f<T>(orow[lane]) * to_f<T>(drow[lane]);
#pragma unroll
  for (int e = lane + 32; e < D; e += 32)
    acc = fmaf(to_f<T>(orow[e]), to_f<T>(drow[e]), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    delta[r] = dlse ? acc - dlse[r] : acc;
    lse2[r] = lse[r] * kLog2e;
  }
}

// stage rows [r0, r0 + kSub) of two (s, D) operands as fp32; rows past s
// are zero
template <typename T, int D, int kThreads>
__device__ __forceinline__ void stage(float (*a_t)[D], float (*b_t)[D],
                                      const T* a, const T* b, long long as,
                                      long long bs, int r0, int s) {
  for (int idx = threadIdx.x; idx < kSub * D; idx += kThreads) {
    const int rr = idx / D;
    const int d = idx - rr * D;
    const int r = r0 + rr;
    float av = 0.f, bv = 0.f;
    if (r < s) {
      av = to_f<T>(a[r * as + d]);
      bv = to_f<T>(b[r * bs + d]);
    }
    a_t[rr][d] = av;
    b_t[rr][d] = bv;
  }
}

// The fp32 dK/dV pass over sk keys, walking sq query rows.  kMask: the kv_mask
// lane, kDrop: the dropout lane (a DropMode), kOff: the partial entry's
// causal offsets (diag); an instantiation without one has none of its code
// (without kOff it compiles as if diag were 0).
template <typename T, int D, bool kMask, int kDrop, bool kOff>
__device__ __forceinline__ void
bwd_dkv_body(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse2, const float* __restrict__ delta,
             const float* __restrict__ kvm, T* __restrict__ dk,
             T* __restrict__ dv, int h, int sq, int sk, Strides qs,
             Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
             float scale, float a, int causal, int diag, Drop dr) {
  constexpr int kTPR = tpr<D>();
  constexpr int kThreads = kTile * kTPR;
  __shared__ __align__(16) float q_t[kSub][D];
  __shared__ __align__(16) float do_t[kSub][D];
  __shared__ float l_t[kSub];
  __shared__ float dl_t[kSub];

  const int bh = blockIdx.y;
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int j0 = blockIdx.x * kTile;
  const int t = threadIdx.x % kTPR;
  const int j = j0 + threadIdx.x / kTPR;
  const bool live = j < sk;
  // the thread's key is attended by some row only if the mask keeps it
  const bool kept = live && (!kMask || kvm[(size_t)bi * sk + j] > 0.f);
  // a block of masked keys has nothing to accumulate: zeros out
  const bool any = kMask ? __syncthreads_or(kept) : true;

  float kr[kOwn], vr[kOwn], dkr[kOwn], dvr[kOwn];
#pragma unroll
  for (int e = 0; e < kOwn; ++e) {
    kr[e] = vr[e] = dkr[e] = dvr[e] = 0.f;
  }
  if (live) {
    load_own<T, kTPR>(k + bi * ks.b + hi * ks.h + j * ks.s, t, kr);
    load_own<T, kTPR>(v + bi * vs.b + hi * vs.h + j * vs.s, t, vr);
  }
  const T* qb = q + bi * qs.b + hi * qs.h;
  const T* db = dout + bi * dos.b + hi * dos.h;
  const float* lb = lse2 + (size_t)bh * sq;
  const float* deb = delta + (size_t)bh * sq;
  DropRow dkey;  // the key's part of each pair's hash
  if constexpr (kDrop != kNoDrop) dkey = drop_key<kDrop>(dr, bi, hi, j);
  const int first = kOff ? j - diag : j;  // causal: the first row seeing the key

  // causal: rows above the tile's first key's first row see none of its
  // keys (with offsets, the start rounded down to a staged tile)
  const int i_start = causal ? (kOff ? max(0, j0 - diag) & ~(kSub - 1) : j0) : 0;
  for (int i0 = i_start; any && i0 < sq; i0 += kSub) {
    __syncthreads();  // the previous tile is no longer read
    stage<T, D, kThreads>(q_t, do_t, qb, db, qs.s, dos.s, i0, sq);
    if (threadIdx.x < kSub) {
      const int i = i0 + threadIdx.x;
      l_t[threadIdx.x] = i < sq ? lb[i] : 0.f;
      dl_t[threadIdx.x] = i < sq ? deb[i] : 0.f;
    }
    uint32_t x0 = 0;  // the hash counter of the tile's first row
    if constexpr (kDrop != kNoDrop) x0 = drop_counter_rows<kDrop>(dr, dkey, i0);
    __syncthreads();
#pragma unroll 4
    for (int ii = 0; ii < kSub; ++ii) {
      const int i = i0 + ii;
      const float sc = row_sum<kTPR>(dot_own<kTPR>(q_t[ii], t, kr));
      float dp = row_sum<kTPR>(dot_own<kTPR>(do_t[ii], t, vr));
      const bool ok = kept && i < sq && (!causal || i >= first);
      const float p = ok ? exp2f(fmaf(sc, a, -l_t[ii])) : 0.f;
      float pv = p;  // the probability dv reads
      if constexpr (kDrop != kNoDrop) {
        const bool keep =
            drop_keep(x0 + (uint32_t)ii * drop_row_stride<kDrop>(dr), dr.thr);
        pv = keep ? p * dr.inv : 0.f;
        dp = keep ? dp * dr.inv : 0.f;
      }
      const float ds = p * (dp - dl_t[ii]) * scale;
      axpy_own<kTPR>(pv, do_t[ii], t, dvr);
      axpy_own<kTPR>(ds, q_t[ii], t, dkr);
    }
  }
  if (live) {
    store_own<T, kTPR>(dk + bi * dks.b + hi * dks.h + j * dks.s, t, dkr);
    store_own<T, kTPR>(dv + bi * dvs.b + hi * dvs.h + j * dvs.s, t, dvr);
  }
}

#define DKV_PARAMS                                                              \
  const T *__restrict__ q, const T *__restrict__ k, const T *__restrict__ v,    \
      const T *__restrict__ dout, const float *__restrict__ lse2,               \
      const float *__restrict__ delta, const float *__restrict__ kvm,           \
      T *__restrict__ dk, T *__restrict__ dv, int h, int sq, int sk,            \
      Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,             \
      Strides dvs, float scale, float a, int causal, int diag, Drop dr
#define DKV_ARGS                                                                  \
  q, k, v, dout, lse2, delta, kvm, dk, dv, h, sq, sk, qs, ks, vs, dos, dks, dvs, \
      scale, a, causal, diag, dr


// The fp32 dQ pass over sq queries, walking sk key rows; the lanes as the
// dK/dV pass's.
template <typename T, int D, bool kMask, int kDrop, bool kOff>
__global__ void __launch_bounds__(kTile * tpr<D>())
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse2, const float* __restrict__ delta,
              const float* __restrict__ kvm, T* __restrict__ dq, int h, int sq,
              int sk, Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
              float scale, float a, int causal, int diag, Drop dr) {
  constexpr int kTPR = tpr<D>();
  constexpr int kThreads = kTile * kTPR;
  __shared__ __align__(16) float k_t[kSub][D];
  __shared__ __align__(16) float v_t[kSub][D];
  __shared__ bool km_t[kMask ? kSub : 1];

  const int bh = blockIdx.y;
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int i0 = blockIdx.x * kTile;
  const int t = threadIdx.x % kTPR;
  const int i = i0 + threadIdx.x / kTPR;
  const bool live = i < sq;

  float qr[kOwn], dor[kOwn], dqr[kOwn];
#pragma unroll
  for (int e = 0; e < kOwn; ++e) {
    qr[e] = dor[e] = dqr[e] = 0.f;
  }
  float l = 0.f, dl = 0.f;
  if (live) {
    load_own<T, kTPR>(q + bi * qs.b + hi * qs.h + i * qs.s, t, qr);
    load_own<T, kTPR>(dout + bi * dos.b + hi * dos.h + i * dos.s, t, dor);
    l = lse2[(size_t)bh * sq + i];
    dl = delta[(size_t)bh * sq + i];
  }
  const T* kb = k + bi * ks.b + hi * ks.h;
  const T* vb = v + bi * vs.b + hi * vs.h;
  const float* mb = kMask ? kvm + (size_t)bi * sk : nullptr;
  DropRow drow;  // the row's part of each pair's hash
  if constexpr (kDrop != kNoDrop) drow = drop_row<kDrop>(dr, bi, hi, i);
  const int last = kOff ? i + diag : i;  // causal: the row's last visible key

  // causal: keys past the tile's last query's are in every row's future
  const int k_end =
      causal ? (kOff ? max(0, min(sk, i0 + kTile + diag)) : min(sk, i0 + kTile)) : sk;
  for (int j0 = 0; j0 < k_end; j0 += kSub) {
    __syncthreads();
    if constexpr (kMask) {
      bool mine = false;
      if (threadIdx.x < kSub) {
        const int j = j0 + threadIdx.x;
        mine = j < sk && mb[j] > 0.f;
        km_t[threadIdx.x] = mine;
      }
      if (!__syncthreads_or(mine)) continue;  // a wholly masked tile
    }
    stage<T, D, kThreads>(k_t, v_t, kb, vb, ks.s, vs.s, j0, sk);
    uint32_t x0 = 0;  // the hash counter of the tile's first key
    if constexpr (kDrop != kNoDrop) x0 = drop_counter<kDrop>(dr, drow, j0);
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < kSub; ++jj) {
      const int j = j0 + jj;
      const float sc = row_sum<kTPR>(dot_own<kTPR>(k_t[jj], t, qr));
      float dp = row_sum<kTPR>(dot_own<kTPR>(v_t[jj], t, dor));
      const bool ok = live && j < sk && (!causal || j <= last) && (!kMask || km_t[jj]);
      const float p = ok ? exp2f(fmaf(sc, a, -l)) : 0.f;
      if constexpr (kDrop != kNoDrop)
        dp = drop_keep(x0 + (uint32_t)jj, dr.thr) ? dp * dr.inv : 0.f;
      const float ds = p * (dp - dl) * scale;
      axpy_own<kTPR>(ds, k_t[jj], t, dqr);
    }
  }
  if (live) store_own<T, kTPR>(dq + bi * dqs.b + hi * dqs.h + i * dqs.s, t, dqr);
}

// --- the tensor-core passes (bf16 / fp16 operands) ----------------------
//
// Built from `flash_mma.cuh`'s tiles, fragments and staging.

static_assert(kMmaRows == kTile, "a warp owns 16 of the block's rows");

// walked rows a stage: the dK/dV pass's at d = 128 keep its dK and dV
// accumulators (128 registers) and the score tiles within 255 registers
template <int D> __host__ __device__ constexpr int dkv_walk() { return D == 128 ? 32 : 64; }
constexpr int kDqWalk = 64;

// The dK/dV pass on the tensor cores: one block a (b * h, 64-key tile),
// walking the query rows in dkv_walk<D>() tiles.  Per tile, a warp forms
// S^T = K Q^T and dP^T = V dO^T for its 16 keys (keys are the fragment's
// rows), turns them in place into P^T (after the dropout scale) and
// dS^T = P^T (dP^T - delta) scale, and adds P^T dO to dV and dS^T Q to
// dK, each left operand a hi + lo pair.  The lanes as `bwd_dkv_body`'s.
template <typename T, int D, bool kMask, int kDrop, bool kOff>
__global__ void __launch_bounds__(kMmaThreads, 2) mma_dkv_kernel(DKV_PARAMS) {
  constexpr int P = pitch<D>();
  constexpr int kN = dkv_walk<D>();
  constexpr int NB = kN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [kTile][P]
  T* v_s = k_s + kTile * P;                 // [kTile][P]
  T* q_s = v_s + kTile * P;                 // [2][kN][P]
  T* do_s = q_s + 2 * kN * P;               // [2][kN][P]
  float* l_s = reinterpret_cast<float*>(do_s + 2 * kN * P);  // [2][kN]
  float* dl_s = l_s + 2 * kN;                                // [2][kN]

  const int bh = blockIdx.y;
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int j0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int row0 = warp * 16;  // the warp's first key in the block
  const int keys[2] = {j0 + row0 + (lane >> 2), j0 + row0 + (lane >> 2) + 8};
  bool kept[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    kept[hh] = keys[hh] < sk && (!kMask || kvm[(size_t)bi * sk + keys[hh]] > 0.f);
  // a block of masked keys has nothing to accumulate: zeros out
  const bool any = kMask ? __syncthreads_or(kept[0] || kept[1]) : true;
  int first[2];  // causal: the first row seeing each key
  DropRow dkey[2];  // each key's part of its pairs' hash
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    first[hh] = kOff ? keys[hh] - diag : keys[hh];
    if constexpr (kDrop != kNoDrop) dkey[hh] = drop_key<kDrop>(dr, bi, hi, keys[hh]);
  }
  const T* qb = q + bi * qs.b + hi * qs.h;
  const T* db = dout + bi * dos.b + hi * dos.h;
  const float* lb = lse2 + (size_t)bh * sq;
  const float* deb = delta + (size_t)bh * sq;
  // the walked rows [i0, i0 + kN) and their lse2 and delta into stage st
  auto load_walk = [&](int i0, int st) {
    load_rows<T, D, kN>(q_s + st * kN * P, qb, qs.s, i0, sq);
    load_rows<T, D, kN>(do_s + st * kN * P, db, dos.s, i0, sq);
    for (int r = threadIdx.x; r < kN; r += kMmaThreads) {
      const int i = i0 + r;
      const int ok = i < sq ? 4 : 0;
      cp_async4(l_s + st * kN + r, lb + (ok ? i : 0), ok);
      cp_async4(dl_s + st * kN + r, deb + (ok ? i : 0), ok);
    }
  };

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;

  // causal: rows above the tile's first key's first row see none of its
  // keys (with offsets, the start rounded down to a walked tile)
  const int i_start = causal ? (kOff ? max(0, j0 - diag) & ~(kN - 1) : j0) : 0;
  const bool walk = any && i_start < sq;
  if (walk) {
    load_rows<T, D, kTile>(k_s, k + bi * ks.b + hi * ks.h, ks.s, j0, sk);
    load_rows<T, D, kTile>(v_s, v + bi * vs.b + hi * vs.h, vs.s, j0, sk);
    load_walk(i_start, 0);
  }
  cp_async_commit();
  int st = 0;
  for (int i0 = i_start; walk && i0 < sq; i0 += kN, st ^= 1) {
    if (i0 + kN < sq) load_walk(i0 + kN, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // stage st has landed
    __syncthreads();
    const T* qt = q_s + st * kN * P;
    const T* dt = do_s + st * kN * P;
    const float* lt = l_s + st * kN;
    const float* dlt = dl_s + st * kN;
    float sc[NB][4], dp[NB][4];
    scores<T, D, kN>(sc, dp, k_s, v_s, qt, dt, row0, lane);
    uint32_t x0[2] = {0, 0};  // the hash counter of each key's pair with row i0
    if constexpr (kDrop != kNoDrop) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) x0[hh] = drop_counter_rows<kDrop>(dr, dkey[hh], i0);
    }
#pragma unroll
    for (int nt = 0; nt < NB; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = frag_col(nt, t4, e);
        const int hh = e >> 1;
        const int i = i0 + c;
        const bool ok = kept[hh] && i < sq && (!causal || i >= first[hh]);
        const float p = ok ? exp2f(fmaf(sc[nt][e], a, -lt[c])) : 0.f;
        float pv = p, dpv = dp[nt][e];  // the probability dv reads, dp
        if constexpr (kDrop != kNoDrop) {
          const bool keep =
              drop_keep(x0[hh] + (uint32_t)c * drop_row_stride<kDrop>(dr), dr.thr);
          pv = keep ? p * dr.inv : 0.f;
          dpv = keep ? dpv * dr.inv : 0.f;
        }
        sc[nt][e] = pv;
        dp[nt][e] = p * (dpv - dlt[c]) * scale;
      }
#pragma unroll
    for (int kq = 0; kq < kN / 16; ++kq) {
      uint32_t f[2][4];
      a_frags_n<T, 2>(f, sc, kq);
      accumulate<T, D>(dv_acc, f[0], f[1], dt, kq, lane);
      a_frags_n<T, 2>(f, dp, kq);
      accumulate<T, D>(dk_acc, f[0], f[1], qt, kq, lane);
    }
    __syncthreads();  // stage st is read; the next prefetch may take it
  }
  cp_async_wait<0>();
  store_rows<T, D>(dk + bi * dks.b + hi * dks.h, dks.s, dk_acc, keys, sk, t4);
  store_rows<T, D>(dv + bi * dvs.b + hi * dvs.h, dvs.s, dv_acc, keys, sk, t4);
}

// The dQ pass on the tensor cores: one block a (b * h, 64-query tile),
// walking the keys in 64-key tiles.  Per tile, a warp forms S = Q K^T and
// dP = dO V^T for its 16 queries, dS = P (dP - delta) scale, and adds
// dS K to dQ, dS a hi + lo pair.  The lanes as `bwd_dq_kernel`'s; with the
// kv_mask, a walked tile whose keys are all masked is neither loaded nor
// multiplied.  Blocks run the last query tiles first: under causal
// masking they walk the most keys.
template <typename T, int D, bool kMask, int kDrop, bool kOff>
__global__ void __launch_bounds__(kMmaThreads, 2)
mma_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse2,
              const float* __restrict__ delta, const float* __restrict__ kvm,
              T* __restrict__ dq, int h, int sq, int sk, Strides qs, Strides ks,
              Strides vs, Strides dos, Strides dqs, float scale, float a, int causal,
              int diag, Drop dr) {
  constexpr int P = pitch<D>();
  constexpr int kN = kDqWalk;
  constexpr int NB = kN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [kTile][P]
  T* do_s = q_s + kTile * P;                // [kTile][P]
  T* k_s = do_s + kTile * P;                // [2][kN][P]
  T* v_s = k_s + 2 * kN * P;                // [2][kN][P]
  __shared__ bool km_s[kMask ? 2 * kN : 1];

  const int bh = blockIdx.y;
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int row0 = warp * 16;  // the warp's first query in the block
  const int rows[2] = {i0 + row0 + (lane >> 2), i0 + row0 + (lane >> 2) + 8};
  bool live[2];
  float l[2], dl[2];
  int last[2];  // causal: each row's last visible key
  DropRow drow[2];  // each row's part of its pairs' hash
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    live[hh] = rows[hh] < sq;
    l[hh] = live[hh] ? lse2[(size_t)bh * sq + rows[hh]] : 0.f;
    dl[hh] = live[hh] ? delta[(size_t)bh * sq + rows[hh]] : 0.f;
    last[hh] = kOff ? rows[hh] + diag : rows[hh];
    if constexpr (kDrop != kNoDrop) drow[hh] = drop_row<kDrop>(dr, bi, hi, rows[hh]);
  }
  const T* kb = k + bi * ks.b + hi * ks.h;
  const T* vb = v + bi * vs.b + hi * vs.h;
  const float* mb = kMask ? kvm + (size_t)bi * sk : nullptr;

  // causal: keys past the tile's last query's are in every row's future
  const int k_end =
      causal ? (kOff ? max(0, min(sk, i0 + kTile + diag)) : min(sk, i0 + kTile)) : sk;
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

  float dq_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[nt][e] = 0.f;

  int j0 = next_tile(0, 0);
  if (j0 < k_end) {
    load_rows<T, D, kTile>(q_s, q + bi * qs.b + hi * qs.h, qs.s, i0, sq);
    load_rows<T, D, kTile>(do_s, dout + bi * dos.b + hi * dos.h, dos.s, i0, sq);
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
    float sc[NB][4], dp[NB][4];
    scores<T, D, kN>(sc, dp, q_s, do_s, kt, vt, row0, lane);
    uint32_t x0[2] = {0, 0};  // the hash counter of each row's pair with key j0
    if constexpr (kDrop != kNoDrop) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) x0[hh] = drop_counter<kDrop>(dr, drow[hh], j0);
    }
#pragma unroll
    for (int nt = 0; nt < NB; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = frag_col(nt, t4, e);
        const int hh = e >> 1;
        const int j = j0 + c;
        const bool ok = live[hh] && j < sk && (!causal || j <= last[hh]) &&
                        (!kMask || km_s[st * kN + c]);
        const float p = ok ? exp2f(fmaf(sc[nt][e], a, -l[hh])) : 0.f;
        float dpv = dp[nt][e];
        if constexpr (kDrop != kNoDrop)
          dpv = drop_keep(x0[hh] + (uint32_t)c, dr.thr) ? dpv * dr.inv : 0.f;
        dp[nt][e] = p * (dpv - dl[hh]) * scale;
      }
#pragma unroll
    for (int kq = 0; kq < kN / 16; ++kq) {
      uint32_t f[2][4];
      a_frags_n<T, 2>(f, dp, kq);
      accumulate<T, D>(dq_acc, f[0], f[1], kt, kq, lane);
    }
    __syncthreads();  // stage st is read; the next prefetch may take it
    j0 = jn;
    st ^= 1;
  }
  cp_async_wait<0>();
  store_rows<T, D>(dq + bi * dqs.b + hi * dqs.h, dqs.s, dq_acc, rows, sq, t4);
}

// The arguments of one backward launch.
struct BwdArgs {
  const void *q, *k, *v, *o, *dout, *lse;
  const float* dlse;  // null: no lse cotangent
  void *dq, *dk, *dv, *delta, *lse2;
  const float* kvm;  // null: no kv_mask
  int b, h, sq, sk, d;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float scale;
  int causal, diag;  // diag: the kOff lane's q_off - k_off, in [-sq, sk]
  Drop dr;
  cudaStream_t stream;
};

// The tensor-core passes' dynamic shared memory, in bytes: the own
// [kTile][pitch] tiles, two stages of the walked ones, and the dK/dV
// pass's two stages of lse2 and delta
template <typename T, int D>
constexpr int dkv_smem() {
  return (2 * kTile + 4 * dkv_walk<D>()) * pitch<D>() * (int)sizeof(T) +
         4 * dkv_walk<D>() * (int)sizeof(float);
}
template <typename T, int D>
constexpr int dq_smem() {
  return (2 * kTile + 4 * kDqWalk) * pitch<D>() * (int)sizeof(T);
}

// Whether a's views suit the tensor-core passes: q, k, v and do in rows
// of 16-byte aligned chunks (cp.async), dq, dk and dv in 4-byte aligned
// pairs (the fragments' stores).
template <typename T>
bool mma_aligned(const BwdArgs& a) {
  return rows_aligned<T>(a.q, a.qs, 16) && rows_aligned<T>(a.k, a.ks, 16) &&
         rows_aligned<T>(a.v, a.vs, 16) && rows_aligned<T>(a.dout, a.dos, 16) &&
         rows_aligned<T>(a.dq, a.dqs, 4) && rows_aligned<T>(a.dk, a.dks, 4) &&
         rows_aligned<T>(a.dv, a.dvs, 4);
}

// The tensor-core dK/dV and dQ passes of one lane.
template <typename T, int D, bool kMask, int kDrop, bool kOff>
cudaError_t launch_mma(const BwdArgs& a, float alpha) {
  const auto dkv = mma_dkv_kernel<T, D, kMask, kDrop, kOff>;
  const auto dq = mma_dq_kernel<T, D, kMask, kDrop, kOff>;
  constexpr int kv_bytes = dkv_smem<T, D>(), q_bytes = dq_smem<T, D>();
  cudaError_t e =
      cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, q_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid_kv((a.sk + kTile - 1) / kTile, a.b * a.h);
  dkv<<<grid_kv, kMmaThreads, kv_bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse2), static_cast<const float*>(a.delta), a.kvm,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.h, a.sq, a.sk, a.qs, a.ks,
      a.vs, a.dos, a.dks, a.dvs, a.scale, alpha, a.causal, a.diag, a.dr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid_q((a.sq + kTile - 1) / kTile, a.b * a.h);
  dq<<<grid_q, kMmaThreads, q_bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse2), static_cast<const float*>(a.delta), a.kvm,
      static_cast<T*>(a.dq), a.h, a.sq, a.sk, a.qs, a.ks, a.vs, a.dos, a.dqs,
      a.scale, alpha, a.causal, a.diag, a.dr);
  return cudaGetLastError();
}

// The delta pass, then the dK/dV and dQ passes: for fp32 operands the
// kernels Lanes<T, D>::dkv(a) and ::dq(a) choose, for bf16 and fp16 the
// tensor-core lane Lanes<T, D>::mma(a, alpha) launches.
template <template <typename, int> class Lanes, typename T, int D>
cudaError_t launch_bwd_d(const BwdArgs& a) {
  constexpr bool kMma = !std::is_same<T, float>::value;
  if constexpr (kMma) {
    if (!mma_aligned<T>(a)) return cudaErrorMisalignedAddress;
  }
  const float alpha = a.scale * kLog2e;
  const long long rows = (long long)a.b * a.h * a.sq;
  const int warps = 8;
  const unsigned blocks = (unsigned)((rows + warps - 1) / warps);
  delta_kernel<T, D><<<blocks, warps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), a.dlse, static_cast<float*>(a.delta),
      static_cast<float*>(a.lse2), a.h, a.sq, a.os, a.dos, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (kMma) {
    return Lanes<T, D>::mma(a, alpha);
  } else {
    constexpr int kThreads = kTile * tpr<D>();
    const auto dkv = Lanes<T, D>::dkv(a);
    const dim3 grid_kv((a.sk + kTile - 1) / kTile, a.b * a.h);
    dkv<<<grid_kv, kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse2), static_cast<const float*>(a.delta), a.kvm,
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.h, a.sq, a.sk, a.qs, a.ks,
        a.vs, a.dos, a.dks, a.dvs, a.scale, alpha, a.causal, a.diag, a.dr);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const auto dq_pass = Lanes<T, D>::dq(a);
    const dim3 grid_q((a.sq + kTile - 1) / kTile, a.b * a.h);
    dq_pass<<<grid_q, kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse2), static_cast<const float*>(a.delta), a.kvm,
        static_cast<T*>(a.dq), a.h, a.sq, a.sk, a.qs, a.ks, a.vs, a.dos, a.dqs,
        a.scale, alpha, a.causal, a.diag, a.dr);
    return cudaGetLastError();
  }
}

// The backward at a's head dim (64 or 128) and dtype code (0 float32,
// 1 bfloat16, 2 float16).
template <template <typename, int> class Lanes>
cudaError_t launch_bwd(const BwdArgs& a, int dtype) {
  return by_dtype(dtype, [&](auto tag) -> cudaError_t {
    using T = decltype(tag);
    if (a.d == 64) return launch_bwd_d<Lanes, T, 64>(a);
    if (a.d == 128) return launch_bwd_d<Lanes, T, 128>(a);
    return cudaErrorInvalidValue;
  });
}

}  // namespace
