// The flash-attention backward kernels for Hopper (sm_90a), shared by the
// launchers of `flash_attention_bwd.cu` (the (b, h, s, d), packed-qkv and E
// entries) and `flash_attention_partial.cu` (the partial entry): each
// instantiates the lanes its entries take.  The math, the three passes and
// what bounds them are described in `flash_attention_bwd.cu`.
#pragma once

#include "flash_common.cuh"
#include "flash_dropout.cuh"

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

// The dK/dV pass over sk keys, walking sq query rows.  kMask: the kv_mask
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


// The dQ pass over sq queries, walking sk key rows; the lanes as the dK/dV
// pass's.
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

// The delta pass, then the dK/dV and dQ kernels Lanes<T, D>::dkv(a) and
// ::dq(a) choose.
template <template <typename, int> class Lanes, typename T, int D>
cudaError_t launch_bwd_d(const BwdArgs& a) {
  constexpr int kThreads = kTile * tpr<D>();
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
