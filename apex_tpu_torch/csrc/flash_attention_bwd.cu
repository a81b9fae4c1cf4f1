// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces: apex_tpu/ops/flash_attention.py `_flash_bwd` (row 8: the
// (b, h, sq, d) / (b, h, sk, d) backward of `flash_attention`, Pallas
// bodies `_bwd_dq_kernel`, `_bwd_dkv_kernel` and the fused one-pass
// `_bwd_fused_kernel`), `_flash_bwd_e` (row 12, body `_bwd_e_kernel`)
// and `_flash_bwd_e_blocked` (row 13, the same backward the JAX package
// streams in (512, 512) tiles once the padded sequence outgrows one VMEM
// block: the passes below walk shared-memory tiles whatever s is).
// Every operand is a strided (b, h, s, d) view, so one entry serves both
// layouts: q/k/v and dq/dk/dv may be separate (b, h, s, d) tensors, or
// the heads' [q|k|v] lanes of the E layout's qkv (b, s, h, 3d) and of one
// dqkv buffer, written in place, never as three tensors then
// concatenated.  Causal (key j visible to query i iff j <= i, both
// counted from 0: top-left aligned when sq != sk) or full, with the
// kv_mask lane (`_bwd_e_kernel`'s has_kvm): an optional (b, sk) fp32 key
// mask, a key attended where it is > 0.  Head dim 64 or 128.  The E
// backward's dropout lane (`_bwd_e_kernel`'s keep at :2191, the blocked
// walk's at :2336 and :2374) regenerates the forward's keep mask from the
// same counter hash (`flash_dropout.cuh`): dv reads the dropped, rescaled
// p and dp = (do v^T) keep / (1 - rate), so ds = p (dp - delta) with delta
// from the dropped o.
//
// Math, per (b, h): p = exp(scale * q k^T - lse) recomputed from the
// forward's natural-log lse (so no (sq, sk) matrix is ever stored),
// delta_i = sum_d do_i * o_i, ds = p * (do v^T - delta), and
// dq = scale * ds k, dk = scale * ds^T q, dv = p^T do, all in fp32, cast
// once to the operands' dtype.  `scale` is used as given, in fp32: the
// JAX backward folds it into v after rounding it to v's dtype, which at
// d = 128 in bf16 (1/sqrt(128) -> 0.08837890625) moves dq and dk by
// 1.07e-4 relative; the port keeps the scale its forward used.  A masked
// (q, k) pair takes p = 0 by a select made before the exponential is
// read: a row that attends nothing has lse = -inf from the forward,
// where exp(s - lse) would be inf.
//
// What bounds it on the H100: operations.  It does 10 * d operations per
// (q, k) pair (recomputed scores, do v^T, and the three products) against
// about 16 * d bytes per row moved in bf16 (q, k, v, o, do read, dq, dk,
// dv written): at s = 1024 causal that is ~43 GFLOP against ~134 MB for
// b = 8, h = 16, d = 64, so the bf16 tensor cores would be the limit
// (~44 us); at s = 16384 it is 2.7 TFLOP for h = 16, d = 128.
//
// What the simple design does about it (correct first, not fast): three
// passes, every one deterministic (no atomics, every output element
// written by exactly one thread).
//  1. delta: one warp per (b, h, query row) reduces do . o; the same pass
//     converts lse to base-2 units.
//  2. dK/dV: one block per (b * h, 64-key tile), kTPR threads per key
//     (4 at d = 64, 8 at d = 128), each owning 16 of the key's dims of
//     k, v, dk and dv in registers (64 floats at either head dim).  The
//     block walks the sq query rows in 32-row tiles staged through shared
//     memory as fp32, starting at the tile's first key under causal
//     masking (the rows above see none of its keys); each (q, k) dot
//     product is kTPR partial sums joined by warp shuffles.
//  3. dQ: one block per (b * h, 64-query tile), the same thread layout
//     over q, do and dq, walking the sk key rows in 32-row tiles and
//     stopping at the tile's last query under causal masking.
// A thread's 16 dims are four float4 chunks interleaved with its
// neighbours' (dims 4 * kTPR * c + 4 * t .. + 3), so the threads of a row
// read different shared-memory banks.  With a kv_mask, a dK/dV block
// whose 64 keys are all masked writes zeros without walking the rows,
// and the dQ pass skips every staged key tile that is wholly masked
// (BERT's padded tails cost no products).  The products run on the fp32
// pipes, not the tensor cores: mma/wgmma tiles are later work.
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

constexpr int kTile = 64;      // keys (dK/dV) or queries (dQ) per block
constexpr int kOwn = 16;       // dims a thread owns (D / kTPR)
constexpr int kSub = 32;       // rows per staged shared-memory tile
constexpr float kLog2e = 1.4426950408889634f;

// threads per row at head dim D: D / kOwn
template <int D> __host__ __device__ constexpr int tpr() { return D / kOwn; }

struct Strides {
  long long b, h, s;
};

// dims of chunk c owned by thread part t: 4 * kTPR * c + 4 * t .. + 3
template <int kTPR>
__device__ __forceinline__ int dim_of(int c, int t) { return 4 * kTPR * c + 4 * t; }

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

// delta[r] = do_r . o_r and lse2[r] = lse[r] * log2(e),
// r = (b*h + h) * sq + i
template <typename T, int D>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ delta,
             float* __restrict__ lse2, int h, int sq, Strides os, Strides dos,
             long long rows) {
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
    delta[r] = acc;
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
// lane, kDrop: the dropout lane; an instantiation without one has none of
// its code.
template <typename T, int D, bool kMask, bool kDrop>
__device__ __forceinline__ void
bwd_dkv_body(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse2, const float* __restrict__ delta,
             const float* __restrict__ kvm, T* __restrict__ dk,
             T* __restrict__ dv, int h, int sq, int sk, Strides qs,
             Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
             float scale, float a, int causal, Drop dr) {
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
  if constexpr (kDrop) dkey = drop_key(dr, bi, hi, j);

  // causal: rows above the tile's first key see none of its keys
  for (int i0 = causal ? j0 : 0; any && i0 < sq; i0 += kSub) {
    __syncthreads();  // the previous tile is no longer read
    stage<T, D, kThreads>(q_t, do_t, qb, db, qs.s, dos.s, i0, sq);
    if (threadIdx.x < kSub) {
      const int i = i0 + threadIdx.x;
      l_t[threadIdx.x] = i < sq ? lb[i] : 0.f;
      dl_t[threadIdx.x] = i < sq ? deb[i] : 0.f;
    }
    uint32_t x0 = 0;  // the hash counter of the tile's first row
    if constexpr (kDrop) x0 = drop_counter_rows(dr, dkey, i0);
    __syncthreads();
#pragma unroll 4
    for (int ii = 0; ii < kSub; ++ii) {
      const int i = i0 + ii;
      const float sc = row_sum<kTPR>(dot_own<kTPR>(q_t[ii], t, kr));
      float dp = row_sum<kTPR>(dot_own<kTPR>(do_t[ii], t, vr));
      const bool ok = kept && i < sq && (!causal || j <= i);
      const float p = ok ? exp2f(fmaf(sc, a, -l_t[ii])) : 0.f;
      float pv = p;  // the probability dv reads
      if constexpr (kDrop) {
        const bool keep = drop_keep(x0 + (uint32_t)ii * (uint32_t)dr.w, dr.thr);
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
      Strides dvs, float scale, float a, int causal, Drop dr
#define DKV_ARGS                                                                  \
  q, k, v, dout, lse2, delta, kvm, dk, dv, h, sq, sk, qs, ks, vs, dos, dks, dvs, \
      scale, a, causal, dr

// Two kernels, so each keeps its own launch bounds: the unmasked one as
// it always was (ptxas gives it 128 registers at d = 64), the masked one
// held to the registers that let a second 256-thread block in at d = 64
// (128 a thread; unbounded, the mask took it to 130 and one block, 20 %
// slower).  At d = 128 a block is 512 threads, which itself caps a thread
// at 128 registers, one block an SM.
template <typename T, int D>
__global__ void __launch_bounds__(kTile * tpr<D>()) bwd_dkv_kernel(DKV_PARAMS) {
  bwd_dkv_body<T, D, false, false>(DKV_ARGS);
}

template <typename T, int D>
__global__ void __launch_bounds__(kTile * tpr<D>(), 512 / (kTile * tpr<D>()))
    bwd_dkv_masked_kernel(DKV_PARAMS) {
  bwd_dkv_body<T, D, true, false>(DKV_ARGS);
}

// The dropout lane, with or without the kv_mask, held to the masked
// kernel's registers (the hash's few live values would otherwise push
// d = 64 past 128 and to one block an SM).
template <typename T, int D, bool kMask>
__global__ void __launch_bounds__(kTile * tpr<D>(), 512 / (kTile * tpr<D>()))
    bwd_dkv_drop_kernel(DKV_PARAMS) {
  bwd_dkv_body<T, D, kMask, true>(DKV_ARGS);
}

// The dQ pass over sq queries, walking sk key rows.
template <typename T, int D, bool kMask, bool kDrop>
__global__ void __launch_bounds__(kTile * tpr<D>())
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse2, const float* __restrict__ delta,
              const float* __restrict__ kvm, T* __restrict__ dq, int h, int sq,
              int sk, Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
              float scale, float a, int causal, Drop dr) {
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
  if constexpr (kDrop) drow = drop_row(dr, bi, hi, i);

  // causal: keys past the tile's last query are in every row's future
  const int k_end = causal ? min(sk, i0 + kTile) : sk;
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
    if constexpr (kDrop) x0 = drop_counter(dr, drow, j0);
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < kSub; ++jj) {
      const int j = j0 + jj;
      const float sc = row_sum<kTPR>(dot_own<kTPR>(k_t[jj], t, qr));
      float dp = row_sum<kTPR>(dot_own<kTPR>(v_t[jj], t, dor));
      const bool ok = live && j < sk && (!causal || j <= i) && (!kMask || km_t[jj]);
      const float p = ok ? exp2f(fmaf(sc, a, -l)) : 0.f;
      if constexpr (kDrop)
        dp = drop_keep(x0 + (uint32_t)jj, dr.thr) ? dp * dr.inv : 0.f;
      const float ds = p * (dp - dl) * scale;
      axpy_own<kTPR>(ds, k_t[jj], t, dqr);
    }
  }
  if (live) store_own<T, kTPR>(dq + bi * dqs.b + hi * dqs.h + i * dqs.s, t, dqr);
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const void* lse, void* dq, void* dk, void* dv,
                     void* delta, void* lse2, const float* kvm, int b, int h, int sq,
                     int sk, Strides qs, Strides ks, Strides vs, Strides os,
                     Strides dos, Strides dqs, Strides dks, Strides dvs, float scale,
                     int causal, Drop dr, cudaStream_t stream) {
  constexpr int kThreads = kTile * tpr<D>();
  const float a = scale * kLog2e;
  const long long rows = (long long)b * h * sq;
  const int warps = 8;
  delta_kernel<T, D><<<(unsigned)((rows + warps - 1) / warps), warps * 32, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<float*>(lse2), h, sq, os, dos, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid_kv((sk + kTile - 1) / kTile, b * h);
  auto dkv = dr.thr ? (kvm ? bwd_dkv_drop_kernel<T, D, true>
                            : bwd_dkv_drop_kernel<T, D, false>)
                    : (kvm ? bwd_dkv_masked_kernel<T, D> : bwd_dkv_kernel<T, D>);
  dkv<<<grid_kv, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse2),
      static_cast<const float*>(delta), kvm, static_cast<T*>(dk), static_cast<T*>(dv),
      h, sq, sk, qs, ks, vs, dos, dks, dvs, scale, a, causal, dr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid_q((sq + kTile - 1) / kTile, b * h);
  auto dq_pass = kvm ? (dr.thr ? bwd_dq_kernel<T, D, true, true>
                               : bwd_dq_kernel<T, D, true, false>)
                     : (dr.thr ? bwd_dq_kernel<T, D, false, true>
                               : bwd_dq_kernel<T, D, false, false>);
  dq_pass<<<grid_q, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse2),
      static_cast<const float*>(delta), kvm, static_cast<T*>(dq), h, sq, sk, qs, ks,
      vs, dos, dqs, scale, a, causal, dr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* dq, void* dk, void* dv,
                   void* delta, void* lse2, const float* kvm, int b, int h, int sq,
                   int sk, int d, Strides qs, Strides ks, Strides vs, Strides os,
                   Strides dos, Strides dqs, Strides dks, Strides dvs, float scale,
                   int causal, Drop dr, cudaStream_t stream) {
  if (d == 64)
    return launch_d<T, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta, lse2, kvm, b, h,
                           sq, sk, qs, ks, vs, os, dos, dqs, dks, dvs, scale, causal,
                           dr, stream);
  if (d == 128)
    return launch_d<T, 128>(q, k, v, o, dout, lse, dq, dk, dv, delta, lse2, kvm, b, h,
                            sq, sk, qs, ks, vs, os, dos, dqs, dks, dvs, scale, causal,
                            dr, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Every operand is a (b, h, s, d) view given by element strides over
// (b, h, s) with a unit stride on d: q, o, do and dq over sq rows; k, v,
// dk and dv over sk rows (the E entry passes the lanes of the (b, s, h,
// 3d) qkv and dqkv buffers with sq = sk, the (b, h, s, d) entry its own
// tensors).  lse (b, h, sq) fp32 contiguous, natural log of the scaled
// scores' sum; delta and lse2 are fp32 scratch of b * h * sq each; kvm
// null, or the forward's (b, sk) fp32 key mask, contiguous.  dtype codes:
// 0 float32, 1 bfloat16, 2 float16.  d = 64 or 128.  Dropout: the
// forward's drop_seed, drop_w, drop_thr and drop_inv (drop_thr 0: none).
int apex_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* dq, void* dk, void* dv, void* delta, void* lse2,
    const void* kvm, int b, int h, int sq, int sk, int d, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, long long do_sb, long long do_sh, long long do_ss,
    long long dq_sb, long long dq_sh, long long dq_ss, long long dk_sb,
    long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh,
    long long dv_ss, float scale, int causal, int drop_seed, int drop_w,
    int drop_thr, float drop_inv, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0 || sk <= 0 || b * h > 65535)
    return cudaErrorInvalidValue;
  Drop dr;
  if (!make_drop(drop_seed, drop_w, drop_thr, drop_inv, sq, sk, &dr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(kvm);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss}, dos{do_sb, do_sh, do_ss}, dqs{dq_sb, dq_sh, dq_ss},
      dks{dk_sb, dk_sh, dk_ss}, dvs{dv_sb, dv_sh, dv_ss};
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, o, dout, lse, dq, dk, dv, delta, lse2, m, b, h, sq,
                           sk, d, qs, ks, vs, os, dos, dqs, dks, dvs, scale, causal, dr,
                           st);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, delta, lse2, m, b,
                                   h, sq, sk, d, qs, ks, vs, os, dos, dqs, dks, dvs,
                                   scale, causal, dr, st);
    case 2:
      return launch<__half>(q, k, v, o, dout, lse, dq, dk, dv, delta, lse2, m, b, h, sq,
                            sk, d, qs, ks, vs, os, dos, dqs, dks, dvs, scale, causal, dr,
                           st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
