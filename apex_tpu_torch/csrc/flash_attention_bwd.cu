// Flash-attention backward over the projection-native E layout, for
// Hopper (sm_90a), plain C interface.
//
// Replaces: apex_tpu/ops/flash_attention.py `_flash_bwd_e` (Pallas body
// `_bwd_e_kernel`): from qkv (b, s, h, 3d) with lanes [head][q|k|v], the
// forward's o (b, s, h, d) and fp32 lse (b, h, s), and do (b, s, h, d),
// it writes dqkv in qkv's own interleaved layout: dq, dk and dv land in
// each head's [q|k|v] lanes, never in three tensors that are then
// concatenated.  Causal or full; no kv_mask and no dropout (later work).
//
// Math, per (b, h): p = exp(scale * q k^T - lse) recomputed from the
// forward's natural-log lse (so no (s, s) matrix is ever stored),
// delta_i = sum_d do_i * o_i, ds = p * (do v^T - delta), and
// dq = scale * ds k, dk = scale * ds^T q, dv = p^T do, all in fp32, cast
// once to qkv's dtype.
//
// What bounds it on the H100: operations.  It does 10 * d operations per
// (q, k) pair (recomputed scores, do v^T, and the three products) against
// about 16 * d bytes per row moved in bf16 (qkv, o, do read, dqkv
// written): at s = 1024 causal that is ~43 GFLOP against ~134 MB for
// b = 8, h = 16, so the bf16 tensor cores would be the limit (~44 us).
//
// What the simple design does about it (correct first, not fast): three
// passes, every one deterministic (no atomics, every output element
// written by exactly one thread).
//  1. delta: one warp per (b, h, row) reduces do . o; the same pass
//     converts lse to base-2 units.
//  2. dK/dV: one block per (b * h, 64-key tile), four threads per key,
//     each owning 16 of the 64 dims of k, v, dk and dv in registers.  The
//     block walks the q rows in 32-row tiles staged through shared memory
//     as fp32, starting at the tile's first key under causal masking (the
//     rows above see none of its keys); each (q, k) dot product is four
//     partial sums joined by two warp shuffles.
//  3. dQ: one block per (b * h, 64-query tile), the same thread layout
//     over q, do and dq, walking the k/v rows in 32-row tiles and
//     stopping at the tile's last query under causal masking.
// A thread's 16 dims are four float4 chunks interleaved with its three
// neighbours' (dims 16c + 4t .. 16c + 4t + 3), so the four threads of a
// row read four different shared-memory banks.  The products run on the
// fp32 pipes, not the tensor cores: mma/wgmma tiles are later work.
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

constexpr int D = 64;          // head dim
constexpr int kTile = 64;      // keys (dK/dV) or queries (dQ) per block
constexpr int kTPR = 4;        // threads per row
constexpr int kThreads = kTile * kTPR;
constexpr int kOwn = D / kTPR; // dims a thread owns
constexpr int kSub = 32;       // rows per staged shared-memory tile
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s;
};

// dims of chunk c owned by thread part t: 16c + 4t .. 16c + 4t + 3
__device__ __forceinline__ int dim_of(int c, int t) { return 16 * c + 4 * t; }

template <typename T>
__device__ __forceinline__ void load_own(const T* row, int t, float* out) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[4 * c + e] = to_f<T>(row[dim_of(c, t) + e]);
}

template <typename T>
__device__ __forceinline__ void store_own(T* row, int t, const float* in) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) row[dim_of(c, t) + e] = from_f<T>(in[4 * c + e]);
}

// partial dot of a staged fp32 row with the thread's own 16 dims
__device__ __forceinline__ float dot_own(const float* srow, int t, const float* own) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(srow + dim_of(c, t));
    acc = fmaf(v.x, own[4 * c], acc);
    acc = fmaf(v.y, own[4 * c + 1], acc);
    acc = fmaf(v.z, own[4 * c + 2], acc);
    acc = fmaf(v.w, own[4 * c + 3], acc);
  }
  return acc;
}

// acc += w * staged row (the thread's own 16 dims)
__device__ __forceinline__ void axpy_own(float w, const float* srow, int t, float* acc) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(srow + dim_of(c, t));
    acc[4 * c] = fmaf(w, v.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(w, v.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(w, v.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(w, v.w, acc[4 * c + 3]);
  }
}

// sum over the kTPR consecutive lanes of one row
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// delta[r] = do_r . o_r and lse2[r] = lse[r] * log2(e), r = (b*h + h) * s + i
template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ delta,
             float* __restrict__ lse2, int h, int s, Strides os, Strides dos,
             long long rows) {
  const long long r = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long bh = r / s;
  const int i = (int)(r - bh * s);
  const int bi = (int)(bh / h);
  const int hi = (int)(bh - (long long)bi * h);
  const T* orow = o + bi * os.b + hi * os.h + i * os.s;
  const T* drow = dout + bi * dos.b + hi * dos.h + i * dos.s;
  float acc = to_f<T>(orow[lane]) * to_f<T>(drow[lane]);
  acc = fmaf(to_f<T>(orow[lane + 32]), to_f<T>(drow[lane + 32]), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    delta[r] = acc;
    lse2[r] = lse[r] * kLog2e;
  }
}

// stage rows [r0, r0 + kSub) of two (s, D) operands as fp32; rows past s
// are zero
template <typename T>
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse2, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int h, int s, Strides qs,
               Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
               float scale, float a, int causal) {
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
  const bool live = j < s;

  float kr[kOwn], vr[kOwn], dkr[kOwn], dvr[kOwn];
#pragma unroll
  for (int e = 0; e < kOwn; ++e) {
    kr[e] = vr[e] = dkr[e] = dvr[e] = 0.f;
  }
  if (live) {
    load_own<T>(k + bi * ks.b + hi * ks.h + j * ks.s, t, kr);
    load_own<T>(v + bi * vs.b + hi * vs.h + j * vs.s, t, vr);
  }
  const T* qb = q + bi * qs.b + hi * qs.h;
  const T* db = dout + bi * dos.b + hi * dos.h;
  const float* lb = lse2 + (size_t)bh * s;
  const float* deb = delta + (size_t)bh * s;

  // causal: rows above the tile's first key see none of its keys
  for (int i0 = causal ? j0 : 0; i0 < s; i0 += kSub) {
    __syncthreads();  // the previous tile is no longer read
    stage<T>(q_t, do_t, qb, db, qs.s, dos.s, i0, s);
    if (threadIdx.x < kSub) {
      const int i = i0 + threadIdx.x;
      l_t[threadIdx.x] = i < s ? lb[i] : 0.f;
      dl_t[threadIdx.x] = i < s ? deb[i] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int ii = 0; ii < kSub; ++ii) {
      const int i = i0 + ii;
      const float sc = row_sum(dot_own(q_t[ii], t, kr));
      const float dp = row_sum(dot_own(do_t[ii], t, vr));
      const bool ok = live && i < s && (!causal || j <= i);
      const float p = ok ? exp2f(fmaf(sc, a, -l_t[ii])) : 0.f;
      const float ds = p * (dp - dl_t[ii]) * scale;
      axpy_own(p, do_t[ii], t, dvr);
      axpy_own(ds, q_t[ii], t, dkr);
    }
  }
  if (live) {
    store_own<T>(dk + bi * dks.b + hi * dks.h + j * dks.s, t, dkr);
    store_own<T>(dv + bi * dvs.b + hi * dvs.h + j * dvs.s, t, dvr);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse2, const float* __restrict__ delta,
              T* __restrict__ dq, int h, int s, Strides qs, Strides ks,
              Strides vs, Strides dos, Strides dqs, float scale, float a,
              int causal) {
  __shared__ __align__(16) float k_t[kSub][D];
  __shared__ __align__(16) float v_t[kSub][D];

  const int bh = blockIdx.y;
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int i0 = blockIdx.x * kTile;
  const int t = threadIdx.x % kTPR;
  const int i = i0 + threadIdx.x / kTPR;
  const bool live = i < s;

  float qr[kOwn], dor[kOwn], dqr[kOwn];
#pragma unroll
  for (int e = 0; e < kOwn; ++e) {
    qr[e] = dor[e] = dqr[e] = 0.f;
  }
  float l = 0.f, dl = 0.f;
  if (live) {
    load_own<T>(q + bi * qs.b + hi * qs.h + i * qs.s, t, qr);
    load_own<T>(dout + bi * dos.b + hi * dos.h + i * dos.s, t, dor);
    l = lse2[(size_t)bh * s + i];
    dl = delta[(size_t)bh * s + i];
  }
  const T* kb = k + bi * ks.b + hi * ks.h;
  const T* vb = v + bi * vs.b + hi * vs.h;

  // causal: keys past the tile's last query are in every row's future
  const int k_end = causal ? min(s, i0 + kTile) : s;
  for (int j0 = 0; j0 < k_end; j0 += kSub) {
    __syncthreads();
    stage<T>(k_t, v_t, kb, vb, ks.s, vs.s, j0, s);
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < kSub; ++jj) {
      const int j = j0 + jj;
      const float sc = row_sum(dot_own(k_t[jj], t, qr));
      const float dp = row_sum(dot_own(v_t[jj], t, dor));
      const bool ok = live && j < s && (!causal || j <= i);
      const float p = ok ? exp2f(fmaf(sc, a, -l)) : 0.f;
      const float ds = p * (dp - dl) * scale;
      axpy_own(ds, k_t[jj], t, dqr);
    }
  }
  if (live) store_own<T>(dq + bi * dqs.b + hi * dqs.h + i * dqs.s, t, dqr);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* dq, void* dk, void* dv,
                   void* delta, void* lse2, int b, int h, int s, Strides qs,
                   Strides ks, Strides vs, Strides os, Strides dos, Strides dqs,
                   Strides dks, Strides dvs, float scale, int causal,
                   cudaStream_t stream) {
  const float a = scale * kLog2e;
  const long long rows = (long long)b * h * s;
  const int warps = 8;
  delta_kernel<T><<<(unsigned)((rows + warps - 1) / warps), warps * 32, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<float*>(lse2), h, s, os, dos, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((s + kTile - 1) / kTile, b * h);
  bwd_dkv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse2),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), h,
      s, qs, ks, vs, dos, dks, dvs, scale, a, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dq_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse2),
      static_cast<const float*>(delta), static_cast<T*>(dq), h, s, qs, ks, vs, dos,
      dqs, scale, a, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Every operand is a (b, h, s, d) view given by element strides over
// (b, h, s) with a unit stride on d: q/k/v and dq/dk/dv are the lanes of
// the (b, s, h, 3d) qkv and dqkv buffers, o and do (b, s, h, d) buffers.
// lse (b, h, s) fp32 contiguous, natural log of the scaled scores' sum;
// delta and lse2 are fp32 scratch of b * h * s each.  dtype codes: 0
// float32, 1 bfloat16, 2 float16.  d = 64.
int apex_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* dq, void* dk, void* dv, void* delta, void* lse2, int b,
    int h, int s, int d, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss, long long do_sb,
    long long do_sh, long long do_ss, long long dq_sb, long long dq_sh,
    long long dq_ss, long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss, float scale, int causal,
    int dtype, void* stream) {
  if (b <= 0 || h <= 0 || s <= 0 || d != D || b * h > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss}, dos{do_sb, do_sh, do_ss}, dqs{dq_sb, dq_sh, dq_ss},
      dks{dk_sb, dk_sh, dk_ss}, dvs{dv_sb, dv_sh, dv_ss};
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, o, dout, lse, dq, dk, dv, delta, lse2, b, h, s,
                           qs, ks, vs, os, dos, dqs, dks, dvs, scale, causal, st);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, delta, lse2, b,
                                   h, s, qs, ks, vs, os, dos, dqs, dks, dvs, scale,
                                   causal, st);
    case 2:
      return launch<__half>(q, k, v, o, dout, lse, dq, dk, dv, delta, lse2, b, h, s,
                            qs, ks, vs, os, dos, dqs, dks, dvs, scale, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
