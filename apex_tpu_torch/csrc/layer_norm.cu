// LayerNorm forward and backward for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Forward replaces: apex_tpu/ops/layer_norm.py `_ln_forward` (Pallas
// kernel `_ln_fwd_kernel`): row LayerNorm over (rows, hidden) with fp32
// statistics, output in x's dtype, optional fp32 (or x-dtype) gamma/beta
// over low-precision x (the mixed variant), plus the fp32 per-row mean
// and rstd the backward reads.
//
// Backward replaces: apex_tpu/ops/layer_norm.py `_ln_backward` (Pallas
// kernel `_ln_bwd_kernel` plus the XLA sum of its per-block partials):
// dx = rstd * (gdy - mean(gdy) - xhat * mean(gdy * xhat)) with gdy =
// dy * gamma, all in fp32, and dgamma = sum(dy * xhat), dbeta = sum(dy)
// over rows, summed in fp32 and cast once to gamma's dtype.
//
// What bounds both on the H100: bytes.  Each row is read once and written
// once, about 8 (forward) or 12 (backward) operations per element against
// 4 or 6 bytes moved in bf16, far below the ~295 operations per byte
// where the tensor cores (or even the 67 TFLOP/s fp32 pipes) would be the
// limit.
//
// What the designs do about it.  Forward: one warp a row where hidden is a
// multiple of 256 up to 2048 and x, y, gamma and beta are 16-byte aligned
// (`vec_route`), else the PR 1 kernel, one 256-thread block a row, as the
// element path.  The vector kernel (`ln_fwd_vec_kernel`, 4 rows a block)
// issues all of a row's 16-byte loads (8 bf16/fp16 or 4 fp32 values a
// lane) before its first sum, keeps the row in registers through the mean,
// the centred variance and the output, reduces by warp shuffles alone (no
// __syncthreads), reads gamma/beta 16 bytes at a time in their own dtype
// and stores y 16 bytes at a time.  It keeps the element path's bits: a
// lane's loads hold exactly the columns of 8 of the element path's 256
// threads ("virtual threads"; bf16/fp16 lane l: threads 8l..8l+7, fp32:
// 4l..4l+3 and 128+4l..128+4l+3), each summed over its columns in the same
// order, and `vthread_sum` adds them in the element path's shuffle tree
// (its warp butterflies and its tree over the 8 warp totals mapped onto
// lane and in-lane steps).  The affine step is the FFMA nvcc made of the
// element path's `v * g + b`, written `fmaf`.  Backward: a fixed number
// `parts` of row walkers, each leaving one fp32 partial row of dgamma and
// one of dbeta, which a second small kernel (`ln_bwd_wgrad_kernel`) sums
// per column in a fixed order, so the result is deterministic (no
// atomics).  The element path (`ln_bwd_kernel`) is a block a
// walker: a thread owns the same columns in every row, keeps xhat and gdy
// for them in shared memory between the row's one reduction (mean(gdy),
// mean(gdy * xhat) together, `block_sum2`) and the dx write, and its
// columns' partials in shared memory across the block's rows.  The vector
// path (`ln_bwd_vec_kernel`, under the forward's `vec_route` with dy and
// dx) is a warp a walker: walker p still takes rows p, p + parts, ..., so
// every partial adds the same rows in the same order; a lane holds 8
// virtual threads' columns as the forward does, loads the next row's
// 16-byte words before the current row's sums, reduces both sums by
// shuffles alone in `block_sum2`'s tree (`vthread_sum`), keeps its
// partials in registers (in the warp's slice of shared memory where the
// rows' words would crowd them out) and writes dx 16 bytes at a time, with
// the element path's bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;

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

// Sum of v over the block; every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  const float total = red[32];
  __syncthreads();  // red is reused by the next reduction
  return total;
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
              const W* __restrict__ beta, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int hidden, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* row = reinterpret_cast<float*>(smem_raw);  // hidden floats
  __shared__ float red[33];
  const size_t base = (size_t)blockIdx.x * hidden;
  const T* xr = x + base;
  float s = 0.f;
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    const float v = to_f<T>(xr[i]);
    row[i] = v;  // each thread reads back only the entries it wrote
    s += v;
  }
  const float mean = block_sum(s, red) / (float)hidden;
  float ss = 0.f;
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    const float c = row[i] - mean;
    ss = fmaf(c, c, ss);
  }
  const float var = block_sum(ss, red) / (float)hidden;
  const float rstd = 1.0f / sqrtf(var + eps);  // rsqrtf is approximate
  T* yr = y + base;
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    float v = (row[i] - mean) * rstd;
    if (gamma != nullptr) v = v * to_f<W>(gamma[i]) + to_f<W>(beta[i]);
    yr[i] = from_f<T>(v);
  }
  if (threadIdx.x == 0) {
    mean_out[blockIdx.x] = mean;
    rstd_out[blockIdx.x] = rstd;
  }
}

constexpr int kVecWarps = 4;             // rows a block of the vector path
constexpr int kVecThreads = kVecWarps * 32;
constexpr int kVecMaxHidden = 2048;      // 64 row values a lane in registers

// The 8 values of lane `lane`'s virtual threads j (see the header) from its
// 16-byte words w (one a pass in bf16/fp16: columns 8 lane + j; two in
// fp32: 4 lane + j and 128 + 4 lane + j)
template <typename T, int kWords>
__device__ __forceinline__ void unpack8(const uint4 (&w)[kWords], float (&f)[8]) {
  constexpr int kVec = 16 / sizeof(T);
  static_assert(kWords * kVec == 8, "8 values a lane a pass");
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const T* e = reinterpret_cast<const T*>(&w[i]);
#pragma unroll
    for (int j = 0; j < kVec; ++j) f[i * kVec + j] = to_f<T>(e[j]);
  }
}

// kVec values of W at p (16-byte aligned) as floats
template <typename W, int kVec>
__device__ __forceinline__ void load_w(const W* __restrict__ p, float (&f)[kVec]) {
  constexpr int kWords = kVec * sizeof(W) / 16;
  uint4 w[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) w[i] = reinterpret_cast<const uint4*>(p)[i];
  const W* e = reinterpret_cast<const W*>(w);
#pragma unroll
  for (int j = 0; j < kVec; ++j) f[j] = to_f<W>(e[j]);
}

// The sum over the element path's 256 threads of their partials, each lane
// holding 8 of them (p, in place) as ln_fwd_vec_kernel lays them out, added
// in block_sum's order: its warp butterfly (xor 16, 8, 4, 2, 1 over a
// thread's lane in its warp), then warp 0's over the 8 warp totals (xor 4,
// 2, 1; its xor 16 and 8 add zeros, which change nothing: no partial is
// -0).  bf16/fp16: virtual thread 8 l + j sits in warp l / 4 at lane
// 8 (l % 4) + j, so the butterfly's xor 16 and 8 are lane xor 2 and 1, its
// xor 4, 2, 1 are j's; warp w's total sits in lanes 4 w .. 4 w + 3, so the
// last tree's xor 4, 2, 1 are lane xor 16, 8, 4.  fp32: virtual threads
// 4 l + j (j < 4) and 128 + 4 l + j - 4 sit in warps l / 8 and 4 + l / 8 at
// lane 4 (l % 8) + j % 4: xor 16, 8, 4 are lane xor 4, 2, 1, xor 2 and 1
// are j's; warps w and w + 4 share lanes 8 w .. 8 w + 7, so the last
// tree's xor 4 adds in the lane, its xor 2 and 1 are lane xor 16 and 8.
// Every lane gets the total.
template <int kVec>
__device__ __forceinline__ float vthread_sum(float (&p)[8]) {
  constexpr unsigned kAll = 0xffffffffu;
  if constexpr (kVec == 8) {
#pragma unroll
    for (int o = 2; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] += __shfl_xor_sync(kAll, p[j], o);
    const float a0 = p[0] + p[4], a1 = p[1] + p[5], a2 = p[2] + p[6], a3 = p[3] + p[7];
    float w = (a0 + a2) + (a1 + a3);
#pragma unroll
    for (int o = 16; o >= 4; o >>= 1) w += __shfl_xor_sync(kAll, w, o);
    return w;
  } else {
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] += __shfl_xor_sync(kAll, p[j], o);
    const float wp = (p[0] + p[2]) + (p[1] + p[3]);
    const float wq = (p[4] + p[6]) + (p[5] + p[7]);
    float w = wp + wq;
#pragma unroll
    for (int o = 16; o >= 8; o >>= 1) w += __shfl_xor_sync(kAll, w, o);
    return w;
  }
}

// One warp a row, kVecWarps rows a block; hidden = 256 passes, passes <=
// kPasses.  Lane `lane`'s pass k covers columns 256 k + 128 i + kVec lane
// + j (i < 8 / kVec, j < kVec): the columns the element path's virtual
// threads 128 i + kVec lane + j read in their k-th step.
template <typename T, typename W, int kPasses>
__global__ void __launch_bounds__(kVecThreads)
ln_fwd_vec_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
                  const W* __restrict__ beta, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                  int rows, int hidden, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kWords = 8 / kVec;  // 16-byte words a lane a pass
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kVecWarps + (threadIdx.x >> 5);
  if (r >= rows) return;  // no barrier below
  const int passes = hidden >> 8;
  const size_t base = (size_t)r * hidden;
  const T* xr = x + base;
  uint4 w[kPasses][kWords];
#pragma unroll
  for (int k = 0; k < kPasses; ++k)
    if (k < passes)
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        w[k][i] = *reinterpret_cast<const uint4*>(xr + 256 * k + 128 * i + kVec * lane);
  float v[kPasses][8], p[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) p[j] = 0.f;
#pragma unroll
  for (int k = 0; k < kPasses; ++k)
    if (k < passes) {
      unpack8<T, kWords>(w[k], v[k]);
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] += v[k][j];
    }
  const float mean = vthread_sum<kVec>(p) / (float)hidden;
#pragma unroll
  for (int j = 0; j < 8; ++j) p[j] = 0.f;
#pragma unroll
  for (int k = 0; k < kPasses; ++k)
    if (k < passes)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float c = v[k][j] - mean;
        p[j] = fmaf(c, c, p[j]);
      }
  const float var = vthread_sum<kVec>(p) / (float)hidden;
  const float rstd = 1.0f / sqrtf(var + eps);  // as the element path
  T* yr = y + base;
#pragma unroll
  for (int k = 0; k < kPasses; ++k)
    if (k < passes)
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        const int c0 = 256 * k + 128 * i + kVec * lane;
        float g[kVec], b[kVec];
        if (gamma != nullptr) {
          load_w<W, kVec>(gamma + c0, g);
          load_w<W, kVec>(beta + c0, b);
        }
        uint4 out;
        T* o = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          float t = (v[k][i * kVec + j] - mean) * rstd;
          if (gamma != nullptr) t = fmaf(t, g[j], b[j]);  // the element path's FFMA
          o[j] = from_f<T>(t);
        }
        *reinterpret_cast<uint4*>(yr + c0) = out;
      }
  if (lane == 0) {
    mean_out[r] = mean;
    rstd_out[r] = rstd;
  }
}

// The vector path takes hidden a multiple of 256 (the element path's block
// width, which a warp's 16-byte loads tile exactly in every dtype) up to
// kVecMaxHidden, and 16-byte aligned x, y, gamma and beta (null: no
// affine); anything else the element path
bool vec_route(int hidden, const void* x, const void* gamma, const void* beta,
               const void* y) {
  if (hidden % 256 != 0 || hidden > kVecMaxHidden) return false;
  for (const void* p : {x, gamma, beta, y})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y,
                   void* mean, void* rstd, int rows, int hidden, float eps,
                   cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const W* gp = static_cast<const W*>(gamma);
  const W* bp = static_cast<const W*>(beta);
  T* yp = static_cast<T*>(y);
  float* mp = static_cast<float*>(mean);
  float* rp = static_cast<float*>(rstd);
  if (vec_route(hidden, x, gamma, beta, y)) {
    const unsigned g = (unsigned)((rows + kVecWarps - 1) / kVecWarps);
    const int passes = hidden / 256;
    if (passes <= 1)
      ln_fwd_vec_kernel<T, W, 1><<<g, kVecThreads, 0, stream>>>(xp, gp, bp, yp, mp, rp, rows,
                                                               hidden, eps);
    else if (passes <= 2)
      ln_fwd_vec_kernel<T, W, 2><<<g, kVecThreads, 0, stream>>>(xp, gp, bp, yp, mp, rp, rows,
                                                               hidden, eps);
    else if (passes <= 4)
      ln_fwd_vec_kernel<T, W, 4><<<g, kVecThreads, 0, stream>>>(xp, gp, bp, yp, mp, rp, rows,
                                                               hidden, eps);
    else
      ln_fwd_vec_kernel<T, W, 8><<<g, kVecThreads, 0, stream>>>(xp, gp, bp, yp, mp, rp, rows,
                                                               hidden, eps);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)hidden * sizeof(float);
  ln_fwd_kernel<T, W><<<rows, kThreads, smem, stream>>>(xp, gp, bp, yp, mp, rp, hidden, eps);
  return cudaGetLastError();
}

// The two sums a and b over the block; every thread gets both.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < (int)(blockDim.x >> 5);
    float ta = in ? red[lane] : 0.f;
    float tb = in ? red[32 + lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ta += __shfl_xor_sync(0xffffffffu, ta, o);
      tb += __shfl_xor_sync(0xffffffffu, tb, o);
    }
    if (lane == 0) {
      red[64] = ta;
      red[65] = tb;
    }
  }
  __syncthreads();
  const float2 total = make_float2(red[64], red[65]);
  __syncthreads();  // red is reused by the next row
  return total;
}

// The two expressions of the backward whose rounding nvcc chose in the
// element path, written out so that both paths and the CPU stand-in
// (which contracts nothing) round them alike.  Read on the card against
// builds of the other forms: g = dy * gamma is its own product and s1 += g
// a separate add (an FFMA into s1 gives other bits with fp32 gamma, where
// the product rounds); dx's (gdy - m1) - xhat * m2 is one FFMA (a separate
// product gives other bits everywhere).
__device__ __forceinline__ float ln_gdy(float dyv, float gam, float& s1) {
  const float g = __fmul_rn(dyv, gam);
  s1 += g;
  return g;
}

__device__ __forceinline__ float ln_dx(float rs, float g, float m1, float xh, float m2) {
  return rs * fmaf(-xh, m2, g - m1);
}

// dx for rows blockIdx.x, blockIdx.x + gridDim.x, ...; with gamma, this
// block's dgamma/dbeta partial rows (fp32, one row of `hidden` each).
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
              const T* __restrict__ dy, const float* __restrict__ mean,
              const float* __restrict__ rstd, T* __restrict__ dx,
              float* __restrict__ dgamma_part, float* __restrict__ dbeta_part,
              int rows, int hidden) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);  // xhat, gdy, dgamma part, dbeta part
  float* xh = sm;
  float* gd = sm + hidden;
  float* pg = sm + 2 * hidden;
  float* pb = sm + 3 * hidden;
  __shared__ float red[66];
  const bool affine = gamma != nullptr;
  const float inv_h = 1.0f / (float)hidden;
  if (affine) {
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
      pg[i] = 0.f;
      pb[i] = 0.f;
    }
  }
  // every shared entry is read back only by the thread that wrote it
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const size_t base = (size_t)r * hidden;
    const float mu = mean[r];
    const float rs = rstd[r];
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
      const float xv = (to_f<T>(x[base + i]) - mu) * rs;
      const float dyv = to_f<T>(dy[base + i]);
      float g = dyv;
      if (affine) g = ln_gdy(dyv, to_f<W>(gamma[i]), s1);
      else s1 += g;
      xh[i] = xv;
      gd[i] = g;
      s2 = fmaf(g, xv, s2);
      if (affine) {
        pg[i] = fmaf(dyv, xv, pg[i]);
        pb[i] += dyv;
      }
    }
    const float2 t = block_sum2(s1, s2, red);
    const float m1 = t.x * inv_h;
    const float m2 = t.y * inv_h;
    for (int i = threadIdx.x; i < hidden; i += blockDim.x)
      dx[base + i] = from_f<T>(ln_dx(rs, gd[i], m1, xh[i], m2));
  }
  if (affine) {
    const size_t prow = (size_t)blockIdx.x * hidden;
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
      dgamma_part[prow + i] = pg[i];
      dbeta_part[prow + i] = pb[i];
    }
  }
}

// Whether ln_bwd_vec_kernel<T, *, kPasses> keeps its dgamma/dbeta partials
// in the warp's slice of shared memory rather than in registers: where a
// row's packed x and dy, twice (the row in the sums and the next), would
// crowd 2 * 8 * kPasses partials past the register file (2-byte x at 8
// passes, fp32 x at 4)
template <typename T>
__host__ __device__ constexpr bool bwd_smem_parts(int passes) {
  return passes * (int)sizeof(T) > 8;
}

// The kPasses 16-byte-word sets of row r a lane loads (see ln_fwd_vec_kernel)
template <typename T, int kPasses, int kWords>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int passes, int lane,
                                         uint4 (&w)[kPasses][kWords]) {
  constexpr int kVec = 16 / sizeof(T);
#pragma unroll
  for (int k = 0; k < kPasses; ++k)
    if (k < passes)
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        w[k][i] = *reinterpret_cast<const uint4*>(p + 256 * k + 128 * i + kVec * lane);
}

// One warp a partial, kVecWarps a block: warp p < parts walks rows p,
// p + parts, ... in order, as the element path's block p does, so each
// column's dgamma/dbeta partial adds the same rows in the same order; a
// lane holds the columns of 8 of the element path's virtual threads (as in
// ln_fwd_vec_kernel), sums s1 = sum(gdy) and s2 = sum(gdy * xhat) over
// them in each thread's order and adds the 256 partials in block_sum2's
// tree (vthread_sum), so dx has the element path's bits too.  The next
// row's 16-byte loads are issued before the current row's sums; xhat and
// gdy are recomputed from the packed row for dx (the same expressions,
// the same bits) rather than kept.
template <typename T, typename W, int kPasses>
__global__ void __launch_bounds__(kVecThreads)
ln_bwd_vec_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
                  const T* __restrict__ dy, const float* __restrict__ mean,
                  const float* __restrict__ rstd, T* __restrict__ dx,
                  float* __restrict__ dgamma_part, float* __restrict__ dbeta_part,
                  int rows, int hidden, int parts) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kWords = 8 / kVec;
  constexpr bool kSmem = bwd_smem_parts<T>(kPasses);
  constexpr int kRegPasses = kSmem ? 1 : kPasses;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * kVecWarps + warp;
  if (p >= parts) return;  // no barrier below
  const bool affine = gamma != nullptr;
  const int passes = hidden >> 8;
  const float inv_h = 1.0f / (float)hidden;
  // the partials: registers, or the warp's slice of shared memory laid
  // out [dgamma, dbeta][pass][j][lane], each entry read back by its lane
  float pg[kRegPasses][8], pb[kRegPasses][8];
  float* sp = reinterpret_cast<float*>(smem_raw) + (size_t)warp * 2 * kPasses * 8 * 32 + lane;
  float* sq = sp + kPasses * 8 * 32;
  if (affine) {
#pragma unroll
    for (int k = 0; k < kPasses; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if constexpr (kSmem) {
          sp[(k * 8 + j) * 32] = 0.f;
          sq[(k * 8 + j) * 32] = 0.f;
        } else {
          pg[k][j] = 0.f;
          pb[k][j] = 0.f;
        }
      }
  }
  uint4 cx[kPasses][kWords], cd[kPasses][kWords];
  load_row<T, kPasses, kWords>(x + (size_t)p * hidden, passes, lane, cx);
  load_row<T, kPasses, kWords>(dy + (size_t)p * hidden, passes, lane, cd);
  float mu = mean[p], rs = rstd[p];
  for (int r = p; r < rows; r += parts) {
    const int rn = r + parts;
    uint4 nx[kPasses][kWords], nd[kPasses][kWords];
    float nmu = 0.f, nrs = 0.f;
    if (rn < rows) {
      load_row<T, kPasses, kWords>(x + (size_t)rn * hidden, passes, lane, nx);
      load_row<T, kPasses, kWords>(dy + (size_t)rn * hidden, passes, lane, nd);
      nmu = mean[rn];
      nrs = rstd[rn];
    }
    float s1[8], s2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
#pragma unroll
    for (int k = 0; k < kPasses; ++k)
      if (k < passes) {
        float xv[8], dv[8], gm[8];
        unpack8<T, kWords>(cx[k], xv);
        unpack8<T, kWords>(cd[k], dv);
        if (affine)
#pragma unroll
          for (int i = 0; i < kWords; ++i)
            load_w<W, kVec>(gamma + 256 * k + 128 * i + kVec * lane,
                            *reinterpret_cast<float(*)[kVec]>(gm + i * kVec));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xh = (xv[j] - mu) * rs;
          float g = dv[j];
          if (affine) g = ln_gdy(dv[j], gm[j], s1[j]);
          else s1[j] += g;
          s2[j] = fmaf(g, xh, s2[j]);
          if (affine) {
            if constexpr (kSmem) {
              float* a = sp + (k * 8 + j) * 32;
              float* b = sq + (k * 8 + j) * 32;
              *a = fmaf(dv[j], xh, *a);
              *b += dv[j];
            } else {
              pg[k][j] = fmaf(dv[j], xh, pg[k][j]);
              pb[k][j] += dv[j];
            }
          }
        }
      }
    // the element path's t.x * inv_h, kept a product of its own
    const float m1 = __fmul_rn(vthread_sum<kVec>(s1), inv_h);
    const float m2 = __fmul_rn(vthread_sum<kVec>(s2), inv_h);
    T* dr = dx + (size_t)r * hidden;
#pragma unroll
    for (int k = 0; k < kPasses; ++k)
      if (k < passes) {
        float xv[8], dv[8], gm[8];
        unpack8<T, kWords>(cx[k], xv);
        unpack8<T, kWords>(cd[k], dv);
        if (affine)
#pragma unroll
          for (int i = 0; i < kWords; ++i)
            load_w<W, kVec>(gamma + 256 * k + 128 * i + kVec * lane,
                            *reinterpret_cast<float(*)[kVec]>(gm + i * kVec));
#pragma unroll
        for (int i = 0; i < kWords; ++i) {
          uint4 out;
          T* o = reinterpret_cast<T*>(&out);
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const int c = i * kVec + j;
            const float xh = (xv[c] - mu) * rs;
            const float g = affine ? __fmul_rn(dv[c], gm[c]) : dv[c];
            o[j] = from_f<T>(ln_dx(rs, g, m1, xh, m2));
          }
          *reinterpret_cast<uint4*>(dr + 256 * k + 128 * i + kVec * lane) = out;
        }
      }
#pragma unroll
    for (int k = 0; k < kPasses; ++k)
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        cx[k][i] = nx[k][i];
        cd[k][i] = nd[k][i];
      }
    mu = nmu;
    rs = nrs;
  }
  if (!affine) return;
  float* gp = dgamma_part + (size_t)p * hidden;
  float* bp = dbeta_part + (size_t)p * hidden;
#pragma unroll
  for (int k = 0; k < kPasses; ++k)
    if (k < passes)
#pragma unroll
      for (int i = 0; i < kWords; ++i)
#pragma unroll
        for (int q = 0; q < kVec; q += 4) {
          float a[4], b[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = i * kVec + q + j;
            if constexpr (kSmem) {
              a[j] = sp[(k * 8 + c) * 32];
              b[j] = sq[(k * 8 + c) * 32];
            } else {
              a[j] = pg[k][c];
              b[j] = pb[k][c];
            }
          }
          const int col = 256 * k + 128 * i + kVec * lane + q;
          *reinterpret_cast<float4*>(gp + col) = make_float4(a[0], a[1], a[2], a[3]);
          *reinterpret_cast<float4*>(bp + col) = make_float4(b[0], b[1], b[2], b[3]);
        }
}

constexpr int kColTile = 32;  // columns per block of the partial sum
constexpr int kPartLanes = 8;  // partial rows summed in parallel per column

// dgamma/dbeta = the per-column sums of the parts partial rows, in a
// fixed order, cast once to gamma's dtype.
template <typename W>
__global__ void __launch_bounds__(kColTile * kPartLanes)
ln_bwd_wgrad_kernel(const float* __restrict__ dgamma_part,
                    const float* __restrict__ dbeta_part, W* __restrict__ dgamma,
                    W* __restrict__ dbeta, int parts, int hidden) {
  __shared__ float sg[kPartLanes][kColTile];
  __shared__ float sb[kPartLanes][kColTile];
  const int c = threadIdx.x % kColTile;
  const int lane = threadIdx.x / kColTile;
  const int col = blockIdx.x * kColTile + c;
  float a = 0.f, b = 0.f;
  if (col < hidden) {
    for (int p = lane; p < parts; p += kPartLanes) {
      a += dgamma_part[(size_t)p * hidden + col];
      b += dbeta_part[(size_t)p * hidden + col];
    }
  }
  sg[lane][c] = a;
  sb[lane][c] = b;
  __syncthreads();
  if (lane == 0 && col < hidden) {
#pragma unroll
    for (int k = 1; k < kPartLanes; ++k) {
      a += sg[k][c];
      b += sb[k][c];
    }
    dgamma[col] = from_f<W>(a);
    dbeta[col] = from_f<W>(b);
  }
}

template <typename T, typename W, int kPasses>
cudaError_t launch_bwd_vec(const T* x, const W* gamma, const T* dy, const float* mean,
                           const float* rstd, T* dx, float* dgamma_part,
                           float* dbeta_part, int rows, int hidden, int parts,
                           cudaStream_t stream) {
  const size_t smem = bwd_smem_parts<T>(kPasses) && gamma != nullptr
                          ? (size_t)kVecWarps * 2 * kPasses * 8 * 32 * sizeof(float)
                          : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ln_bwd_vec_kernel<T, W, kPasses>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const unsigned g = (unsigned)((parts + kVecWarps - 1) / kVecWarps);
  ln_bwd_vec_kernel<T, W, kPasses><<<g, kVecThreads, smem, stream>>>(
      x, gamma, dy, mean, rstd, dx, dgamma_part, dbeta_part, rows, hidden, parts);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_bwd(const void* x, const void* gamma, const void* dy,
                       const void* mean, const void* rstd, void* dx,
                       void* dgamma_part, void* dbeta_part, void* dgamma,
                       void* dbeta, int rows, int hidden, int parts,
                       cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const W* gp = static_cast<const W*>(gamma);
  const T* dyp = static_cast<const T*>(dy);
  const float* mp = static_cast<const float*>(mean);
  const float* rp = static_cast<const float*>(rstd);
  T* dxp = static_cast<T*>(dx);
  float* pgp = static_cast<float*>(dgamma_part);
  float* pbp = static_cast<float*>(dbeta_part);
  cudaError_t e = cudaSuccess;
  // the vector path under the forward's rule, with dy and dx for y and
  // beta; fp32 rows past 1024 columns (two rows' words alone would fill
  // the register file) take the element path
  if (vec_route(hidden, x, gamma, dy, dx) && (sizeof(T) == 2 || hidden <= 1024)) {
    const int passes = hidden / 256;
    if (passes <= 1)
      e = launch_bwd_vec<T, W, 1>(xp, gp, dyp, mp, rp, dxp, pgp, pbp, rows, hidden, parts,
                                  stream);
    else if (passes <= 2)
      e = launch_bwd_vec<T, W, 2>(xp, gp, dyp, mp, rp, dxp, pgp, pbp, rows, hidden, parts,
                                  stream);
    else if (passes <= 4)
      e = launch_bwd_vec<T, W, 4>(xp, gp, dyp, mp, rp, dxp, pgp, pbp, rows, hidden, parts,
                                  stream);
    else if constexpr (sizeof(T) == 2)
      e = launch_bwd_vec<T, W, 8>(xp, gp, dyp, mp, rp, dxp, pgp, pbp, rows, hidden, parts,
                                  stream);
  } else {
    const size_t smem = (size_t)4 * hidden * sizeof(float);
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(ln_bwd_kernel<T, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    ln_bwd_kernel<T, W><<<parts, kThreads, smem, stream>>>(xp, gp, dyp, mp, rp, dxp, pgp,
                                                           pbp, rows, hidden);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess || gamma == nullptr) return e;
  const int blocks = (hidden + kColTile - 1) / kColTile;
  ln_bwd_wgrad_kernel<W><<<blocks, kColTile * kPartLanes, 0, stream>>>(
      pgp, pbp, static_cast<W*>(dgamma), static_cast<W*>(dbeta), parts, hidden);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// dtype codes: 0 float32, 1 bfloat16, 2 float16.  gamma/beta may be
// null (no affine); w_dtype is then ignored.  hidden * 4 bytes (at most
// 8192 floats) plus the reduction scratch fit 48 KB of shared memory.
int apex_layer_norm_fwd(const void* x, const void* gamma, const void* beta,
                        void* y, void* mean, void* rstd, int rows, int hidden,
                        float eps, int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || hidden <= 0 || hidden > 8192) return cudaErrorInvalidValue;
  if (gamma == nullptr) w_dtype = 0;
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, gamma, beta, y, mean, rstd, rows, hidden, eps, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, mean, rstd, rows,
                                                hidden, eps, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, gamma, beta, y, mean, rstd, rows, hidden,
                                        eps, s);
  if (x_dtype == 2 && w_dtype == 2)
    return launch<__half, __half>(x, gamma, beta, y, mean, rstd, rows, hidden, eps, s);
  if (x_dtype == 2 && w_dtype == 0)
    return launch<__half, float>(x, gamma, beta, y, mean, rstd, rows, hidden, eps, s);
  return cudaErrorInvalidValue;
}

// Backward.  x, dy, dx (rows, hidden) of dtype x_dtype; mean/rstd (rows,)
// fp32 from the forward; gamma (hidden,) of w_dtype (x's or float32) or
// null (no affine: dgamma/dbeta and the partial buffers are then not
// touched).  dgamma_part/dbeta_part: fp32 scratch of parts * hidden,
// where parts (1..rows) is the number of row-walking blocks; dgamma and
// dbeta (hidden,) of w_dtype.  hidden <= 8192 (4 * hidden floats of
// shared memory per block).
int apex_layer_norm_bwd(const void* x, const void* gamma, const void* dy,
                        const void* mean, const void* rstd, void* dx,
                        void* dgamma_part, void* dbeta_part, void* dgamma,
                        void* dbeta, int rows, int hidden, int parts,
                        int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || hidden <= 0 || hidden > 8192 || parts <= 0 || parts > rows)
    return cudaErrorInvalidValue;
  if (gamma == nullptr) w_dtype = 0;
#define APEX_LN_BWD(T, W)                                                      \
  return launch_bwd<T, W>(x, gamma, dy, mean, rstd, dx, dgamma_part, dbeta_part, \
                          dgamma, dbeta, rows, hidden, parts, s)
  if (x_dtype == 0 && w_dtype == 0) APEX_LN_BWD(float, float);
  if (x_dtype == 1 && w_dtype == 1) APEX_LN_BWD(__nv_bfloat16, __nv_bfloat16);
  if (x_dtype == 1 && w_dtype == 0) APEX_LN_BWD(__nv_bfloat16, float);
  if (x_dtype == 2 && w_dtype == 2) APEX_LN_BWD(__half, __half);
  if (x_dtype == 2 && w_dtype == 0) APEX_LN_BWD(__half, float);
#undef APEX_LN_BWD
  return cudaErrorInvalidValue;
}

}  // extern "C"
