// Causal and padding-mask scaled softmax forwards and the softmax
// backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Forward replaces: apex_tpu/ops/scaled_softmax.py `_causal_fwd` (Pallas
// kernel `_causal_fwd_kernel`): over (rows = b * sq, sk) attention
// scores, y = softmax(scale * x) along each row with column c kept only
// where c <= the row's query index (row % sq); masked entries take -1e30
// before the max there, so they come out exactly 0.  Math is fp32
// whatever x's dtype; y has x's dtype.
//
// Padding-mask forward replaces: apex_tpu/ops/scaled_softmax.py
// `_masked_fwd` (Pallas kernel `_masked_fwd_kernel`, row 5 of the kernel
// table): over (b, np, sq, sk) scores and a (b, 1, sq, sk) mask, y =
// softmax(scale * x) along each row with the entries where the mask is
// nonzero filled with the finite -1e30 before the max.  A fully masked row
// (BERT's extended mask masks every padded query row whole) then has max
// -1e30 and comes out uniform, 1/sk: the finite fill is what keeps it off
// -inf - (-inf) = NaN.  The mask is read once per (b, row) and shared by
// the np heads through a zero head stride, never copied per head.
//
// Backward replaces: apex_tpu/ops/scaled_softmax.py `_softmax_backward`
// (Pallas kernel `_softmax_bwd_kernel`): dx = scale * y * (dy - sum(y *
// dy)) per row, the sum in fp32 over the whole row, dx in y's dtype.
//
// What bounds both on the H100: bytes.  About 5 operations per element
// against 8 (forward, fp32) or 12 (backward) bytes moved: one stream with
// no reuse.  At the O2 train step's (128, 1024, 1024) fp32 scores the
// forward moves at most 1.07 GB (0.32 ms at 3.35 TB/s; 0.24 ms when the
// upper triangle is not read) and the backward 1.61 GB (0.48 ms).  The
// padding-mask forward at BERT-large's O2 step, (16, 16, 512, 512) fp32
// scores, moves 537 MB of scores and a 4 MB mask (0.16 ms).
//
// What the simple design does about it: one warp per row, each element
// read from device memory once and written once.  For sk <= 1024 a lane
// keeps its columns (lane, lane + 32, ...) in registers between the row's
// max, its sum and the write; longer rows take a looped variant that
// reads the row twice (an online max/sum pass, then the write).  The
// forward never reads the masked upper triangle, only writes its zeros.
// Lanes touch neighbouring addresses, so every load and store is one
// 128-byte transaction per warp (fp32).
//
// The padding-mask forward (`masked_fwd_kernel`) moves 16 bytes a lane a
// load: one warp per (b, head, row), a block of 8 warps over 8
// consecutive rows, each lane's load j the 8 fp16 / bf16 (4 fp32) scores
// from column (32 j + lane) * 8 (* 4) and the 8 (4) mask bytes beside
// them, so a warp's load covers 512 contiguous bytes of scores; every load
// of the row is issued before its max (2 a lane at sk = 512 in fp16, 4 in
// fp32), the row stays in registers, and the stores are 16 bytes a lane.
// The row's sum keeps the element path's order (the exps pass through the
// warp's slice of shared memory, lane l adding columns l, l + 32, ...),
// so the two paths, and the kernel before them, give the same bits: the
// BERT O2 loss checks, read at one seed, see no change.  The division by
// the sum is one reciprocal a row and Markstein's correction an element
// (three operations against IEEE division's eight or so; the IEEE
// quotient bit for bit wherever the numerator is at least 2^-100), which
// the fp16 kernel's issue rate needed; at up to 16 elements a lane the
// registers leave room for 8 blocks an SM in fp16 / bf16 (64 rows in
// flight), 6 in fp32.  On the
// H100 at BERT-large's (16, 16, 512, 512) scores, a two-row lookahead a
// warp ran slower (more registers, fewer warps).  sk off the vector
// width, a misaligned pointer, or sk > 1024 take the element path
// (`masked_fwd_elem_kernel`, one element and one mask byte a load, the
// looped variant past 1024).  The mask row is read once per (b, row) of a
// head and shared by the np heads through a zero head stride.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, one row each
constexpr int kWarps = kThreads / 32;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kPer > 0: the row (sk <= 32 * kPer) stays in registers, kPer columns a
// lane.  kPer == 0: any sk, the row is read twice.
template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads)
causal_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, long long rows, int sq,
                  int sk, float scale) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int kept = min((int)(row % sq) + 1, sk);  // columns 0 .. row % sq
  const T* xr = x + row * (long long)sk;
  T* yr = y + row * (long long)sk;
  if constexpr (kPer > 0) {
    float v[kPer];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < kept ? to_f<T>(xr[c]) * scale : -INFINITY;
      m = fmaxf(m, v[i]);
    }
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < kept ? expf(v[i] - m) : 0.f;
      s += v[i];
    }
    s = warp_sum(s);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      if (c < sk) yr[c] = from_f<T>(v[i] / s);  // v is 0 above the diagonal
    }
  } else {
    // online max and sum over the kept columns, then the write
    float m = -INFINITY, s = 0.f;
    for (int c = lane; c < kept; c += 32) {
      const float v = to_f<T>(xr[c]) * scale;
      const float mn = fmaxf(m, v);
      s = s * expf(m - mn) + expf(v - mn);
      m = mn;
    }
    const float mw = warp_max(m);
    s = warp_sum(m == -INFINITY ? 0.f : s * expf(m - mw));
    for (int c = lane; c < sk; c += 32)
      yr[c] = from_f<T>(c < kept ? expf(to_f<T>(xr[c]) * scale - mw) / s : 0.f);
  }
}

// the word of N bytes one load moves
template <int N> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = uint32_t; };

// a / b from r = 1 / b (correctly rounded) in three operations: q0 = a r,
// its remainder a - q0 b exact in one fma, q0 corrected by it
// (Markstein).  The IEEE quotient, bit for bit, wherever a >= 2^-100 (the
// remainder does not underflow); below, within an ulp of a value under
// 1e-30.  One division a row instead of one an element.
__device__ __forceinline__ float div_by(float a, float b, float r) {
  const float q0 = a * r;
  return fmaf(fmaf(-q0, b, a), r, q0);
}

// rows = b * np * sq; row r is query r % sq of head (r / sq) % np of batch
// r / (np * sq), and reads mask row (batch * mask_sb) + (r % sq) * sk.  One
// warp a row: lane load j covers kVec = 16 / sizeof(T) consecutive columns
// from (32 j + lane) kVec, 16 bytes of scores and the kVec mask bytes
// beside them, all kVecs loads issued before the row's max; the row (sk <=
// 32 kVecs kVec) stays in registers between its max, its sum and its
// 16-byte stores.  The sum keeps the element path's order: the exps pass
// through the warp's slice of shared memory, lane l adds columns l, l +
// 32, ... in turn, and the lanes' sums meet in the same butterfly, so the
// output is bit for bit the element path's (the quotient aside, see
// div_by).  Up to 16 elements a lane (sk <= 512), registers for 8 blocks
// an SM in fp16 / bf16 (64 rows in flight) and 6 in fp32 (8 spilled, and
// ran slower on the H100).
template <typename T, int kVecs>
__global__ void __launch_bounds__(kThreads,
                                  kVecs * 16 / sizeof(T) <= 16 ? (sizeof(T) == 4 ? 6 : 8) : 1)
masked_fwd_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                  T* __restrict__ y, long long rows, int np, int sq, int sk,
                  long long mask_sb, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPer = kVecs * kVec;
  using MW = typename Word<kVec>::type;
  constexpr float kFill = -1e30f;  // the JAX kernel's finite fill
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long per_b = (long long)np * sq;
  const T* xr = x + row * (long long)sk;
  const uint8_t* mr = mask + row / per_b * mask_sb + (long long)(row % sq) * sk;
  T* yr = y + row * (long long)sk;
  uint4 xv[kVecs];
  MW mv[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = (32 * i + lane) * kVec;
    xv[i] = make_uint4(0, 0, 0, 0);
    mv[i] = MW{};
    if (c < sk) {
      xv[i] = *reinterpret_cast<const uint4*>(xr + c);
      mv[i] = *reinterpret_cast<const MW*>(mr + c);
    }
  }
  float v[kPer];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = (32 * i + lane) * kVec;
    const T* e = reinterpret_cast<const T*>(&xv[i]);
    const uint8_t* mb = reinterpret_cast<const uint8_t*>(&mv[i]);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v[i * kVec + j] = c < sk ? (mb[j] ? kFill : to_f<T>(e[j]) * scale) : -INFINITY;
      mx = fmaxf(mx, v[i * kVec + j]);
    }
  }
  mx = warp_max(mx);  // >= -1e30: finite whatever the mask
  __shared__ __align__(16) float exps[kWarps][32 * kPer];
  float* ex = exps[threadIdx.x >> 5];
#pragma unroll
  for (int i = 0; i < kVecs; ++i)
#pragma unroll
    for (int j = 0; j < kVec; j += 4) {
      float4 e4;
      e4.x = v[i * kVec + j] = expf(v[i * kVec + j] - mx);  // past sk: exp(-inf) = 0
      e4.y = v[i * kVec + j + 1] = expf(v[i * kVec + j + 1] - mx);
      e4.z = v[i * kVec + j + 2] = expf(v[i * kVec + j + 2] - mx);
      e4.w = v[i * kVec + j + 3] = expf(v[i * kVec + j + 3] - mx);
      *reinterpret_cast<float4*>(ex + (32 * i + lane) * kVec + j) = e4;
    }
  __syncwarp();
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kPer; ++c) sum += ex[lane + 32 * c];
  sum = warp_sum(sum);
  const float rcp = 1.f / sum;  // the one division
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = (32 * i + lane) * kVec;
    if (c >= sk) continue;
    uint4 out;
    T* e = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < kVec; ++j) e[j] = from_f<T>(div_by(v[i * kVec + j], sum, rcp));
    *reinterpret_cast<uint4*>(yr + c) = out;
  }
}

// The element path of masked_fwd_kernel: sk off the 16-byte vector or a
// misaligned pointer (kPer > 0, one element and one mask byte a load), or
// sk > 1024 (kPer == 0, any alignment).  Rows and kPer as there and in
// causal_fwd_kernel.
template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads)
masked_fwd_elem_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                  T* __restrict__ y, long long rows, int np, int sq, int sk,
                  long long mask_sb, float scale) {
  constexpr float kFill = -1e30f;  // the JAX kernel's finite fill
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long per_b = (long long)np * sq;
  const long long bi = row / per_b;
  const int qi = (int)(row % sq);
  const T* xr = x + row * (long long)sk;
  const uint8_t* mr = mask + bi * mask_sb + (long long)qi * sk;
  T* yr = y + row * (long long)sk;
  if constexpr (kPer > 0) {
    float v[kPer];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < sk ? (mr[c] ? kFill : to_f<T>(xr[c]) * scale) : -INFINITY;
      m = fmaxf(m, v[i]);
    }
    m = warp_max(m);  // >= -1e30: finite whatever the mask
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      v[i] = expf(v[i] - m);  // past sk: exp(-inf) = 0
      s += v[i];
    }
    s = warp_sum(s);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      if (c < sk) yr[c] = from_f<T>(v[i] / s);
    }
  } else {
    float m = -INFINITY, s = 0.f;
    for (int c = lane; c < sk; c += 32) {
      const float v = mr[c] ? kFill : to_f<T>(xr[c]) * scale;
      const float mn = fmaxf(m, v);
      s = s * expf(m - mn) + expf(v - mn);
      m = mn;
    }
    const float mw = warp_max(m);
    s = warp_sum(m == -INFINITY ? 0.f : s * expf(m - mw));
    for (int c = lane; c < sk; c += 32)
      yr[c] = from_f<T>(expf((mr[c] ? kFill : to_f<T>(xr[c]) * scale) - mw) / s);
  }
}

template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads)
softmax_bwd_kernel(const T* __restrict__ y, const T* __restrict__ dy, T* __restrict__ dx,
                   long long rows, int sk, float scale) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long base = row * (long long)sk;
  const T* yr = y + base;
  const T* dyr = dy + base;
  T* dxr = dx + base;
  if constexpr (kPer > 0) {
    float yv[kPer], dv[kPer];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      yv[i] = c < sk ? to_f<T>(yr[c]) : 0.f;
      dv[i] = c < sk ? to_f<T>(dyr[c]) : 0.f;
      if (c < sk) s += yv[i] * dv[i];
    }
    s = warp_sum(s);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      if (c < sk) dxr[c] = from_f<T>(scale * yv[i] * (dv[i] - s));
    }
  } else {
    float s = 0.f;
    for (int c = lane; c < sk; c += 32) s += to_f<T>(yr[c]) * to_f<T>(dyr[c]);
    s = warp_sum(s);
    for (int c = lane; c < sk; c += 32)
      dxr[c] = from_f<T>(scale * to_f<T>(yr[c]) * (to_f<T>(dyr[c]) - s));
  }
}

unsigned grid_for(long long rows) { return (unsigned)((rows + kWarps - 1) / kWarps); }

template <typename T>
cudaError_t launch_fwd(const void* x, void* y, long long rows, int sq, int sk, float scale,
                       cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const unsigned g = grid_for(rows);
  if (sk <= 128)
    causal_fwd_kernel<T, 4><<<g, kThreads, 0, st>>>(xp, yp, rows, sq, sk, scale);
  else if (sk <= 256)
    causal_fwd_kernel<T, 8><<<g, kThreads, 0, st>>>(xp, yp, rows, sq, sk, scale);
  else if (sk <= 512)
    causal_fwd_kernel<T, 16><<<g, kThreads, 0, st>>>(xp, yp, rows, sq, sk, scale);
  else if (sk <= 1024)
    causal_fwd_kernel<T, 32><<<g, kThreads, 0, st>>>(xp, yp, rows, sq, sk, scale);
  else
    causal_fwd_kernel<T, 0><<<g, kThreads, 0, st>>>(xp, yp, rows, sq, sk, scale);
  return cudaGetLastError();
}

// The padding-mask forward: 16-byte loads where sk (at most 1024) is a
// multiple of the vector and every pointer and plane stride is aligned to
// its load, else the element path (the row in registers up to 1024
// columns, the looped variant beyond)
template <typename T>
cudaError_t launch_masked(const void* x, const void* mask, void* y, long long rows,
                          int np, int sq, int sk, long long mask_sb, float scale,
                          cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  T* yp = static_cast<T*>(y);
  const unsigned g = grid_for(rows);
  const bool vec = sk <= 1024 && sk % kVec == 0 && mask_sb % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % kVec == 0;
  if (vec) {
    const int per = (sk + 32 * kVec - 1) / (32 * kVec);  // loads a lane
    if (per <= 1)
      masked_fwd_kernel<T, 1><<<g, kThreads, 0, st>>>(xp, mp, yp, rows, np, sq, sk, mask_sb, scale);
    else if (per <= 2)
      masked_fwd_kernel<T, 2><<<g, kThreads, 0, st>>>(xp, mp, yp, rows, np, sq, sk, mask_sb, scale);
    else if (kVec == 8 || per <= 4)
      masked_fwd_kernel<T, 4><<<g, kThreads, 0, st>>>(xp, mp, yp, rows, np, sq, sk, mask_sb, scale);
    else if constexpr (kVec == 4)  // fp32 rows of 513 to 1024 columns
      masked_fwd_kernel<T, 8><<<g, kThreads, 0, st>>>(xp, mp, yp, rows, np, sq, sk, mask_sb, scale);
  } else if (sk <= 128)
    masked_fwd_elem_kernel<T, 4><<<g, kThreads, 0, st>>>(xp, mp, yp, rows, np, sq, sk, mask_sb, scale);
  else if (sk <= 256)
    masked_fwd_elem_kernel<T, 8><<<g, kThreads, 0, st>>>(xp, mp, yp, rows, np, sq, sk, mask_sb, scale);
  else if (sk <= 512)
    masked_fwd_elem_kernel<T, 16><<<g, kThreads, 0, st>>>(xp, mp, yp, rows, np, sq, sk, mask_sb, scale);
  else if (sk <= 1024)
    masked_fwd_elem_kernel<T, 32><<<g, kThreads, 0, st>>>(xp, mp, yp, rows, np, sq, sk, mask_sb, scale);
  else
    masked_fwd_elem_kernel<T, 0><<<g, kThreads, 0, st>>>(xp, mp, yp, rows, np, sq, sk, mask_sb, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* y, const void* dy, void* dx, long long rows, int sk,
                       float scale, cudaStream_t st) {
  const T* yp = static_cast<const T*>(y);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  const unsigned g = grid_for(rows);
  if (sk <= 128)
    softmax_bwd_kernel<T, 4><<<g, kThreads, 0, st>>>(yp, dyp, dxp, rows, sk, scale);
  else if (sk <= 256)
    softmax_bwd_kernel<T, 8><<<g, kThreads, 0, st>>>(yp, dyp, dxp, rows, sk, scale);
  else if (sk <= 512)
    softmax_bwd_kernel<T, 16><<<g, kThreads, 0, st>>>(yp, dyp, dxp, rows, sk, scale);
  else if (sk <= 1024)
    softmax_bwd_kernel<T, 32><<<g, kThreads, 0, st>>>(yp, dyp, dxp, rows, sk, scale);
  else
    softmax_bwd_kernel<T, 0><<<g, kThreads, 0, st>>>(yp, dyp, dxp, rows, sk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// x, y: (rows, sk) contiguous of dtype (0 float32, 1 bfloat16, 2 float16);
// row r is query row r % sq of its (sq, sk) score matrix.
int apex_causal_softmax_fwd(const void* x, void* y, long long rows, int sq, int sk,
                            float scale, int dtype, void* stream) {
  if (rows < 0 || sq <= 0 || sk <= 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_fwd<float>(x, y, rows, sq, sk, scale, s);
    case 1: return launch_fwd<__nv_bfloat16>(x, y, rows, sq, sk, scale, s);
    case 2: return launch_fwd<__half>(x, y, rows, sq, sk, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// x, y: (b, np, sq, sk) contiguous of dtype; mask: (b, 1, sq, sk) bytes,
// nonzero = masked, each (sq, sk) plane contiguous, batch planes mask_sb
// bytes apart (0: one plane for every batch).
int apex_masked_softmax_fwd(const void* x, const void* mask, void* y, int b, int np,
                            int sq, int sk, long long mask_sb, float scale, int dtype,
                            void* stream) {
  if (b < 0 || np <= 0 || sq <= 0 || sk <= 0 || mask_sb < 0)
    return cudaErrorInvalidValue;
  const long long rows = (long long)b * np * sq;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_masked<float>(x, mask, y, rows, np, sq, sk, mask_sb, scale, s);
    case 1:
      return launch_masked<__nv_bfloat16>(x, mask, y, rows, np, sq, sk, mask_sb, scale, s);
    case 2: return launch_masked<__half>(x, mask, y, rows, np, sq, sk, mask_sb, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// y, dy, dx: (rows, sk) contiguous, all of dtype.
int apex_softmax_bwd(const void* y, const void* dy, void* dx, long long rows, int sk,
                     float scale, int dtype, void* stream) {
  if (rows < 0 || sk <= 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_bwd<float>(y, dy, dx, rows, sk, scale, s);
    case 1: return launch_bwd<__nv_bfloat16>(y, dy, dx, rows, sk, scale, s);
    case 2: return launch_bwd<__half>(y, dy, dx, rows, sk, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
