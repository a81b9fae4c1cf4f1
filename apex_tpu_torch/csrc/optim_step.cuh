// Shared by csrc/fused_sgd.cu and csrc/fused_adam.cu: the element loads
// and casts of their sweeps, and the leaf table that lets one launch step
// many leaves (the multi-tensor steps of row 19).
//
// A leaf table is the kernel's whole parameter block, passed by value:
// for each leaf its pointers (g, p, the state, lowp or null), its length,
// a running prefix of its chunk counts and whether all its pointers are
// aligned for the vector loads.  Block b steps chunk b - start[l] of the
// leaf l with start[l] <= b < start[l + 1], found by a binary search over
// the prefix.  The block is sized to the parameter budget below, so a
// launch takes at most `StepTable<...>::kCap` leaves; the caller launches
// again for the rest.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

constexpr int kThreads = 256;
// vectors of 4 elements a thread loads before it computes any (a leaf
// step's loads in flight)
constexpr int kUnroll = 4;

// four elements of T at p (aligned for the vector width) as fp32
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* i) {
    *reinterpret_cast<float4*>(p) = make_float4(i[0], i[1], i[2], i[3]);
  }
};
template <typename H> struct Vec4Half {
  static __device__ __forceinline__ void load(const H* p, float* o) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const H* h = reinterpret_cast<const H*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = to_f<H>(h[e]);
  }
  static __device__ __forceinline__ void store(H* p, const float* i) {
    uint2 u;
    H* h = reinterpret_cast<H*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = from_f<H>(i[e]);
    *reinterpret_cast<uint2*>(p) = u;
  }
};
template <> struct Vec4<__nv_bfloat16> : Vec4Half<__nv_bfloat16> {};
template <> struct Vec4<__half> : Vec4Half<__half> {};

// the copy's type L: float stands for none (the master is the model copy)
template <typename L> constexpr int kHasLowp = std::is_same<L, float>::value ? 0 : 1;

// f(G*, L*) (null tags) for the dtype codes: g 0 float32, 1 bfloat16, 2
// float16; the copy 0 none, 1 bfloat16, 2 float16
template <typename G, typename F>
cudaError_t with_lowp(int lowp_dtype, F& f) {
  switch (lowp_dtype) {
    case 0: return f(static_cast<G*>(nullptr), static_cast<float*>(nullptr));
    case 1: return f(static_cast<G*>(nullptr), static_cast<__nv_bfloat16*>(nullptr));
    case 2: return f(static_cast<G*>(nullptr), static_cast<__half*>(nullptr));
    default: return cudaErrorInvalidValue;
  }
}
template <typename F>
cudaError_t with_types(int g_dtype, int lowp_dtype, F&& f) {
  switch (g_dtype) {
    case 0: return with_lowp<float>(lowp_dtype, f);
    case 1: return with_lowp<__nv_bfloat16>(lowp_dtype, f);
    case 2: return with_lowp<__half>(lowp_dtype, f);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return ptr == nullptr || (reinterpret_cast<uintptr_t>(ptr) % bytes) == 0;
}

// The SM count of the current device, asked of the runtime once a device.
cudaError_t sm_count(int* sms) {
  static int cache[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidValue;
  if (cache[dev] == 0) {
    int v = 0;
    e = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    cache[dev] = v;
  }
  *sms = cache[dev];
  return cudaSuccess;
}

// blocks for `work` threads' worth of elements: enough to fill the card,
// at most 8 resident blocks of 256 per SM (a grid-stride loop does the rest)
cudaError_t grid_for(long long work, long long* blocks) {
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  long long b = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 8;
  if (b > cap) b = cap;
  if (b < 1) b = 1;
  *blocks = b;
  return cudaSuccess;
}

// The parameter block's budget: 4,096 bytes, the limit every toolkit
// takes.  CUDA 12.1 raised it to 32,764 on Volta and later: on the H100
// such a table steps ResNet-50's 161 leaves in 2 launches instead of 3,
// 1.4-1.7 % less device time (PERF.md, row 19), for 8 times the bytes
// every launch passes and a toolkit floor; not taken.
constexpr int kParamBytes = 4096;

// H the hyperparameters, kPtrs the pointers a leaf (g, p, the state, lowp)
template <typename H, int kPtrs> struct StepTable {
  // H rounded to 8 bytes, count and chunk, the prefix's last entry, padding
  static constexpr int kFixed = (int)((sizeof(H) + 7) / 8 * 8) + 24;
  // a leaf: its pointers, its length, its prefix entry, its flag
  static constexpr int kCap = (kParamBytes - kFixed) / (8 * kPtrs + 8 + 4 + 1);
  H h;
  int count;  // leaves in this launch
  int chunk;  // elements a block (a multiple of 4)
  void* ptr[kPtrs][kCap];
  long long n[kCap];
  int start[kCap + 1];  // start[l]: the first block of leaf l; start[count]: the grid
  unsigned char vec[kCap];
};

// the leaf whose chunks hold block b: the last l with start[l] <= b (a leaf
// of no chunk never holds one)
template <typename T>
__device__ __forceinline__ int leaf_of(const T& t, int b) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Fill t from `count` rows of kPtrs pointers (`ptrs`, row-major; the last,
// lowp, null in every row when `has_lowp` is 0, in none when it is 1) and
// their lengths; width[k]: the bytes a vector load of pointer k takes.
// Leaves of no element take no block.  The grid is t.start[t.count].
template <typename T, int kPtrs>
cudaError_t fill_table(T& t, const long long* ptrs, const long long* ns, int count,
                       int chunk, int has_lowp, const int (&width)[kPtrs]) {
  if (count < 1 || count > T::kCap || chunk < 4 || chunk % 4 != 0)
    return cudaErrorInvalidValue;
  t.count = count;
  t.chunk = chunk;
  long long blocks = 0;
  for (int l = 0; l < count; ++l) {
    const long long n = ns[l];
    if (n < 0) return cudaErrorInvalidValue;
    bool vec = true;
    for (int k = 0; k < kPtrs; ++k) {
      void* p = reinterpret_cast<void*>(ptrs[(long long)l * kPtrs + k]);
      // an empty tensor may hold no storage: its pointers are not read
      const bool want = k < kPtrs - 1 || has_lowp;
      if (n > 0 && (p != nullptr) != want) return cudaErrorInvalidValue;
      t.ptr[k][l] = p;
      vec = vec && aligned(p, width[k]);
    }
    t.n[l] = n;
    t.vec[l] = vec ? 1 : 0;
    t.start[l] = (int)blocks;
    blocks += (n + chunk - 1) / chunk;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
  }
  t.start[count] = (int)blocks;
  return cudaSuccess;
}

}  // namespace
