// Paged flash-decode for Hopper (sm_90a), plain C interface.
//
// Replaces: apex_tpu/ops/flash_decode.py `_decode_paged` (Pallas kernel
// `_decode_kernel`) with a float KV cache: one query row per sequence
// attending over its block-paged history.  q (b, h, d); k/v cache
// (nb, h, bs, d) block-major; block_tables (b, max_pages) int32;
// seq_lens (b,) int32.  Positions >= seq_len are masked, pages wholly
// past seq_len are skipped, and a row with seq_len == 0 emits exactly 0.
//
// What bounds it on the H100: bytes.  Each cached key and value is read
// once for about 4 operations per element, so the k/v stream over
// device memory is the whole cost at any batch a decode step runs.
//
// What the simple design does about it: one block per (head, batch row)
// with d threads.  On the TPU the page ids rode scalar prefetch into the
// pipeline's index map; here the block reads its own row of
// block_tables and its seq_len and walks only the pages that hold
// positions < seq_len, so a bucket's padded pages cost nothing.  Per
// page, each warp takes every (d/32)-th key and reduces q.k across its
// lanes (reads of a key row are contiguous across the warp), the page's
// scores go to shared memory, and each thread then owns one output
// dimension: it rescales its fp32 accumulator once per page (online
// softmax) and adds p * v, reading each v row contiguously across the
// block.  The straddling page is masked by global position.  Later work:
// more keys in flight per block and split-k over pages for long
// sequences at small batch.
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

constexpr int kMaxBlockSize = 256;

template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ block_tables,
              const int* __restrict__ seq_lens, T* __restrict__ out, int h,
              int bs, int max_pages, long long q_sb, long long q_sh, float a) {
  constexpr int kWarps = D / 32;
  __shared__ float qs[D];
  __shared__ float sc[kMaxBlockSize];

  const int hi = blockIdx.x;
  const int bi = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  qs[t] = to_f<T>(q[bi * q_sb + hi * q_sh + t]);
  const int len = seq_lens[bi];
  const int pages = len > 0 ? min((len + bs - 1) / bs, max_pages) : 0;
  const int* bt = block_tables + (size_t)bi * max_pages;
  __syncthreads();

  float m = -INFINITY, l = 0.f, acc = 0.f;
  for (int j = 0; j < pages; ++j) {
    const size_t page = ((size_t)bt[j] * h + hi) * (size_t)bs * D;
    const T* kp = kc + page;
    const T* vp = vc + page;
    const int pos0 = j * bs;
    for (int key = warp; key < bs; key += kWarps) {
      float part = 0.f;
#pragma unroll
      for (int d = lane; d < D; d += 32) part = fmaf(qs[d], to_f<T>(kp[key * D + d]), part);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) sc[key] = pos0 + key < len ? part : -INFINITY;
    }
    __syncthreads();
    float pm = -INFINITY;
    for (int key = 0; key < bs; ++key) pm = fmaxf(pm, sc[key]);
    const float m_new = fmaxf(m, pm);  // finite: this page holds position pos0 < len
    const float corr = exp2f((m - m_new) * a);
    float psum = 0.f, pv = 0.f;
    for (int key = 0; key < bs; ++key) {
      const float p = exp2f((sc[key] - m_new) * a);  // masked: exp2(-inf) = 0
      psum += p;
      pv = fmaf(p, to_f<T>(vp[key * D + t]), pv);
    }
    l = l * corr + psum;
    acc = acc * corr + pv;
    m = m_new;
    __syncthreads();  // sc is rewritten by the next page
  }
  out[((size_t)bi * h + hi) * D + t] = from_f<T>(l > 0.f ? acc / l : 0.f);
}

template <typename T>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* bt,
                   const void* sl, void* out, int b, int h, int d, int bs,
                   int max_pages, long long q_sb, long long q_sh, float scale,
                   cudaStream_t stream) {
  const float a = scale * 1.4426950408889634f;  // scale * log2(e)
  const dim3 grid(h, b);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(kc);
  const T* vp = static_cast<const T*>(vc);
  const int* btp = static_cast<const int*>(bt);
  const int* slp = static_cast<const int*>(sl);
  T* op = static_cast<T*>(out);
  if (d == 64) {
    decode_kernel<T, 64><<<grid, 64, 0, stream>>>(qp, kp, vp, btp, slp, op, h, bs,
                                                   max_pages, q_sb, q_sh, a);
  } else if (d == 128) {
    decode_kernel<T, 128><<<grid, 128, 0, stream>>>(qp, kp, vp, btp, slp, op, h, bs,
                                                     max_pages, q_sb, q_sh, a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (b, h, d) with element strides q_sb, q_sh and a unit stride on d;
// k_cache/v_cache (nb, h, bs, d) contiguous; block_tables (b, max_pages)
// int32 contiguous; seq_lens (b,) int32; out (b, h, d) contiguous.
// dtype codes: 0 float32, 1 bfloat16, 2 float16.  d in {64, 128},
// bs <= 256.
int apex_flash_decode(const void* q, const void* k_cache, const void* v_cache,
                      const void* block_tables, const void* seq_lens, void* out,
                      int b, int h, int d, int block_size, int max_pages,
                      long long q_sb, long long q_sh, float scale, int dtype,
                      void* stream) {
  if (b <= 0 || h <= 0 || block_size <= 0 || block_size > kMaxBlockSize ||
      max_pages <= 0 || b > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k_cache, v_cache, block_tables, seq_lens, out, b, h, d,
                           block_size, max_pages, q_sb, q_sh, scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k_cache, v_cache, block_tables, seq_lens, out,
                                   b, h, d, block_size, max_pages, q_sb, q_sh, scale,
                                   s);
    case 2:
      return launch<__half>(q, k_cache, v_cache, block_tables, seq_lens, out, b, h, d,
                            block_size, max_pages, q_sb, q_sh, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
