// Paged flash-decode for Hopper (sm_90a), plain C interface.
//
// Replaces: apex_tpu/ops/flash_decode.py `_decode_paged` (Pallas kernel
// `_decode_kernel`): one query row per sequence
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
//
// Second entry, apex_flash_decode_multi: replaces
// apex_tpu/ops/flash_decode.py `_decode_paged_multi` (Pallas kernel
// `_decode_multi_kernel`): t contiguous query rows per
// sequence (speculative verify, chunked and warm-tail prefill).  q
// (b, t, h, d); row r of sequence b sits at position seq_lens[b] - t + r
// and attends positions <= that; a row at a negative position (front
// padding) and every row of a seq_len 0 sequence emit exactly 0.
//
// What bounds it: bytes.  At the verify shape (t = 3) each cached key
// and value serves 3 rows, about 12 operations per element; a 32-row
// chunk does about 128 per element read, still well below the card's
// ~295 bf16 operations per byte.  So the k/v stream is the cost, and a
// page is read once for all the rows of a block.  The design: pass 1 runs
// one block per (head, batch row, tile of up to 16 query rows, split of
// 64 positions), 4 warps, each warp owning 4 rows (interleaved, so a
// 3-row verify spreads over 3 warps).  The block stages up to 32 keys of
// a page at a time in shared memory (fp32, k rows padded to d + 1 floats
// so lanes read distinct banks); each lane scores one key against its
// warp's rows, the warp reduces the tile max and sum, and each lane keeps
// d / 32 output dims of every row's fp32 accumulator, adding p * v with p
// broadcast by shuffle.  It writes each row's unnormalised accumulator
// and (max, sum) for its split to fp32 scratch; pass 2 merges a row's
// splits in a fixed order.  On the TPU the grid's page axis ran in order
// with m/l/acc in VMEM scratch; here nothing carries between blocks, and
// the splits put a long row's walk on many SMs at once (a single block
// walking 64 pages serially spent ~3 us a page in load and barrier
// latency).  Each row has its own limit, so any page can be partly
// masked for some rows (with t > bs early rows end pages before the last
// row does); a row with no valid key in a tile skips the tile (its
// running max stays -inf, no exp2(-inf - -inf) NaN), a split that saw no
// key writes (-inf, 0) and is skipped in the merge, and a row that saw
// no key at all writes exactly 0.  A block stops at the page holding its
// last valid position.  Later work: 16-byte loads (cp.async/TMA) and
// several tiles in flight per block.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

// one cached element as fp32: a float cache converts, an int8 cache
// multiplies the code by its row's scale
template <typename TC>
__device__ __forceinline__ float kv_f(TC v, float s) {
  if constexpr (std::is_same<TC, int8_t>::value) {
    return to_f<TC>(v) * s;
  } else {
    return to_f<TC>(v);
  }
}

// the scale of row `slot` of a page, or 1 for a float cache
template <typename TC>
__device__ __forceinline__ float row_scale(const float* __restrict__ sc, size_t slot) {
  if constexpr (std::is_same<TC, int8_t>::value) {
    return sc[slot];
  } else {
    return 1.f;
  }
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

template <typename T, typename TC, int D>
__global__ void __launch_bounds__(D)
decode_kernel(const T* __restrict__ q, const TC* __restrict__ kc,
              const TC* __restrict__ vc, const float* __restrict__ ksc,
              const float* __restrict__ vsc, const int* __restrict__ block_tables,
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
    const size_t srow = ((size_t)bt[j] * h + hi) * (size_t)bs;  // scale row 0
    const size_t page = srow * D;
    const TC* kp = kc + page;
    const TC* vp = vc + page;
    const int pos0 = j * bs;
    for (int key = warp; key < bs; key += kWarps) {
      const float ks = row_scale<TC>(ksc, srow + key);
      float part = 0.f;
#pragma unroll
      for (int d = lane; d < D; d += 32) part = fmaf(qs[d], kv_f<TC>(kp[key * D + d], ks), part);
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
      pv = fmaf(p, kv_f<TC>(vp[key * D + t], row_scale<TC>(vsc, srow + key)), pv);
    }
    l = l * corr + psum;
    acc = acc * corr + pv;
    m = m_new;
    __syncthreads();  // sc is rewritten by the next page
  }
  out[((size_t)bi * h + hi) * D + t] = from_f<T>(l > 0.f ? acc / l : 0.f);
}

template <typename T, typename TC>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* ks,
                   const void* vs, const void* bt, const void* sl, void* out, int b,
                   int h, int d, int bs, int max_pages, long long q_sb, long long q_sh,
                   float scale, cudaStream_t stream) {
  const float a = scale * 1.4426950408889634f;  // scale * log2(e)
  const dim3 grid(h, b);
  const T* qp = static_cast<const T*>(q);
  const TC* kp = static_cast<const TC*>(kc);
  const TC* vp = static_cast<const TC*>(vc);
  const float* ksp = static_cast<const float*>(ks);
  const float* vsp = static_cast<const float*>(vs);
  const int* btp = static_cast<const int*>(bt);
  const int* slp = static_cast<const int*>(sl);
  T* op = static_cast<T*>(out);
  if (d == 64) {
    decode_kernel<T, TC, 64><<<grid, 64, 0, stream>>>(qp, kp, vp, ksp, vsp, btp, slp,
                                                       op, h, bs, max_pages, q_sb,
                                                       q_sh, a);
  } else if (d == 128) {
    decode_kernel<T, TC, 128><<<grid, 128, 0, stream>>>(qp, kp, vp, ksp, vsp, btp, slp,
                                                         op, h, bs, max_pages, q_sb,
                                                         q_sh, a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

constexpr int kMultiWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kMultiRows = kMultiWarps * kRowsPerWarp;  // rows a block owns
constexpr int kKeyTile = 32;                            // keys staged at once
constexpr int kSplitPositions = 64;                     // positions a split walks

// Pass 1: one block per (head, batch row, tile of up to 16 query rows,
// split of the positions) writes each of its rows' unnormalised fp32
// accumulator and (max, sum) for the split's positions.
template <typename T, typename TC, int D>
__global__ void __launch_bounds__(kMultiWarps * 32)
decode_multi_kernel(const T* __restrict__ q, const TC* __restrict__ kc,
                    const TC* __restrict__ vc, const float* __restrict__ ksc,
                    const float* __restrict__ vsc, const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens, float* __restrict__ part_o,
                    float* __restrict__ part_ml, int t, int h, int bs, int max_pages,
                    int split_pages, int splits, long long q_sb, long long q_st,
                    long long q_sh, float a) {
  constexpr int kDims = D / 32;  // output dims a lane owns
  __shared__ float qs[kMultiRows][D];
  __shared__ float ks[kKeyTile][D + 1];
  __shared__ float vs[kKeyTile][D];

  const int hi = blockIdx.x;
  const int bi = blockIdx.y;
  const int sp = blockIdx.z % splits;
  const int r0 = (blockIdx.z / splits) * kMultiRows;  // the block's first row
  const int nrows = min(kMultiRows, t - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // block row r sits at position lim0 + r and attends positions <= it
  const int lim0 = seq_lens[bi] - t + r0;
  const int last = lim0 + nrows - 1;  // the block's last valid position

  for (int i = tid; i < nrows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    qs[r][d] = to_f<T>(q[bi * q_sb + (r0 + r) * q_st + hi * q_sh + d]);
  }
  // this warp's rows: warp, warp + 4, warp + 8, warp + 12 (block-local)
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDims];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[i][c] = 0.f;
  }
  // the split's pages, up to the one holding the block's last position
  const int pages = last >= 0 ? min(last / bs + 1, max_pages) : 0;
  const int j1 = min(pages, (sp + 1) * split_pages);
  const int* bt = block_tables + (size_t)bi * max_pages;
  for (int j = sp * split_pages; j < j1; ++j) {
    const size_t srow = ((size_t)bt[j] * h + hi) * (size_t)bs;  // scale row 0
    const size_t page = srow * D;
    for (int k0 = 0; k0 < bs; k0 += kKeyTile) {
      const int pos0 = j * bs + k0;
      if (pos0 > last) break;  // block-uniform
      const int nk = min(kKeyTile, bs - k0);
      __syncthreads();  // qs written; the previous tile fully consumed
      const TC* kp = kc + page + (size_t)k0 * D;
      const TC* vp = vc + page + (size_t)k0 * D;
      for (int i = tid; i < nk * D; i += blockDim.x) {
        const int key = i / D, d = i - key * D;
        ks[key][d] = kv_f<TC>(kp[i], row_scale<TC>(ksc, srow + k0 + key));
        vs[key][d] = kv_f<TC>(vp[i], row_scale<TC>(vsc, srow + k0 + key));
      }
      __syncthreads();
      // lane scores key `lane` of the tile against each of the warp's rows
      float s[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
      if (lane < nk) {
        for (int d = 0; d < D; ++d) {
          const float kd = ks[lane][d];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i)
            s[i] = fmaf(qs[min(warp + i * kMultiWarps, nrows - 1)][d], kd, s[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + i * kMultiWarps;
        if (r >= nrows) continue;  // warp-uniform
        const bool ok = lane < nk && pos0 + lane <= lim0 + r;
        const float sc = ok ? s[i] * a : -INFINITY;
        float mt = sc;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        if (mt == -INFINITY) continue;  // no key of this tile for the row
        const float m_new = fmaxf(m[i], mt);
        const float corr = exp2f(m[i] - m_new);  // m = -inf: 0
        const float p = exp2f(sc - m_new);        // masked: exp2(-inf) = 0
        float ps = p;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
        l[i] = l[i] * corr + ps;
#pragma unroll
        for (int c = 0; c < kDims; ++c) acc[i][c] *= corr;
        for (int key = 0; key < nk; ++key) {
          const float pk = __shfl_sync(0xffffffffu, p, key);
#pragma unroll
          for (int c = 0; c < kDims; ++c)
            acc[i][c] = fmaf(pk, vs[key][lane + 32 * c], acc[i][c]);
        }
        m[i] = m_new;
      }
    }
  }
  // every split writes every row, an empty split (m = -inf, l = 0) too
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * kMultiWarps;
    if (r >= nrows) continue;
    const size_t slot = (((size_t)bi * t + r0 + r) * h + hi) * splits + sp;
#pragma unroll
    for (int c = 0; c < kDims; ++c) part_o[slot * D + lane + 32 * c] = acc[i][c];
    if (lane == 0) {
      part_ml[2 * slot] = m[i];
      part_ml[2 * slot + 1] = l[i];
    }
  }
}

// Pass 2: one warp per (batch row, query row, head) merges its splits in
// a fixed order; a row that attended nothing writes exactly 0.
template <typename T, int D>
__global__ void __launch_bounds__(kMultiWarps * 32)
decode_multi_combine(const float* __restrict__ part_o,
                     const float* __restrict__ part_ml, T* __restrict__ out,
                     int rows, int splits) {
  constexpr int kDims = D / 32;
  const int row = blockIdx.x * kMultiWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* ml = part_ml + (size_t)row * splits * 2;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  float l = 0.f, acc[kDims];
#pragma unroll
  for (int c = 0; c < kDims; ++c) acc[c] = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      if (ml[2 * s] == -INFINITY) continue;  // the split saw no key
      const float w = exp2f(ml[2 * s] - mx);
      l = fmaf(ml[2 * s + 1], w, l);
      const float* o = part_o + ((size_t)row * splits + s) * D;
#pragma unroll
      for (int c = 0; c < kDims; ++c) acc[c] = fmaf(o[lane + 32 * c], w, acc[c]);
    }
  }
  T* o = out + (size_t)row * D;
#pragma unroll
  for (int c = 0; c < kDims; ++c)
    o[lane + 32 * c] = from_f<T>(l > 0.f ? acc[c] / l : 0.f);
}

template <typename T, typename TC, int D>
cudaError_t launch_multi_d(const T* q, const TC* kc, const TC* vc, const float* ksc,
                           const float* vsc, const int* bt,
                           const int* sl, float* part_o, float* part_ml, T* out,
                           int b, int t, int h, int bs, int max_pages,
                           int split_pages, int splits, long long q_sb,
                           long long q_st, long long q_sh, float a,
                           cudaStream_t stream) {
  const dim3 grid(h, b, ((t + kMultiRows - 1) / kMultiRows) * splits);
  decode_multi_kernel<T, TC, D><<<grid, kMultiWarps * 32, 0, stream>>>(
      q, kc, vc, ksc, vsc, bt, sl, part_o, part_ml, t, h, bs, max_pages, split_pages, splits,
      q_sb, q_st, q_sh, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int rows = b * t * h;
  decode_multi_combine<T, D><<<(rows + kMultiWarps - 1) / kMultiWarps,
                               kMultiWarps * 32, 0, stream>>>(part_o, part_ml, out,
                                                              rows, splits);
  return cudaGetLastError();
}

template <typename T, typename TC>
cudaError_t launch_multi(const void* q, const void* kc, const void* vc, const void* ks,
                         const void* vs, const void* bt, const void* sl, void* part_o,
                         void* part_ml, void* out, int b, int t, int h, int d, int bs,
                         int max_pages, int split_pages, int splits, long long q_sb,
                         long long q_st, long long q_sh, float scale,
                         cudaStream_t stream) {
  const float a = scale * 1.4426950408889634f;  // scale * log2(e)
  const T* qp = static_cast<const T*>(q);
  const TC* kp = static_cast<const TC*>(kc);
  const TC* vp = static_cast<const TC*>(vc);
  const float* ksp = static_cast<const float*>(ks);
  const float* vsp = static_cast<const float*>(vs);
  const int* btp = static_cast<const int*>(bt);
  const int* slp = static_cast<const int*>(sl);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  T* op = static_cast<T*>(out);
  if (d == 64)
    return launch_multi_d<T, TC, 64>(qp, kp, vp, ksp, vsp, btp, slp, po, pml, op, b, t,
                                     h, bs, max_pages, split_pages, splits, q_sb, q_st,
                                     q_sh, a, stream);
  if (d == 128)
    return launch_multi_d<T, TC, 128>(qp, kp, vp, ksp, vsp, btp, slp, po, pml, op, b,
                                      t, h, bs, max_pages, split_pages, splits, q_sb,
                                      q_st, q_sh, a, stream);
  return cudaErrorInvalidValue;
}

// dtype codes: 0 float32, 1 bfloat16, 2 float16, 3 int8 (cache only).
// The cache is q's dtype, int8 (with scales), or bf16 under fp32 q.
bool cache_ok(int cache_dtype, const void* ks, const void* vs) {
  if (cache_dtype == 3) return ks != nullptr && vs != nullptr;
  return ks == nullptr && vs == nullptr;
}

cudaError_t decode_dispatch(const void* q, const void* kc, const void* vc, const void* ks,
                            const void* vs, const void* bt, const void* sl, void* out,
                            int b, int h, int d, int bs, int mp, long long q_sb,
                            long long q_sh, float scale, int dtype, int cache_dtype,
                            cudaStream_t s) {
  if (!cache_ok(cache_dtype, ks, vs)) return cudaErrorInvalidValue;
#define APEX_DECODE(T, TC)                                                          \
  return launch<T, TC>(q, kc, vc, ks, vs, bt, sl, out, b, h, d, bs, mp, q_sb, q_sh, \
                       scale, s)
  if (dtype == 0 && cache_dtype == 0) APEX_DECODE(float, float);
  if (dtype == 0 && cache_dtype == 1) APEX_DECODE(float, __nv_bfloat16);
  if (dtype == 0 && cache_dtype == 3) APEX_DECODE(float, int8_t);
  if (dtype == 1 && cache_dtype == 1) APEX_DECODE(__nv_bfloat16, __nv_bfloat16);
  if (dtype == 1 && cache_dtype == 3) APEX_DECODE(__nv_bfloat16, int8_t);
  if (dtype == 2 && cache_dtype == 2) APEX_DECODE(__half, __half);
  if (dtype == 2 && cache_dtype == 3) APEX_DECODE(__half, int8_t);
#undef APEX_DECODE
  return cudaErrorInvalidValue;
}

cudaError_t multi_dispatch(const void* q, const void* kc, const void* vc, const void* ks,
                           const void* vs, const void* bt, const void* sl, void* part_o,
                           void* part_ml, void* out, int b, int t, int h, int d, int bs,
                           int mp, int split_pages, int splits, long long q_sb,
                           long long q_st, long long q_sh, float scale, int dtype,
                           int cache_dtype, cudaStream_t s) {
  if (!cache_ok(cache_dtype, ks, vs)) return cudaErrorInvalidValue;
#define APEX_MULTI(T, TC)                                                          \
  return launch_multi<T, TC>(q, kc, vc, ks, vs, bt, sl, part_o, part_ml, out, b, t, h, \
                             d, bs, mp, split_pages, splits, q_sb, q_st, q_sh, scale, s)
  if (dtype == 0 && cache_dtype == 0) APEX_MULTI(float, float);
  if (dtype == 0 && cache_dtype == 1) APEX_MULTI(float, __nv_bfloat16);
  if (dtype == 0 && cache_dtype == 3) APEX_MULTI(float, int8_t);
  if (dtype == 1 && cache_dtype == 1) APEX_MULTI(__nv_bfloat16, __nv_bfloat16);
  if (dtype == 1 && cache_dtype == 3) APEX_MULTI(__nv_bfloat16, int8_t);
  if (dtype == 2 && cache_dtype == 2) APEX_MULTI(__half, __half);
  if (dtype == 2 && cache_dtype == 3) APEX_MULTI(__half, int8_t);
#undef APEX_MULTI
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (b, h, d) with element strides q_sb, q_sh and a unit stride on d;
// k_cache/v_cache (nb, h, bs, d) contiguous; k_scale/v_scale (nb, h, bs)
// fp32 contiguous for an int8 cache, null otherwise; block_tables
// (b, max_pages) int32 contiguous; seq_lens (b,) int32; out (b, h, d)
// contiguous in q's dtype.  d in {64, 128}, bs <= 256.
int apex_flash_decode(const void* q, const void* k_cache, const void* v_cache,
                      const void* k_scale, const void* v_scale,
                      const void* block_tables, const void* seq_lens, void* out,
                      int b, int h, int d, int block_size, int max_pages,
                      long long q_sb, long long q_sh, float scale, int dtype,
                      int cache_dtype, void* stream) {
  if (b <= 0 || h <= 0 || block_size <= 0 || block_size > kMaxBlockSize ||
      max_pages <= 0 || b > 65535)
    return cudaErrorInvalidValue;
  return decode_dispatch(q, k_cache, v_cache, k_scale, v_scale, block_tables, seq_lens,
                         out, b, h, d, block_size, max_pages, q_sb, q_sh, scale, dtype,
                         cache_dtype, static_cast<cudaStream_t>(stream));
}

// q (b, t, h, d) with element strides q_sb, q_st, q_sh and a unit stride
// on d; caches, scales, block_tables and seq_lens as apex_flash_decode's
// (seq_lens counts the chunk); out (b, t, h, d) contiguous.  part_o and
// part_ml are fp32 scratch of apex_flash_decode_multi_splits(...) * b * t
// * h * d and * 2 floats.  Same dtype codes, d in {64, 128}, bs <= 256.
static int split_pages_for(int block_size) {
  const int n = kSplitPositions / (block_size > 0 ? block_size : 1);
  return n > 1 ? n : 1;
}

int apex_flash_decode_multi_splits(int block_size, int max_pages) {
  const int split_pages = split_pages_for(block_size);
  return (max_pages + split_pages - 1) / split_pages;
}

int apex_flash_decode_multi(const void* q, const void* k_cache, const void* v_cache,
                            const void* k_scale, const void* v_scale,
                            const void* block_tables, const void* seq_lens,
                            void* part_o, void* part_ml, void* out, int b, int t,
                            int h, int d, int block_size, int max_pages,
                            long long q_sb, long long q_st, long long q_sh,
                            float scale, int dtype, int cache_dtype, void* stream) {
  const int split_pages = split_pages_for(block_size);
  const int splits = (max_pages + split_pages - 1) / split_pages;
  if (b <= 0 || t <= 0 || h <= 0 || block_size <= 0 ||
      block_size > kMaxBlockSize || max_pages <= 0 || b > 65535 ||
      (long long)((t + kMultiRows - 1) / kMultiRows) * splits > 65535)
    return cudaErrorInvalidValue;
  return multi_dispatch(q, k_cache, v_cache, k_scale, v_scale, block_tables, seq_lens,
                        part_o, part_ml, out, b, t, h, d, block_size, max_pages,
                        split_pages, splits, q_sb, q_st, q_sh, scale, dtype,
                        cache_dtype, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
