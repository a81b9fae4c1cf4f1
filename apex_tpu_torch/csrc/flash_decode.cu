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
// What the design does about it: the k/v stream is spread over the whole
// card and read 16 bytes a lane.  On the TPU the grid walked a row's pages
// in order with m/l/acc in VMEM scratch; here each row's positions are cut
// into splits of whole pages (their number chosen from b * h and max_pages,
// toward 1024 blocks, each split at least 64 positions and at most 64
// pages), one block of 4 warps per (head, batch row, split).  The block
// reads its split's page ids once into shared memory and stops at the
// row's seq_len, so pages past it are never read.  A key row is read by a
// group of lanes, 16 bytes each (bf16 at d = 64: 8 lanes a key, 4 keys a
// warp load; int8: 4 lanes, 8 keys), each group with 4 keys in flight
// (8 loads a lane) before their first use; the group reduces q.k by
// shuffles and keeps its own online softmax (m, l and its lanes' dims of
// the fp32 accumulator).  An int8 row's scale is read once a key and
// multiplies the score and p (q.(c s) = s (q.c)).  At the end the groups
// of a warp merge by shuffles, the warps in shared memory, and the splits
// of a row in the second pass row 15 uses (`decode_multi_combine`), all in
// a fixed order, so results repeat bit for bit; a row with one split
// writes its output directly.  A group or split that sees no valid key
// keeps m = -inf (no exp2(-inf - -inf)), writes (-inf, 0) and is skipped
// in the merge; a row that sees none writes exactly 0.

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
// ~295 bf16 operations per byte.  So the k/v stream is the cost, read as
// row 14 reads it.  The design is row 14's for several rows: the rows'
// positions are cut into splits of whole pages sized from the shape
// toward a whole-card block count (`multi_split_pages`), one 4-warp block
// per (head, batch row, tile of query rows, split); lane groups read a key
// row 16 bytes a lane (8 in an int8 verify) with 4 keys in flight and no
// barrier a tile; each lane holds its dims of q for up to 4 rows in
// registers and the group scores every key against each of them, keeping
// an online softmax per (group, row).  Up to 4 rows (the verify) every
// warp owns all of them and the warps split the keys, merging in shared
// memory; from 5 (the chunk, the warm tail) each warp owns 4 of the
// block's 16 rows and walks every key, the block's warps reading the same
// key rows.  Splits merge in `decode_multi_combine`, which reads only the
// splits a row's position reaches, in a fixed order, so results repeat bit
// for bit; a shape with one split writes its output directly.  Each row has its own limit, so a
// page can be partly masked for some rows (with t > bs early rows end
// pages before the last row does); a row with no valid key in a chunk
// skips it (its running max stays -inf, no exp2(-inf - -inf)), and a row
// that saw no key at all writes exactly 0.
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

// --- row 14: the single-query decode -------------------------------------

constexpr int kDecWarps = 4;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecUnroll = 4;            // keys a lane group has in flight
constexpr int kDecSpanPages = 64;        // the most pages a split walks
constexpr int kDecMinSpan = 64;          // the fewest positions a split takes
constexpr int kDecTargetBlocks = 1024;   // b * h * splits is raised toward this

// 16 bytes of cached row from global memory, read-only path
template <typename TC>
__device__ __forceinline__ uint4 ldg16(const TC* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 16 bytes of a cached row as fp32: 4 floats, 8 bf16 or fp16 values, or
// 16 int8 codes
template <typename TC>
__device__ __forceinline__ void cvt16(const uint4& r, float (&f)[16 / sizeof(TC)]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<TC, float>::value) {
      f[i] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same<TC, __nv_bfloat16>::value) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else if constexpr (std::is_same<TC, __half>::value) {
      f[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
      f[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] = static_cast<float>(static_cast<int8_t>(
            static_cast<uint8_t>((w[i] >> (8 * j)) & 0xffu)));
    }
  }
}

// One block per (head, batch row, split of split_pages pages).  With one
// split the block writes the row's output; with more it writes the split's
// unnormalised fp32 accumulator and (max, sum) for decode_multi_combine.
template <typename T, typename TC, int D>
__global__ void __launch_bounds__(kDecThreads)
decode_kernel(const T* __restrict__ q, const TC* __restrict__ kc,
              const TC* __restrict__ vc, const float* __restrict__ ksc,
              const float* __restrict__ vsc, const int* __restrict__ block_tables,
              const int* __restrict__ seq_lens, T* __restrict__ out,
              float* __restrict__ part_o, float* __restrict__ part_ml, int h, int bs,
              int max_pages, int split_pages, long long q_sb, long long q_sh, float a) {
  constexpr int kE = 16 / (int)sizeof(TC);  // elements a lane reads of a key row
  constexpr int kL = D / kE;                // lanes a key row takes
  constexpr int kG = 32 / kL;               // keys a warp load covers
  constexpr int kStep = kDecWarps * kG;     // keys the block covers a load
  constexpr int kBlockKeys = kStep * kDecUnroll;
  static_assert(kL >= 1 && kL <= 32 && 32 % kL == 0, "a key row must fit a warp");
  __shared__ int pages_s[kDecSpanPages];
  __shared__ float wo[kDecWarps][D];
  __shared__ float wml[kDecWarps][2];

  const int hi = blockIdx.x;
  const int bi = blockIdx.y;
  const int sp = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane / kL;  // the lane's key slot in a warp load
  const int sub = lane % kL;  // its 16 bytes of the row: dims sub * kE ..
  const int len = seq_lens[bi];
  const int j0 = sp * split_pages;
  // the split's positions [j0 * bs, j0 * bs + n), cut at seq_len
  const int n = min(len, min(j0 + split_pages, max_pages) * bs) - j0 * bs;
  const int* bt = block_tables + (size_t)bi * max_pages;
  for (int i = tid; i < (n + bs - 1) / bs; i += kDecThreads) pages_s[i] = bt[j0 + i];
  float qf[kE];
  const T* qp = q + bi * q_sb + hi * q_sh + sub * kE;
#pragma unroll
  for (int e = 0; e < kE; ++e) qf[e] = to_f<T>(qp[e]);
  __syncthreads();

  float m = -INFINITY, l = 0.f, acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = 0.f;
  for (int base = 0; base < n; base += kBlockKeys) {  // block-uniform
    uint4 kr[kDecUnroll], vr[kDecUnroll];
    float ks[kDecUnroll], vs[kDecUnroll];
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      const int kk = base + u * kStep + warp * kG + grp;
      kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      ks[u] = vs[u] = 0.f;
      if (kk < n) {
        const int pg = kk / bs;
        const size_t row = ((size_t)pages_s[pg] * h + hi) * bs + (kk - pg * bs);
        kr[u] = ldg16(kc + row * D + sub * kE);
        vr[u] = ldg16(vc + row * D + sub * kE);
        ks[u] = row_scale<TC>(ksc, row);
        vs[u] = row_scale<TC>(vsc, row);
      }
    }
    float s[kDecUnroll];
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      float f[kE];
      cvt16<TC>(kr[u], f);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < kE; ++e) d = fmaf(qf[e], f[e], d);
      s[u] = d;
    }
    // q.k over the group's lanes: a butterfly, so every lane of the group
    // holds the same sum
#pragma unroll
    for (int o = kL / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kDecUnroll; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
    float mt = -INFINITY;
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      const int kk = base + u * kStep + warp * kG + grp;
      s[u] = kk < n ? s[u] * ks[u] * a : -INFINITY;
      mt = fmaxf(mt, s[u]);
    }
    if (mt != -INFINITY) {  // uniform over the group
      const float m_new = fmaxf(m, mt);
      const float corr = exp2f(m - m_new);  // m = -inf: 0
      l *= corr;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] *= corr;
#pragma unroll
      for (int u = 0; u < kDecUnroll; ++u) {
        const float p = exp2f(s[u] - m_new);  // masked: exp2(-inf) = 0
        l += p;
        const float pv = p * vs[u];
        float f[kE];
        cvt16<TC>(vr[u], f);
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[e] = fmaf(pv, f[e], acc[e]);
      }
      m = m_new;
    }
  }
  // the warp's groups: lanes of one `sub` merge by a butterfly
  float mw = m;
#pragma unroll
  for (int o = kL; o < 32; o <<= 1) mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
  const float f = m == -INFINITY ? 0.f : exp2f(m - mw);
  l *= f;
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] *= f;
#pragma unroll
  for (int o = kL; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (grp == 0) {
#pragma unroll
    for (int e = 0; e < kE; ++e) wo[warp][sub * kE + e] = acc[e];
  }
  if (lane == 0) {
    wml[warp][0] = mw;
    wml[warp][1] = l;
  }
  __syncthreads();
  // the warps, in order; one thread a dim
  for (int dd = tid; dd < D; dd += kDecThreads) {
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mb = fmaxf(mb, wml[w][0]);
    float lb = 0.f, ob = 0.f;
    if (mb != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) {
        if (wml[w][0] == -INFINITY) continue;  // the warp saw no key
        const float fw = exp2f(wml[w][0] - mb);
        lb = fmaf(wml[w][1], fw, lb);
        ob = fmaf(wo[w][dd], fw, ob);
      }
    }
    const size_t row = (size_t)bi * h + hi;
    if (splits == 1) {
      out[row * D + dd] = from_f<T>(lb > 0.f ? ob / lb : 0.f);
    } else {
      const size_t slot = row * splits + sp;
      part_o[slot * D + dd] = ob;
      if (dd == 0) {
        part_ml[2 * slot] = mb;
        part_ml[2 * slot + 1] = lb;
      }
    }
  }
}

// pages a split walks when `row_blocks` blocks share the card before the
// split: toward kDecTargetBlocks blocks, at least kDecMinSpan positions and
// at most kDecSpanPages pages
int split_pages_for(long long row_blocks, int bs, int max_pages) {
  const long long want = (kDecTargetBlocks + row_blocks - 1) / row_blocks;
  const int splits = (int)(want < max_pages ? want : max_pages);
  int sp = (max_pages + splits - 1) / splits;
  sp = max(sp, (kDecMinSpan + bs - 1) / bs);
  return min(sp, kDecSpanPages);
}

// pages a split of row 14 walks: one block a (head, batch row) per split
int decode_split_pages(int b, int h, int bs, int max_pages) {
  return split_pages_for((long long)b * h, bs, max_pages);
}

// --- row 15: several query rows per sequence -----------------------------

constexpr int kMultiRows = 4;  // query rows a warp owns (q and acc in registers)

// Row 15's two layouts: up to kMultiRows rows (3 in registers at t <= 3),
// every warp owns all of them and the warps split the keys (the verify: no
// warp idles); from kMultiRows + 1, each warp owns kMultiRows rows of a
// block's kDecWarps * kMultiRows and walks every key of the split (the
// chunk and the warm tail: the block's four warps read the same key rows,
// the first from device memory, the others from L1).  At t = 16 and 32,
// 4-row tiles of the first layout took 4-63 % longer (PERF.md).
bool multi_rows_over_warps(int t) { return t > kMultiRows; }

int multi_block_rows(int t) {
  return multi_rows_over_warps(t) ? kDecWarps * kMultiRows : kMultiRows;
}

// pages a split of row 15 walks: one block a (head, batch row, row tile)
// per split
int multi_split_pages(int b, int t, int h, int bs, int max_pages) {
  const int rows = multi_block_rows(t);
  return split_pages_for((long long)b * h * ((t + rows - 1) / rows), bs, max_pages);
}

// bytes of a key row a lane reads: 16, but 8 for an int8 cache where the
// warps split the keys (8 lanes a key at d = 64, as bf16: a lane then holds
// 8 dims of q a row, not 16, and the layout fits 4 blocks an SM; 0.01757 ->
// 0.01488 ms at the verify, PERF.md)
template <typename TC, bool kRowWarps>
__host__ __device__ constexpr int multi_slice_bytes() {
  return sizeof(TC) == 1 && !kRowWarps ? 8 : 16;
}
// blocks an SM the layout asks registers for: 4 where the warps split the
// keys (at most 128 registers; a few bytes spill at 4 rows), else as many as
// its registers allow
template <bool kRowWarps>
__host__ __device__ constexpr int multi_min_blocks() {
  return kRowWarps ? 1 : 4;
}
// the first kE elements of a lane's slice as fp32
template <typename TC, int kE>
__device__ __forceinline__ void cvt_slice(const uint4& r, float (&f)[kE]) {
  float g[16 / sizeof(TC)];
  cvt16<TC>(r, g);
#pragma unroll
  for (int e = 0; e < kE; ++e) f[e] = g[e];
}
// kBytes (16 or 8) of a cached row from global memory, read-only path
template <int kBytes, typename TC>
__device__ __forceinline__ uint4 ldg_slice(const TC* p) {
  if constexpr (kBytes == 16) {
    return ldg16(p);
  } else {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    return make_uint4(w.x, w.y, 0u, 0u);
  }
}

// One block per (head, batch row, tile of query rows, split of split_pages
// pages), kDecWarps warps of decode_kernel's lane groups.  A warp's rows
// rw0 + i (i < kR) sit at positions lim0 + i and attend positions <= lim0
// + i.  Each lane holds its slice's kE dims of q for every row in
// registers; a group reads its slices of kDecUnroll keys (multi_slice_bytes
// a lane) before their first use, scores each key against every row (an
// fmaf chain, then a butterfly over the group's lanes), and keeps an online
// softmax per (group, row): its max, its sum and its lanes' dims of the
// fp32 accumulator.  An int8 row's scale is read once a key and multiplies
// the score and p.  The groups of a warp merge by butterflies; with
// kRowWarps false the warps, which split the keys, merge in shared memory,
// in order.
// With one split the block writes its rows' outputs (a row with no key
// exactly 0); with more, each row whose position reaches the split (so
// that the split holds a key of it) writes its unnormalised fp32
// accumulator and (max, sum) for decode_multi_combine, which reads no other
// split.  A block whose rows all end before its split exits at once.
template <typename T, typename TC, int D, int kR, bool kRowWarps>
__global__ void __launch_bounds__(kDecThreads, multi_min_blocks<kRowWarps>())
decode_multi_kernel(const T* __restrict__ q, const TC* __restrict__ kc,
                    const TC* __restrict__ vc, const float* __restrict__ ksc,
                    const float* __restrict__ vsc, const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    float* __restrict__ part_o, float* __restrict__ part_ml, int t, int h,
                    int bs, int max_pages, int split_pages, int splits, long long q_sb,
                    long long q_st, long long q_sh, float a) {
  constexpr int kBytes = multi_slice_bytes<TC, kRowWarps>();
  constexpr int kE = kBytes / (int)sizeof(TC);  // elements a lane reads of a key row
  constexpr int kL = D / kE;                // lanes a key row takes
  constexpr int kG = 32 / kL;               // keys a warp load covers
  constexpr int kU = kDecUnroll;  // keys a lane group has in flight
  constexpr int kStep = kRowWarps ? kG : kDecWarps * kG;  // keys a load of the walk covers
  constexpr int kChunk = kStep * kU;
  constexpr int kBlockRows = kRowWarps ? kDecWarps * kR : kR;
  constexpr int kMergeWarps = kRowWarps ? 1 : kDecWarps;
  static_assert(kL >= 1 && kL <= 32 && 32 % kL == 0, "a key row must fit a warp");
  __shared__ int pages_s[kDecSpanPages];
  __shared__ float wo[kMergeWarps][kR][D];
  __shared__ float wml[kMergeWarps][kR][2];

  const int hi = blockIdx.x;
  const int bi = blockIdx.y;
  const int sp = blockIdx.z % splits;
  const int rb0 = (blockIdx.z / splits) * kBlockRows;  // the block's first row
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane / kL;
  const int sub = lane % kL;
  const int len = seq_lens[bi];
  const int j0 = sp * split_pages;
  const int p0 = j0 * bs;  // the split's first position
  // positions [p0, p0 + n): the split, cut after the block's last row's
  const int last = len - t + min(rb0 + kBlockRows, t) - 1;
  const int n = min(last + 1, min(j0 + split_pages, max_pages) * bs) - p0;
  if (n <= 0 && splits > 1) return;  // block-uniform: the merge reads nothing here
  const int* bt = block_tables + (size_t)bi * max_pages;
  for (int i = tid; i < (n + bs - 1) / bs; i += kDecThreads) pages_s[i] = bt[j0 + i];
  const int rw0 = rb0 + (kRowWarps ? warp * kR : 0);  // the warp's first row
  const int nr = min(kR, t - rw0);                    // its rows (<= 0: past t)
  const int lim0 = len - t + rw0;
  float qf[kR][kE];
  const T* qp = q + bi * q_sb + hi * q_sh + sub * kE;
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int e = 0; e < kE; ++e)
      qf[i][e] = i < nr ? to_f<T>(qp[(rw0 + i) * q_st + e]) : 0.f;
  __syncthreads();
  if (kRowWarps && nr <= 0) return;  // warp-uniform, no barrier below
  // the warp's walk ends at its own last row's position
  const int nw = kRowWarps ? min(n, lim0 + nr - p0) : n;
  const int k0 = kRowWarps ? grp : warp * kG + grp;

  float m[kR], l[kR], acc[kR][kE];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[i][e] = 0.f;
  }
  for (int base = 0; base < nw; base += kChunk) {  // warp-uniform
    uint4 kr[kU], vr[kU];
    float ks[kU], vs[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int kk = base + u * kStep + k0;
      kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      ks[u] = vs[u] = 0.f;
      if (kk < nw) {
        const int pg = kk / bs;
        const size_t row = ((size_t)pages_s[pg] * h + hi) * bs + (kk - pg * bs);
        kr[u] = ldg_slice<kBytes>(kc + row * D + sub * kE);
        vr[u] = ldg_slice<kBytes>(vc + row * D + sub * kE);
        ks[u] = row_scale<TC>(ksc, row);
        vs[u] = row_scale<TC>(vsc, row);
      }
    }
    float s[kU][kR];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float f[kE];
      cvt_slice<TC, kE>(kr[u], f);
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) d = fmaf(qf[i][e], f[e], d);
        s[u][i] = d;
      }
    }
    // q.k over the group's lanes: every lane of the group holds the sum
#pragma unroll
    for (int o = kL / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int i = 0; i < kR; ++i) s[u][i] += __shfl_xor_sync(0xffffffffu, s[u][i], o);
    // each row's max over the chunk, its rescale, then its p (masked: 0)
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int kk = base + u * kStep + k0;
        const bool ok = kk < nw && i < nr && p0 + kk <= lim0 + i;
        s[u][i] = ok ? s[u][i] * ks[u] * a : -INFINITY;
        mt = fmaxf(mt, s[u][i]);
      }
      if (mt != -INFINITY) {  // uniform over the group
        const float m_new = fmaxf(m[i], mt);
        const float corr = exp2f(m[i] - m_new);  // m = -inf: 0
        l[i] *= corr;
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[i][e] *= corr;
        m[i] = m_new;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
        s[u][i] = s[u][i] == -INFINITY ? 0.f : exp2f(s[u][i] - m[i]);
    }
    // p . v, each value row converted once for every row
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float f[kE];
      cvt_slice<TC, kE>(vr[u], f);
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        l[i] += s[u][i];
        const float pv = s[u][i] * vs[u];
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[i][e] = fmaf(pv, f[e], acc[i][e]);
      }
    }
  }
  // the warp's groups: lanes of one `sub` merge by a butterfly
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    float mw = m[i];
#pragma unroll
    for (int o = kL; o < 32; o <<= 1) mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
    const float f = m[i] == -INFINITY ? 0.f : exp2f(m[i] - mw);
    l[i] *= f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[i][e] *= f;
#pragma unroll
    for (int o = kL; o < 32; o <<= 1) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], o);
    }
    m[i] = mw;
  }
  if constexpr (kRowWarps) {
    // the warp's rows are its own: group 0 writes them
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      if (i >= nr) break;  // warp-uniform
      const size_t orow = ((size_t)bi * t + rw0 + i) * h + hi;
      if (splits == 1) {
        if (grp == 0) {
#pragma unroll
          for (int e = 0; e < kE; ++e)
            out[orow * D + sub * kE + e] = from_f<T>(l[i] > 0.f ? acc[i][e] / l[i] : 0.f);
        }
      } else if (lim0 + i >= p0) {  // the split holds a key of the row
        const size_t slot = orow * splits + sp;
        if (grp == 0) {
#pragma unroll
          for (int e = 0; e < kE; ++e) part_o[slot * D + sub * kE + e] = acc[i][e];
        }
        if (lane == 0) {
          part_ml[2 * slot] = m[i];
          part_ml[2 * slot + 1] = l[i];
        }
      }
    }
  } else {
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int e = 0; e < kE; ++e) wo[warp][i][sub * kE + e] = acc[i][e];
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        wml[warp][i][0] = m[i];
        wml[warp][i][1] = l[i];
      }
    }
    __syncthreads();
    // the warps, in order; one thread a (row, dim)
    for (int x = tid; x < kR * D; x += kDecThreads) {
      const int i = x / D, dd = x - i * D;
      if (i >= nr) break;
      float mb = -INFINITY;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) mb = fmaxf(mb, wml[w][i][0]);
      float lb = 0.f, ob = 0.f;
      if (mb != -INFINITY) {
#pragma unroll
        for (int w = 0; w < kDecWarps; ++w) {
          if (wml[w][i][0] == -INFINITY) continue;  // the warp saw no key
          const float fw = exp2f(wml[w][i][0] - mb);
          lb = fmaf(wml[w][i][1], fw, lb);
          ob = fmaf(wo[w][i][dd], fw, ob);
        }
      }
      const size_t orow = ((size_t)bi * t + rw0 + i) * h + hi;
      if (splits == 1) {
        out[orow * D + dd] = from_f<T>(lb > 0.f ? ob / lb : 0.f);
      } else if (lim0 + i >= p0) {
        const size_t slot = orow * splits + sp;
        part_o[slot * D + dd] = ob;
        if (dd == 0) {
          part_ml[2 * slot] = mb;
          part_ml[2 * slot + 1] = lb;
        }
      }
    }
  }
}

constexpr int kCombineWarps = 4;

// The merge of a row's splits, rows 14 and 15: one warp per (batch row,
// query row, head) = row ((bi * t) + r) * h + hi.  Row 15 (span, the
// positions a split, > 0): the row's position seq_len - t + r reaches
// splits 0 .. pos / span, which it merges in order, and a row at a negative
// position writes exactly 0.  Row 14 (span 0): every split, as
// decode_kernel writes (-inf, 0) for one past the row, and no read of
// seq_lens ahead of the loop.
template <typename T, int D>
__global__ void __launch_bounds__(kCombineWarps * 32)
decode_multi_combine(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                     const int* __restrict__ seq_lens, T* __restrict__ out, int rows,
                     int splits, int t, int h, int span) {
  constexpr int kDims = D / 32;
  const int row = blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  int used = splits;
  if (span > 0) {
    const int pos = seq_lens[row / (t * h)] - t + (row / h) % t;
    used = pos < 0 ? 0 : min(splits, pos / span + 1);
  }
  const float* ml = part_ml + (size_t)row * splits * 2;
  float mx = -INFINITY;
  for (int s = 0; s < used; ++s) mx = fmaxf(mx, ml[2 * s]);
  float l = 0.f, acc[kDims];
#pragma unroll
  for (int c = 0; c < kDims; ++c) acc[c] = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < used; ++s) {
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

template <typename T, int D>
cudaError_t launch_combine(const float* part_o, const float* part_ml, const int* sl, T* out,
                           int rows, int splits, int t, int h, int span,
                           cudaStream_t stream) {
  decode_multi_combine<T, D><<<(rows + kCombineWarps - 1) / kCombineWarps,
                               kCombineWarps * 32, 0, stream>>>(part_o, part_ml, sl, out,
                                                                rows, splits, t, h, span);
  return cudaGetLastError();
}

template <typename T, typename TC, int D>
cudaError_t launch_multi_d(const T* q, const TC* kc, const TC* vc, const float* ksc,
                           const float* vsc, const int* bt, const int* sl, float* part_o,
                           float* part_ml, T* out, int b, int t, int h, int bs,
                           int max_pages, long long q_sb, long long q_st, long long q_sh,
                           float a, cudaStream_t stream) {
  const int rows = multi_block_rows(t);
  const int split_pages = multi_split_pages(b, t, h, bs, max_pages);
  const int splits = (max_pages + split_pages - 1) / split_pages;
  const dim3 grid(h, b, ((t + rows - 1) / rows) * splits);
  if (multi_rows_over_warps(t))
    decode_multi_kernel<T, TC, D, kMultiRows, true><<<grid, kDecThreads, 0, stream>>>(
        q, kc, vc, ksc, vsc, bt, sl, out, part_o, part_ml, t, h, bs, max_pages, split_pages,
        splits, q_sb, q_st, q_sh, a);
  else if (t <= 3)  // the verify at K <= 2: three rows' registers
    decode_multi_kernel<T, TC, D, 3, false><<<grid, kDecThreads, 0, stream>>>(
        q, kc, vc, ksc, vsc, bt, sl, out, part_o, part_ml, t, h, bs, max_pages, split_pages,
        splits, q_sb, q_st, q_sh, a);
  else
    decode_multi_kernel<T, TC, D, kMultiRows, false><<<grid, kDecThreads, 0, stream>>>(
        q, kc, vc, ksc, vsc, bt, sl, out, part_o, part_ml, t, h, bs, max_pages, split_pages,
        splits, q_sb, q_st, q_sh, a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return launch_combine<T, D>(part_o, part_ml, sl, out, b * t * h, splits, t, h,
                              split_pages * bs, stream);
}

template <typename T, typename TC>
cudaError_t launch_multi(const void* q, const void* kc, const void* vc, const void* ks,
                         const void* vs, const void* bt, const void* sl, void* part_o,
                         void* part_ml, void* out, int b, int t, int h, int d, int bs,
                         int max_pages, long long q_sb, long long q_st, long long q_sh,
                         float scale, cudaStream_t stream) {
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
    return launch_multi_d<T, TC, 64>(qp, kp, vp, ksp, vsp, btp, slp, po, pml, op, b, t, h,
                                     bs, max_pages, q_sb, q_st, q_sh, a, stream);
  if (d == 128)
    return launch_multi_d<T, TC, 128>(qp, kp, vp, ksp, vsp, btp, slp, po, pml, op, b, t, h,
                                      bs, max_pages, q_sb, q_st, q_sh, a, stream);
  return cudaErrorInvalidValue;
}

template <typename T, typename TC, int D>
cudaError_t launch_d(const T* q, const TC* kc, const TC* vc, const float* ksc,
                     const float* vsc, const int* bt, const int* sl, float* part_o,
                     float* part_ml, T* out, int b, int h, int bs, int max_pages,
                     long long q_sb, long long q_sh, float a, cudaStream_t stream) {
  const int split_pages = decode_split_pages(b, h, bs, max_pages);
  const int splits = (max_pages + split_pages - 1) / split_pages;
  decode_kernel<T, TC, D><<<dim3(h, b, splits), kDecThreads, 0, stream>>>(
      q, kc, vc, ksc, vsc, bt, sl, out, part_o, part_ml, h, bs, max_pages, split_pages,
      q_sb, q_sh, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return launch_combine<T, D>(part_o, part_ml, sl, out, b * h, splits, 1, h, 0, stream);
}

template <typename T, typename TC>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* ks,
                   const void* vs, const void* bt, const void* sl, void* part_o,
                   void* part_ml, void* out, int b, int h, int d, int bs, int max_pages,
                   long long q_sb, long long q_sh, float scale, cudaStream_t stream) {
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
    return launch_d<T, TC, 64>(qp, kp, vp, ksp, vsp, btp, slp, po, pml, op, b, h, bs,
                               max_pages, q_sb, q_sh, a, stream);
  if (d == 128)
    return launch_d<T, TC, 128>(qp, kp, vp, ksp, vsp, btp, slp, po, pml, op, b, h, bs,
                                max_pages, q_sb, q_sh, a, stream);
  return cudaErrorInvalidValue;
}

// dtype codes: 0 float32, 1 bfloat16, 2 float16, 3 int8 (cache only).
// The cache is q's dtype, int8 (with scales), or bf16 under fp32 q.
bool cache_ok(int cache_dtype, const void* ks, const void* vs) {
  if (cache_dtype == 3) return ks != nullptr && vs != nullptr;
  return ks == nullptr && vs == nullptr;
}

cudaError_t decode_dispatch(const void* q, const void* kc, const void* vc, const void* ks,
                            const void* vs, const void* bt, const void* sl, void* part_o,
                            void* part_ml, void* out, int b, int h, int d, int bs, int mp,
                            long long q_sb, long long q_sh, float scale, int dtype,
                            int cache_dtype, cudaStream_t s) {
  if (!cache_ok(cache_dtype, ks, vs)) return cudaErrorInvalidValue;
#define APEX_DECODE(T, TC)                                                      \
  return launch<T, TC>(q, kc, vc, ks, vs, bt, sl, part_o, part_ml, out, b, h, d, bs, \
                       mp, q_sb, q_sh, scale, s)
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
                           int mp, long long q_sb, long long q_st, long long q_sh,
                           float scale, int dtype, int cache_dtype, cudaStream_t s) {
  if (!cache_ok(cache_dtype, ks, vs)) return cudaErrorInvalidValue;
#define APEX_MULTI(T, TC)                                                          \
  return launch_multi<T, TC>(q, kc, vc, ks, vs, bt, sl, part_o, part_ml, out, b, t, h, \
                             d, bs, mp, q_sb, q_st, q_sh, scale, s)
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

// The number of position splits apex_flash_decode runs for (b, h,
// block_size, max_pages): 1 means no scratch is read or written.
int apex_flash_decode_splits(int b, int h, int block_size, int max_pages) {
  if (b <= 0 || h <= 0 || block_size <= 0 || max_pages <= 0) return 1;
  const int split_pages = decode_split_pages(b, h, block_size, max_pages);
  return (max_pages + split_pages - 1) / split_pages;
}

// q (b, h, d) with element strides q_sb, q_sh and a unit stride on d;
// k_cache/v_cache (nb, h, bs, d) contiguous, 16-byte aligned; k_scale/v_scale
// (nb, h, bs) fp32 contiguous for an int8 cache, null otherwise;
// block_tables (b, max_pages) int32 contiguous; seq_lens (b,) int32; part_o
// and part_ml fp32 scratch of apex_flash_decode_splits(...) * b * h * d and
// * 2 floats (unused, may be null, at one split); out (b, h, d) contiguous
// in q's dtype.  d in {64, 128}, bs <= 256.
int apex_flash_decode(const void* q, const void* k_cache, const void* v_cache,
                      const void* k_scale, const void* v_scale,
                      const void* block_tables, const void* seq_lens, void* part_o,
                      void* part_ml, void* out, int b, int h, int d, int block_size,
                      int max_pages, long long q_sb, long long q_sh, float scale,
                      int dtype, int cache_dtype, void* stream) {
  if (b <= 0 || h <= 0 || block_size <= 0 || block_size > kMaxBlockSize ||
      max_pages <= 0 || b > 65535 ||
      apex_flash_decode_splits(b, h, block_size, max_pages) > 65535)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(k_cache) % 16 || reinterpret_cast<uintptr_t>(v_cache) % 16)
    return cudaErrorMisalignedAddress;
  return decode_dispatch(q, k_cache, v_cache, k_scale, v_scale, block_tables, seq_lens,
                         part_o, part_ml, out, b, h, d, block_size, max_pages, q_sb, q_sh,
                         scale, dtype, cache_dtype, static_cast<cudaStream_t>(stream));
}

// The number of position splits apex_flash_decode_multi runs for (b, t,
// h, block_size, max_pages): 1 means no scratch is read or written.
int apex_flash_decode_multi_plan(int b, int t, int h, int block_size, int max_pages) {
  if (b <= 0 || t <= 0 || h <= 0 || block_size <= 0 || max_pages <= 0) return 1;
  const int split_pages = multi_split_pages(b, t, h, block_size, max_pages);
  return (max_pages + split_pages - 1) / split_pages;
}

// q (b, t, h, d) with element strides q_sb, q_st, q_sh and a unit stride
// on d; caches, scales, block_tables and seq_lens as apex_flash_decode's
// (k_cache/v_cache 16-byte aligned; seq_lens counts the chunk); out (b, t,
// h, d) contiguous.  part_o and part_ml are fp32 scratch of
// apex_flash_decode_multi_plan(...) * b * t * h * d and * 2 floats (unused,
// may be null, at one split).  Same dtype codes, d in {64, 128}, bs <= 256.
int apex_flash_decode_multi(const void* q, const void* k_cache, const void* v_cache,
                            const void* k_scale, const void* v_scale,
                            const void* block_tables, const void* seq_lens,
                            void* part_o, void* part_ml, void* out, int b, int t,
                            int h, int d, int block_size, int max_pages,
                            long long q_sb, long long q_st, long long q_sh,
                            float scale, int dtype, int cache_dtype, void* stream) {
  if (b <= 0 || t <= 0 || h <= 0 || block_size <= 0 ||
      block_size > kMaxBlockSize || max_pages <= 0 || b > 65535)
    return cudaErrorInvalidValue;
  const int rows = multi_block_rows(t);
  if ((long long)((t + rows - 1) / rows) *
          apex_flash_decode_multi_plan(b, t, h, block_size, max_pages) > 65535)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(k_cache) % 16 || reinterpret_cast<uintptr_t>(v_cache) % 16)
    return cudaErrorMisalignedAddress;
  return multi_dispatch(q, k_cache, v_cache, k_scale, v_scale, block_tables, seq_lens,
                        part_o, part_ml, out, b, t, h, d, block_size, max_pages, q_sb,
                        q_st, q_sh, scale, dtype, cache_dtype,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
