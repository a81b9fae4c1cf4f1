// int8 weight-only matmul for Hopper (sm_90a), plain C interface.
//
// Replaces: apex_tpu/ops/quant_matmul.py `_quant_gemv` (row 16, the decode
// path, M <= 8 rows) and `_quant_tiled` (row 17, prefill / verify / chunk,
// M > 8), both the Pallas kernel `_qmm_kernel`: out = (x @ wq) * scale,
// x (M, K) float, wq (K, N) int8 row-major, scale (N,) fp32 (one
// symmetric scale per output column), fp32 accumulation, the scale
// applied once to the accumulated sum, the result cast to the out dtype.
// The codes +-127 are exact in fp32 and the products are formed in fp32,
// as JAX's fp32 dot_general forms them.
//
// Row 16, what bounds it on the H100: bytes, and at these sizes latency.
// At M = 8 each code is used 8 times, 16 FLOPs a byte read, far below the
// card's ~295 bf16 operations a byte; the (K, N) code stream is the cost
// (GPT-345M's qkv 3.1 MB, about 1 us at 3.35 TB/s), and a launch's fixed
// steps (the first loads' latency, the reduction, the cluster barrier)
// weigh as much again.  bf16 / fp16 x runs on the tensor cores
// (`quant_gemv_mma_kernel`): outᵀ = wqᵀ · xᵀ, 16 code columns the m16
// operand of an mma.sync m16n8k16 and x's (at most 8) rows the n8 one, so
// no row of the tile is padding (x padded to m16 against n8 tiles of
// codes, the other layout, did twice the products and ran slower on the
// H100).  Each lane loads 16 bytes of one K row (4 rows of 128 contiguous
// bytes a warp load) and 16 bytes of x: its loads are its fragments, the
// codes converted in registers by row 17's `code_pair` (exact, no I2F),
// the products exact in fp32 as in JAX's fp32 dot_general.  A warp owns
// 128 columns and walks 32-row chunks of K, two chunks' loads in flight
// before the first product; nothing is staged ahead of them.  K splits
// over the warps of a block and over up to 8 blocks of a thread-block
// cluster, toward one block an SM: 4 warps a block where each warp then
// takes at most one pair of chunks (more blocks, over more SMs), else 8
// (GPT-345M's qkv, dense, fc1: 8 splits of 4 warps; fc2, K = 4096: 8 of
// 8).  The warps' partials meet in shared memory in warp order; each rank
// pushes its sums of every rank's share into that rank's inbox through
// distributed shared memory, and after one cluster barrier (its arrival
// half issued at the start, so the pushes wait on nothing) each rank adds
// its inbox in rank order: no atomics, results repeat bitwise.  The
// column scale, loaded before the walk, multiplies each sum once.  On the
// TPU the grid walked K in order with an fp32 VMEM accumulator.  fp32 x
// (the O0 check) keeps the FMA kernel (`quant_gemv_kernel`): blocks of 256
// threads own a strip of 32 columns and a split of K (at most 4 a
// cluster), x staged in shared memory as fp32, each thread an 8 x 8 fp32
// accumulator, partials reduced by shuffles, shared memory and the
// cluster's rank 0.  Tails: N or K not a multiple of the vector loads (or
// a misaligned pointer) take element loads with bounds checks, K tails
// end the walk early; both inside the kernels.  Later work: one fewer
// instruction a bf16 code pair (a sign-split bias on bf16x2), and wgmma.
//
// Row 17, what bounds it: operations at a prefill's M (704 rows do 2 * 704
// FLOPs a code), bytes at the verify's and the chunk's (M = 24 or 32: the
// code stream, 3.1 MB for GPT-345M's qkv).  bf16 / fp16 x runs on the
// tensor cores: the codes +-127 are exact in bf16 and fp16, so an
// mma.sync m16n8k16 product with fp32 accumulation forms the same exact
// products as JAX's fp32 dot_general.  On the TPU the grid walked K in
// order with an fp32 VMEM accumulator.  Here the codes never pass through
// an int-to-float conversion: a lane builds its B fragments in registers
// from the raw bytes (`code_pair`: bf16 from the float 2^23 + c + 128, fp16
// from the half 1024 + c + 128, each less its bias; exact), the pairs of
// K rows a fragment needs read as one word a row, 4 columns wide, n8
// tile i's column g standing for column 4g + i (8g + i in the small
// kernel).  Above 32 rows (`quant_mma_kernel`): 64 x 128 output tiles of 4
// warps (64 x 32 each) walk K through a ring of three `cp.async` stages
// (64 K rows of x and of the raw codes, 16 bytes a thread; code rows
// padded to 144 bytes so a fragment's word reads hit distinct banks), one
// barrier a stage, x's fragments by `ldmatrix`.  At 9-32 rows
// (`quant_small_kernel`) the code stream is the cost: a block owns a strip
// of 64 columns and 32 rows, its 4 warps share its K range, and each lane
// loads its fragments straight from device memory (8 bytes of codes a K
// row, 8 bytes of x a row, 4 k-steps in flight), so nothing waits on
// shared memory until the sums.  Where the tiles (or strips) are fewer
// than twice the SMs, K is split over up to 4 blocks of a thread-block
// cluster; the warps' partials meet in shared memory in warp order and the
// ranks' through distributed shared memory in rank order, each rank summing
// its share of the tile: no atomics, results repeat bitwise.  Of cluster
// caps 1, 2, 4 and 8 on the H100, 4 gave the least time summed over the
// Q8 serve's shapes (8 clusters ran the verify's qkv 1.6x slower).  The
// column scale multiplies each sum once at the store.  fp32 x (the O0
// check) takes the classic FMA tile: 64 x 64 outputs, 256 threads each a
// 4 x 4 register tile, 16-deep K steps.  Every edge is masked; N or K off
// the vector loads (or a misaligned pointer) loads by element.  Later
// work: wgmma with TMA-fed rings, and larger tiles at large M.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

// to_f / from_f, and the tensor-core primitives (ldmatrix, cp.async,
// mma.sync m16n8k16, pack2) the flash kernels share
#include "flash_mma.cuh"

namespace cg = cooperative_groups;

namespace {

// --- row 16: the GEMV -------------------------------------------------

constexpr int kGemvRows = 8;                               // M <= 8
constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kGemvStrip = 32;                             // columns a block owns
constexpr int kGemvCols = 8;                               // columns a thread owns
constexpr int kGemvGroups = kGemvStrip / kGemvCols;        // 4 column groups
constexpr int kGemvKLanes = kGemvThreads / kGemvGroups;    // 64 K lanes
constexpr int kGemvKTile = 1024;                           // K rows of x staged
constexpr int kGemvInFlight = 8;                           // loads before use
constexpr int kGemvMaxSplits = 4;                          // blocks a cluster
constexpr int kGemvTargetBlocks = 2 * 132;                 // two blocks an SM

union Codes8 {
  uint2 v;
  int8_t b[8];
};

// 8 codes of one K row from column c: one 8-byte load, or byte loads
// with the columns past n read as 0
template <bool VEC>
__device__ __forceinline__ uint2 load_codes(const int8_t* __restrict__ row, int c,
                                            int n) {
  Codes8 u;
  if (VEC) {
    u.v = c < n ? __ldg(reinterpret_cast<const uint2*>(row + c)) : make_uint2(0, 0);
  } else {
#pragma unroll
    for (int j = 0; j < kGemvCols; ++j) u.b[j] = c + j < n ? row[c + j] : int8_t(0);
  }
  return u.v;
}

// Grid (strips, splits), one cluster of `splits` blocks per strip: block
// (s, r) sums K rows [r * k_split, (r + 1) * k_split) and the cluster's
// rank-0 block adds the ranks' partials in rank order through
// distributed shared memory.
template <typename TX, typename TO, bool VEC>
__global__ void __launch_bounds__(kGemvThreads, 2)
quant_gemv_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, TO* __restrict__ out, int m,
                  int n, int k, int k_split) {
  __shared__ float xs[kGemvRows][kGemvKTile];
  __shared__ float red[kGemvWarps][kGemvRows][kGemvStrip];

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = tid % kGemvGroups;
  const int klane = tid / kGemvGroups;
  const int strip0 = blockIdx.x * kGemvStrip;
  const int c = strip0 + grp * kGemvCols;
  const int kbeg = blockIdx.y * k_split;
  const int kend = min(k, kbeg + k_split);

  float acc[kGemvRows][kGemvCols];
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r)
#pragma unroll
    for (int j = 0; j < kGemvCols; ++j) acc[r][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kGemvKTile) {
    const int kt = min(kGemvKTile, kend - k0);
    __syncthreads();  // the previous tile of x is consumed
    // x's rows as 16-byte vectors (VEC: k and k0 are multiples of the
    // vector), the rest element by element; rows past m are zeros
    constexpr int kVec = 16 / sizeof(TX);
    const int kv = VEC ? kt / kVec * kVec : 0;
    for (int i = tid; i < kGemvRows * (kv / kVec); i += kGemvThreads) {
      const int r = i / (kv / kVec), kk = (i - r * (kv / kVec)) * kVec;
      const uint4 v = r < m
          ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)r * k + k0 + kk))
          : make_uint4(0, 0, 0, 0);
      const TX* e = reinterpret_cast<const TX*>(&v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) xs[r][kk + j] = r < m ? to_f<TX>(e[j]) : 0.f;
    }
    for (int i = tid; i < kGemvRows * (kt - kv); i += kGemvThreads) {
      const int r = i / (kt - kv), kk = kv + i - r * (kt - kv);
      xs[r][kk] = r < m ? to_f<TX>(x[(size_t)r * k + k0 + kk]) : 0.f;
    }
    __syncthreads();
    for (int kb = klane; kb < kt; kb += kGemvInFlight * kGemvKLanes) {
      uint2 raw[kGemvInFlight];
#pragma unroll
      for (int u = 0; u < kGemvInFlight; ++u) {
        const int kk = kb + u * kGemvKLanes;
        raw[u] = kk < kt ? load_codes<VEC>(w + (size_t)(k0 + kk) * n, c, n)
                         : make_uint2(0, 0);
      }
#pragma unroll
      for (int u = 0; u < kGemvInFlight; ++u) {
        const int kk = kb + u * kGemvKLanes;
        if (kk < kt) {
          Codes8 cu;
          cu.v = raw[u];
          float wv[kGemvCols];
#pragma unroll
          for (int j = 0; j < kGemvCols; ++j) wv[j] = static_cast<float>(cu.b[j]);
#pragma unroll
          for (int r = 0; r < kGemvRows; ++r) {
            const float xv = xs[r][kk];
#pragma unroll
            for (int j = 0; j < kGemvCols; ++j) acc[r][j] = fmaf(xv, wv[j], acc[r][j]);
          }
        }
      }
    }
  }
  // the 8 K lanes of a warp that share a column group (lanes equal mod 4),
  // reduced in a fixed butterfly order
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r)
#pragma unroll
    for (int j = 0; j < kGemvCols; ++j) {
      float v = acc[r][j];
#pragma unroll
      for (int o = kGemvGroups; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[r][j] = v;
    }
  if (lane < kGemvGroups) {
#pragma unroll
    for (int r = 0; r < kGemvRows; ++r)
#pragma unroll
      for (int j = 0; j < kGemvCols; ++j) red[warp][r][grp * kGemvCols + j] = acc[r][j];
  }
  cluster.sync();  // every rank's partials are in its shared memory
  if (cluster.block_rank() == 0) {
    // one thread per (row, column) of the strip sums ranks, then warps, in order
    const int r = tid / kGemvStrip;
    const int cc = tid % kGemvStrip;
    const int col = strip0 + cc;
    float s = 0.f;
    for (unsigned rank = 0; rank < cluster.num_blocks(); ++rank) {
      const float* part = cluster.map_shared_rank(&red[0][0][0], rank);
#pragma unroll
      for (int wp = 0; wp < kGemvWarps; ++wp)
        s += part[(wp * kGemvRows + r) * kGemvStrip + cc];
    }
    if (r < m && col < n) out[(size_t)r * n + col] = from_f<TO>(s * scale[col]);
  }
  cluster.sync();  // the other ranks' shared memory stays until it is read
}

// K splits for n columns: toward two blocks an SM, at most kGemvMaxSplits,
// and at least 2 * 64 K rows a split
int gemv_splits(int n, int k) {
  const int strips = (n + kGemvStrip - 1) / kGemvStrip;
  int splits = kGemvTargetBlocks / strips;
  splits = min(splits, kGemvMaxSplits);
  splits = min(splits, k / (2 * kGemvKLanes));
  return max(splits, 1);
}

// K rows a split: a multiple of 64, so every split starts on a vector of x
int gemv_k_split(int k, int splits) {
  const int per = (k + splits - 1) / splits;
  return (per + 63) / 64 * 64;
}

// --- row 17: the tiled kernel -----------------------------------------

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 16;
constexpr int kTileThreads = 256;  // 16 x 16, each a 4 x 4 register tile

template <typename TX, typename TO, bool VEC>
__global__ void __launch_bounds__(kTileThreads)
quant_tiled_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, TO* __restrict__ out, int m,
                   int n, int k) {
  // K-major tiles, rows padded to 68 floats (272 bytes: float4-aligned)
  __shared__ __align__(16) float xs[kTileK][kTileM + 4];
  __shared__ __align__(16) float ws[kTileK][kTileN + 4];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // the thread's 4 columns: tx * 4 ...
  const int ty = tid >> 4;  // its 4 rows: ty * 4 ...
  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;
  // load roles: x row xr, K offset xk (4 consecutive); code row wk,
  // column wn (4 consecutive)
  const int xr = tid >> 2, xk = (tid & 3) * 4;
  const int wk = tid >> 4, wn = (tid & 15) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kTileK) {
    {
      const int gm = m0 + xr;
      const TX* xp = x + (size_t)gm * k;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gk = k0 + xk + j;
        xs[xk + j][xr] = gm < m && gk < k ? to_f<TX>(xp[gk]) : 0.f;
      }
    }
    {
      const int gk = k0 + wk;
      const int gn = n0 + wn;
      const int8_t* wp = w + (size_t)gk * n + gn;
      if (VEC && gk < k && gn < n) {
        const char4 cw = __ldg(reinterpret_cast<const char4*>(wp));
        ws[wk][wn + 0] = static_cast<float>(cw.x);
        ws[wk][wn + 1] = static_cast<float>(cw.y);
        ws[wk][wn + 2] = static_cast<float>(cw.z);
        ws[wk][wn + 3] = static_cast<float>(cw.w);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ws[wk][wn + j] = gk < k && gn + j < n ? static_cast<float>(wp[j]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // the tiles are rewritten by the next K step
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < n) out[(size_t)gm * n + gn] = from_f<TO>(acc[i][j] * scale[gn]);
    }
  }
}

// --- row 17 for bf16 / fp16 x: the tensor cores ------------------------

// the card's SMs (132 on an H100 SXM), read once
int sm_count() {
  static int sms = 0;
  if (sms <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms <= 0)
      sms = 132;
  }
  return sms;
}

constexpr int kQMaxSplits = 4;  // blocks a cluster

// Codes biased by 0x80 (u = c + 128, one byte each): byte i of a and byte
// j of b as the exact TX pair (c_a in the low half), with no int-to-float
// conversion: bf16 from the float 2^23 + u less 2^23 + 128 (an integer
// below 128 in magnitude, so its top half is its bf16), fp16 from the half
// 1024 + u less 1152
template <typename TX>
__device__ __forceinline__ uint32_t code_pair(uint32_t a, int i, uint32_t b, int j) {
  if constexpr (std::is_same<TX, __half>::value) {
    const uint32_t v = (__byte_perm(a, b, i | ((4 + j) << 8)) & 0x00ff00ffu) | 0x64006400u;
    const uint32_t bias = 0x64806480u;  // (1152, 1152)
    const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&v),
                              *reinterpret_cast<const __half2*>(&bias));
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const float fa = __uint_as_float(__byte_perm(a, 0x4b000000u, 0x7540 | i)) - 8388736.f;
    const float fb = __uint_as_float(__byte_perm(b, 0x4b000000u, 0x7540 | j)) - 8388736.f;
    return __byte_perm(__float_as_uint(fa), __float_as_uint(fb), 0x7632);
  }
}


// a cluster's K splits of a grid (x, y, splits) of per-block partial sums
// [BM][BN] fp32 in each block's shared memory (`red`, written): each rank
// sums its share of the tile over the ranks' partials (all its loads
// issued, then added in rank order) through distributed shared memory and
// stores it, the column scale multiplying each sum; one split stores its
// own
template <typename TO, int BM, int BN, int kThreads>
__device__ __forceinline__ void store_sums(float* red, const float* __restrict__ scale,
                                           TO* __restrict__ out, int m, int n, int m0,
                                           int n0) {
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)cluster.num_blocks();
  if (ranks > 1) cluster.sync();  // every rank's partials are in its shared memory
  else __syncthreads();
  constexpr int kVecs = BM * BN / 4;
  const int per = (kVecs + ranks - 1) / ranks;
  const int v0 = (int)cluster.block_rank() * per;
  const int v1 = min(kVecs, v0 + per);
  for (int v = v0 + (int)threadIdx.x; v < v1; v += kThreads) {
    float4 part[kQMaxSplits];
#pragma unroll
    for (int r = 0; r < kQMaxSplits; ++r)
      if (r < ranks) part[r] = reinterpret_cast<const float4*>(cluster.map_shared_rank(red, r))[v];
    float4 sum = part[0];
#pragma unroll
    for (int r = 1; r < kQMaxSplits; ++r)
      if (r < ranks) {
        sum.x += part[r].x;
        sum.y += part[r].y;
        sum.z += part[r].z;
        sum.w += part[r].w;
      }
    const int gm = m0 + 4 * v / BN, gn = n0 + 4 * v % BN;
    if (gm < m) {
      const float e[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gn + j < n) out[(size_t)gm * n + gn + j] = from_f<TO>(e[j] * scale[gn + j]);
    }
  }
  if (ranks > 1) cluster.sync();  // the other ranks' memory stays until it is read
}

// K splits for a grid of `tiles` blocks: toward two blocks an SM, at most a
// cluster's kQMaxSplits, at least `min_k` K rows a split, a power of 2
int k_splits(int tiles, int k, int min_k) {
  int splits = 1;
  while (splits * 2 <= kQMaxSplits && tiles * splits < 2 * sm_count() &&
         k / (splits * 2) >= min_k)
    splits *= 2;
  return splits;
}

// --- row 17, 9-32 rows: codes straight into B fragments ----------------

constexpr int kSmallRows = 32;     // M up to this takes the small kernel
constexpr int kSmallCols = 64;     // columns a warp (and its block) owns
constexpr int kSmallWarps = 4;     // the block's K range split over them
constexpr int kSmallThreads = kSmallWarps * 32;
constexpr int kSmallUnroll = 4;    // k-steps a warp loads before their use
constexpr int kSmallSmem = kSmallWarps * kSmallRows * kSmallCols * 4;

// 8 codes of K row r from column c; columns past n, rows at or past kend: 0
template <bool VEC>
__device__ __forceinline__ uint2 codes8(const int8_t* __restrict__ w, int r, int c, int n,
                                        int kend) {
  if (r >= kend) return make_uint2(0, 0);
  const int8_t* p = w + (size_t)r * n + c;
  if (VEC) return c < n ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0, 0);
  uint32_t v[2] = {0, 0};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (c + j < n) v[j >> 2] |= (uint32_t)(uint8_t)p[j] << (8 * (j & 3));
  return make_uint2(v[0], v[1]);
}

// 4 x values of row r from column kk; rows past m, columns at or past
// kend: 0
template <typename TX, bool VEC>
__device__ __forceinline__ uint2 x4(const TX* __restrict__ x, int r, int kk, int m, int k,
                                    int kend) {
  if (r >= m) return make_uint2(0, 0);
  const TX* p = x + (size_t)r * k + kk;
  if (VEC) return kk < kend ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0, 0);
  const unsigned short* e = reinterpret_cast<const unsigned short*>(p);
  uint32_t v[2] = {0, 0};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (kk + j < kend) v[j >> 1] |= (uint32_t)e[j] << (16 * (j & 1));
  return make_uint2(v[0], v[1]);
}

// Grid (64-column strips, 1, K splits), one cluster of the splits per
// strip.  Warp w of a block takes k-steps w, w + 4, ... (16 K rows each) of
// the block's range.  Lane (g, t) loads, per k-step at K row k0, the codes
// of rows k0 + 4t .. k0 + 4t + 3 at columns 8g .. 8g + 7 (one 8-byte load
// a row) and x's rows g, g + 8, g + 16, g + 24 at columns k0 + 4t .. + 3:
// k-slots 2t, 2t + 1, 2t + 8, 2t + 9 of the m16n8k16 fragments stand for K
// rows 4t .. 4t + 3 in both operands, and column g of n8 tile i for column
// 8g + i, so each lane's loads are its fragments, converted in registers.
// The warps' partials meet in shared memory in warp order, the splits
// through the cluster in rank order.
template <typename TX, typename TO, bool VEC>
__global__ void __launch_bounds__(kSmallThreads)
quant_small_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, TO* __restrict__ out, int m, int n, int k,
                   int k_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* red = reinterpret_cast<float*>(smem_raw);  // [warp][32][64]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * kSmallCols;
  const int kb = blockIdx.z * k_split;
  const int kend = min(k, kb + k_split);
  const int steps = kend > kb ? (kend - kb + 15) / 16 : 0;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int s0 = warp; s0 < steps; s0 += kSmallWarps * kSmallUnroll) {
    uint2 cw[kSmallUnroll][4], xw[kSmallUnroll][4];
#pragma unroll
    for (int u = 0; u < kSmallUnroll; ++u) {
      const int s = s0 + u * kSmallWarps;
      const int k0 = kb + (s < steps ? s : steps) * 16 + 4 * t4;  // past the range: zeros
#pragma unroll
      for (int j = 0; j < 4; ++j) cw[u][j] = codes8<VEC>(w, k0 + j, n0 + 8 * g, n, kend);
#pragma unroll
      for (int r = 0; r < 4; ++r) xw[u][r] = x4<TX, VEC>(x, g + 8 * r, k0, m, k, kend);
    }
#pragma unroll
    for (int u = 0; u < kSmallUnroll; ++u) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        a[mt][0] = xw[u][2 * mt].x;      // row g, K 4t, 4t + 1
        a[mt][1] = xw[u][2 * mt + 1].x;  // row g + 8
        a[mt][2] = xw[u][2 * mt].y;      // row g, K 4t + 2, 4t + 3
        a[mt][3] = xw[u][2 * mt + 1].y;
      }
      uint32_t c[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j][0] = cw[u][j].x ^ 0x80808080u;
        c[j][1] = cw[u][j].y ^ 0x80808080u;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t b0 = code_pair<TX>(c[0][i >> 2], i & 3, c[1][i >> 2], i & 3);
        const uint32_t b1 = code_pair<TX>(c[2][i >> 2], i & 3, c[3][i >> 2], i & 3);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma16816<TX>(acc[mt][i], a[mt], b0, b1);
      }
    }
  }
  // the warps' partials, then their sum in warp order into warp 0's
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * kSmallRows + mt * 16 + g + 8 * (e >> 1)) * kSmallCols +
            8 * (2 * t4 + (e & 1)) + i] = acc[mt][i][e];
  __syncthreads();
  constexpr int kTile = kSmallRows * kSmallCols;
  for (int i = tid; i < kTile; i += kSmallThreads) {
    float sum = red[i];
#pragma unroll
    for (int wp = 1; wp < kSmallWarps; ++wp) sum += red[wp * kTile + i];
    red[i] = sum;
  }
  store_sums<TO, kSmallRows, kSmallCols, kSmallThreads>(red, scale, out, m, n, 0, n0);
}

// --- row 17, above 32 rows: staged tiles -------------------------------

constexpr int kQK = 64;      // K rows a stage holds
constexpr int kQStages = 3;  // stages in the ring
constexpr int kQBM = 64;     // a block's rows
constexpr int kQBN = 128;    // its columns
constexpr int kQWarps = 4;   // each 64 x 32
constexpr int kQThreads = 32 * kQWarps;
constexpr int kQXP = kQK + 8;    // x row pitch, elements (16-byte pad)
constexpr int kQRP = kQBN + 16;  // code row pitch, bytes: rows 2 apart 8 banks apart
constexpr int kQXBytes = kQBM * kQXP * 2;
constexpr int kQStageBytes = kQXBytes + kQK * kQRP;
constexpr int kQSmem = kQStages * kQStageBytes;
static_assert(kQBM * kQBN * 4 <= kQSmem, "the partials reuse the stages");

// stage of x rows [m0, m0 + 64) and code rows [k0, k0 + 64) of columns
// [n0, n0 + 128): by cp.async, 16 bytes a thread (VEC), else by element;
// x's columns and the code rows at or past kend, rows past m and columns
// past n read as 0
template <typename TX, bool VEC>
__device__ __forceinline__ void load_stage(unsigned char* st, const TX* __restrict__ x,
                                           const int8_t* __restrict__ w, int m, int n,
                                           int k, int m0, int n0, int k0, int kend) {
  TX* xs = reinterpret_cast<TX*>(st);
  int8_t* raw = reinterpret_cast<int8_t*>(st + kQXBytes);
  if constexpr (VEC) {
    constexpr int kXC = kQK / 8;   // 16-byte chunks of an x row
    constexpr int kWC = kQBN / 16;  // of a code row
    for (int i = threadIdx.x; i < kQBM * kXC; i += kQThreads) {
      const int r = i / kXC, c = (i - r * kXC) * 8;
      const bool ok = m0 + r < m && k0 + c < kend;
      cp_async16(xs + r * kQXP + c, ok ? x + (size_t)(m0 + r) * k + k0 + c : x, ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < kQK * kWC; i += kQThreads) {
      const int r = i / kWC, c = (i - r * kWC) * 16;
      const bool ok = k0 + r < kend && n0 + c < n;
      cp_async16(raw + r * kQRP + c, ok ? w + (size_t)(k0 + r) * n + n0 + c : w, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kQBM * kQK; i += kQThreads) {
      const int r = i / kQK, c = i - r * kQK;
      xs[r * kQXP + c] = m0 + r < m && k0 + c < kend ? x[(size_t)(m0 + r) * k + k0 + c]
                                                     : from_f<TX>(0.f);
    }
    for (int i = threadIdx.x; i < kQK * kQBN; i += kQThreads) {
      const int r = i / kQBN, c = i - r * kQBN;
      raw[r * kQRP + c] = k0 + r < kend && n0 + c < n ? w[(size_t)(k0 + r) * n + n0 + c]
                                                      : int8_t(0);
    }
  }
}

// acc += the stage's 64 x rows (A fragments by ldmatrix) times the warp's
// 32 columns of raw codes (from wn0): lane (g, t) reads K rows 2t, 2t + 1,
// 2t + 8, 2t + 9 of each k-step at columns 4g .. 4g + 3, one word a row,
// and converts them in registers into the B fragments of 4 n8 tiles, tile
// i's column g standing for column 4g + i
template <typename TX>
__device__ __forceinline__ void mma_stage(float (&acc)[4][4][4], const TX* xs,
                                          const int8_t* raw, int wn0, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kQK / 16; ++ks) {
    uint32_t af[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      ldsm_x4(af[mt], xs + (mt * 16 + (lane & 15)) * kQXP + ks * 16 + (lane >> 4) * 8);
    const int8_t* rp = raw + (ks * 16 + 2 * t4) * kQRP + wn0 + 4 * g;
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(rp) ^ 0x80808080u;
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(rp + kQRP) ^ 0x80808080u;
    const uint32_t w2 = *reinterpret_cast<const uint32_t*>(rp + 8 * kQRP) ^ 0x80808080u;
    const uint32_t w3 = *reinterpret_cast<const uint32_t*>(rp + 9 * kQRP) ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t b0 = code_pair<TX>(w0, i, w1, i);
      const uint32_t b1 = code_pair<TX>(w2, i, w3, i);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) mma16816<TX>(acc[mt][i], af[mt], b0, b1);
    }
  }
}

// Grid (128-column tiles, 64-row tiles, K splits), the splits one cluster.
// Block (x, y, z) sums K rows [z * k_split, (z + 1) * k_split) of its tile
// through the stage ring, one barrier a stage: stages t + 1 and t + 2 load
// while stage t is multiplied.
template <typename TX, typename TO, bool VEC>
__global__ void __launch_bounds__(kQThreads)
quant_mma_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, TO* __restrict__ out, int m, int n, int k,
                 int k_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wn0 = warp * (kQBN / kQWarps);
  const int m0 = blockIdx.y * kQBM;
  const int n0 = blockIdx.x * kQBN;
  const int kb = blockIdx.z * k_split;
  const int kend = min(k, kb + k_split);
  const int nk = kend > kb ? (kend - kb + kQK - 1) / kQK : 0;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kQStages - 1; ++st) {
    if (st < nk)
      load_stage<TX, VEC>(smem_raw + st * kQStageBytes, x, w, m, n, k, m0, n0,
                          kb + st * kQK, kend);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kQStages - 2>();
    __syncthreads();  // stage t is in; step t - 1 is done with its stage
    const int nt = t + kQStages - 1;
    if (nt < nk)
      load_stage<TX, VEC>(smem_raw + (nt % kQStages) * kQStageBytes, x, w, m, n, k, m0, n0,
                          kb + nt * kQK, kend);
    cp_async_commit();
    const unsigned char* st = smem_raw + (t % kQStages) * kQStageBytes;
    mma_stage<TX>(acc, reinterpret_cast<const TX*>(st),
                  reinterpret_cast<const int8_t*>(st + kQXBytes), wn0, lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage consumed: the partials take their memory
  float* red = reinterpret_cast<float*>(smem_raw);  // [64][128]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(i * 16 + g + (e >> 1) * 8) * kQBN + wn0 + 4 * (2 * t4 + (e & 1)) + j] =
            acc[i][j][e];
  store_sums<TO, kQBM, kQBN, kQThreads>(red, scale, out, m, n, m0, n0);
}

// one cluster launch of a row-17 kernel: grid (x, y, splits), cluster (1,
// 1, splits), `smem` bytes of dynamic shared memory
template <typename K, typename TX, typename TO>
cudaError_t launch_cluster(K kern, dim3 grid, int threads, int smem, const TX* x,
                           const int8_t* w, const float* sc, TO* out, int m, int n, int k,
                           int k_split, cudaStream_t stream) {
  if (smem > 48 * 1024) {  // the default limit needs no call a launch
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, x, w, sc, out, m, n, k, k_split);
}

// K rows a split: whole stages (or k-steps), so splits start aligned
int split_rows(int k, int splits, int step) {
  const int per = (k + splits - 1) / splits;
  return (per + step - 1) / step * step;
}

// row 17 for M rows: the small kernel up to 32 rows (64-column strips, K
// split toward two blocks an SM, at least 128 K rows a split), else the
// staged 64 x 128 tiles (K split likewise, at least two stages a split)
template <typename TX, typename TO, bool VEC>
cudaError_t launch_mma(const TX* x, const int8_t* w, const float* sc, TO* out, int m, int n,
                       int k, cudaStream_t stream) {
  if (m <= kSmallRows) {
    const int strips = (n + kSmallCols - 1) / kSmallCols;
    const int splits = k_splits(strips, k, 128);
    return launch_cluster(quant_small_kernel<TX, TO, VEC>, dim3(strips, 1, splits),
                          kSmallThreads, kSmallSmem, x, w, sc, out, m, n, k,
                          split_rows(k, splits, 16), stream);
  }
  const dim3 tiles((n + kQBN - 1) / kQBN, (m + kQBM - 1) / kQBM, 1);
  const int splits = k_splits(tiles.x * tiles.y, k, 2 * kQK);
  return launch_cluster(quant_mma_kernel<TX, TO, VEC>, dim3(tiles.x, tiles.y, splits),
                        kQThreads, kQSmem, x, w, sc, out, m, n, k,
                        split_rows(k, splits, kQK), stream);
}

// --- row 16 for bf16 / fp16 x: the tensor cores ------------------------

constexpr int kGvCols = 128;                    // columns a warp (and its block) owns
constexpr int kGvSteps = 2;                     // k-steps (16 K rows) a chunk
constexpr int kGvChunk = 16 * kGvSteps;         // K rows a warp takes at a time
constexpr int kGvUnroll = 2;                    // chunks a warp loads before their use
constexpr int kGvMaxSplits = 8;                 // blocks a cluster
constexpr int kGvVecs = kGemvRows * kGvCols / 4;  // a block's float4 sums
// shared memory of a block of `warps`: their partials, then the inbox of
// the ranks' sums
constexpr int gv_smem(int warps) { return (warps + 1) * kGvVecs * 16 + kGvMaxSplits * 16; }

// the cluster barrier in two halves: arrive (relaxed: no memory order, or
// releasing this thread's writes) and wait (acquiring the others')
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// 16 codes of K row r from column c; columns past n, rows at or past kend: 0
template <bool VEC>
__device__ __forceinline__ uint4 codes16(const int8_t* __restrict__ w, int r, int c, int n,
                                         int kend) {
  if (r >= kend) return make_uint4(0, 0, 0, 0);
  const int8_t* p = w + (size_t)r * n + c;
  if (VEC) return c < n ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
  uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (c + j < n) v[j >> 2] |= (uint32_t)(uint8_t)p[j] << (8 * (j & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// 8 x values of row r from column kk; rows past m, columns at or past
// kend: 0
template <typename TX, bool VEC>
__device__ __forceinline__ uint4 x8(const TX* __restrict__ x, int r, int kk, int m, int k,
                                    int kend) {
  if (r >= m) return make_uint4(0, 0, 0, 0);
  const TX* p = x + (size_t)r * k + kk;
  if (VEC) return kk < kend ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
  const unsigned short* e = reinterpret_cast<const unsigned short*>(p);
  uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (kk + j < kend) v[j >> 1] |= (uint32_t)e[j] << (16 * (j & 1));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Grid (128-column strips, 1, K splits), one cluster of the splits per
// strip, kWarps warps a block.  Warp w of a block takes 32-row chunks w, w
// + kWarps, ... of the block's K range, two at a time.  Lane (g, t) loads,
// per chunk at K row k0, 16 codes (one 16-byte load) of each of rows k0 +
// 8t .. k0 + 8t + 7 at columns 16g .. 16g + 15 of the strip, so the lanes
// of one load cover 4 rows of 128 contiguous bytes, and x's row g at
// columns k0 + 8t .. + 7 (one 16-byte load): k-step s of the chunk reads K
// rows 8t + 4s .. + 3 as k-slots 2t, 2t + 1, 2t + 8, 2t + 9 in both
// operands.  Swapped, m16 tile i's row g stands for column 16g + i and
// row g + 8 for 16g + 8 + i, and n8 column j is x's row j: each lane's
// loads are its fragments, converted in registers (`code_pair`), and its
// sums are x's rows 2t and 2t + 1 at its 16 columns.  The warps' partials
// meet in shared
// memory in warp order; each rank pushes its sums of every rank's share
// into that rank's inbox through distributed shared memory, and after one
// cluster barrier each rank adds its inbox in rank order, the column scale
// (loaded before the walk) multiplying each sum.
template <typename TX, typename TO, bool VEC, int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
quant_gemv_mma_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ scale, TO* __restrict__ out, int m, int n,
                      int k, int k_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* red = reinterpret_cast<float4*>(smem_raw);  // [warp][8 rows][32 float4]
  float4* inbox = red + kWarps * kGvVecs;             // [rank][share]
  constexpr int kThreads = 32 * kWarps;
  constexpr int kOut = (kGvVecs + kThreads - 1) / kThreads;  // a thread's float4 sums
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  cluster_arrive_relaxed();  // this block has started: its inbox may be written
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * kGvCols;
  const int kb = blockIdx.z * k_split;
  const int kend = min(k, kb + k_split);
  const int chunks = kend > kb ? (kend - kb + kGvChunk - 1) / kGvChunk : 0;
  const int share = (kGvVecs + ranks - 1) / ranks;  // float4 sums a rank stores

  // the column scales of this thread's stores, read ahead of the walk
  float sc[kOut][4];
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    const int v = rank * share + tid + j * kThreads;
    const int gn = n0 + 4 * v % kGvCols;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[j][e] = tid + j * kThreads < share && v < kGvVecs && gn + e < n ? scale[gn + e] : 0.f;
  }

  float acc[8][4];  // m16 tile i: columns 16g + i, 16g + 8 + i; x's rows 2t, 2t + 1
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int q0 = warp; q0 < chunks; q0 += kWarps * kGvUnroll) {
    uint4 cw[kGvUnroll][8], xw[kGvUnroll];
#pragma unroll
    for (int u = 0; u < kGvUnroll; ++u) {
      const int q = q0 + u * kWarps;
      if (q >= chunks) continue;  // the same for the whole warp
      const int kr = kb + q * kGvChunk + 8 * t4;
#pragma unroll
      for (int j = 0; j < 8; ++j) cw[u][j] = codes16<VEC>(w, kr + j, n0 + 16 * g, n, kend);
      xw[u] = x8<TX, VEC>(x, g, kr, m, k, kend);
    }
#pragma unroll
    for (int u = 0; u < kGvUnroll; ++u) {
      if (q0 + u * kWarps >= chunks) continue;
#pragma unroll
      for (int s = 0; s < kGvSteps; ++s) {
        uint4 r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          r[j] = cw[u][4 * s + j];
          r[j].x ^= 0x80808080u;
          r[j].y ^= 0x80808080u;
          r[j].z ^= 0x80808080u;
          r[j].w ^= 0x80808080u;
        }
        const uint32_t x0 = word(xw[u], 2 * s), x1 = word(xw[u], 2 * s + 1);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int lo = i >> 2, hi = 2 + (i >> 2), b = i & 3;
          const uint32_t a[4] = {code_pair<TX>(word(r[0], lo), b, word(r[1], lo), b),
                                 code_pair<TX>(word(r[0], hi), b, word(r[1], hi), b),
                                 code_pair<TX>(word(r[2], lo), b, word(r[3], lo), b),
                                 code_pair<TX>(word(r[2], hi), b, word(r[3], hi), b)};
          mma16816<TX>(acc[i], a, x0, x1);
        }
      }
    }
  }
  // the warp's partial [8 rows][128 columns]
  float* part = reinterpret_cast<float*>(red + warp * kGvVecs);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    // e & 1: row 2t + 1; e >> 1: columns 16g + 8 ..
    float* p = part + (2 * t4 + (e & 1)) * kGvCols + 16 * g + 8 * (e >> 1);
    reinterpret_cast<float4*>(p)[0] = make_float4(acc[0][e], acc[1][e], acc[2][e], acc[3][e]);
    reinterpret_cast<float4*>(p)[1] = make_float4(acc[4][e], acc[5][e], acc[6][e], acc[7][e]);
  }
  __syncthreads();
  cluster_wait();  // every rank has started
  // the warps' sum in warp order, pushed to the inbox of the rank that
  // stores it
  for (int v = tid; v < kGvVecs; v += kThreads) {
    float4 sum = red[v];
#pragma unroll
    for (int wp = 1; wp < kWarps; ++wp) {
      const float4 o = red[wp * kGvVecs + v];
      sum.x += o.x;
      sum.y += o.y;
      sum.z += o.z;
      sum.w += o.w;
    }
    const int owner = v / share;
    cluster.map_shared_rank(inbox, owner)[rank * share + v - owner * share] = sum;
  }
  cluster_arrive();
  cluster_wait();  // every rank's sums are in their owners' inboxes
  // this rank's share: the ranks' sums in rank order, scaled and stored
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    const int i = tid + j * kThreads;
    const int v = rank * share + i;
    if (i >= share || v >= kGvVecs) continue;
    float4 sum = inbox[i];
    for (int r = 1; r < ranks; ++r) {
      const float4 o = inbox[r * share + i];
      sum.x += o.x;
      sum.y += o.y;
      sum.z += o.z;
      sum.w += o.w;
    }
    const int gm = 4 * v / kGvCols, gn = n0 + 4 * v % kGvCols;
    if (gm < m) {
      const float e[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (gn + c < n) out[(size_t)gm * n + gn + c] = from_f<TO>(e[c] * sc[j][c]);
    }
  }
}

// K splits of the GEMV over a cluster of blocks of `warps`: at most
// kGvMaxSplits, each warp at least one chunk, toward one block an SM, or
// two where two leave at most an eighth of the SMs without their second
// (on the H100, 192 blocks of 4 warps over 132 SMs ran GPT-345M's qkv
// slower than 96, and 256 ran fc1 faster than 128)
int gemv_mma_splits(int strips, int chunks, int warps) {
  const int sms = sm_count();
  int splits = 1;
  while (splits * 2 <= kGvMaxSplits && chunks >= 2 * splits * warps) {
    const int blocks = 2 * splits * strips;
    if (blocks > sms && (blocks > 2 * sms || 8 * blocks < 15 * sms)) break;
    splits *= 2;
  }
  return splits;
}

// row 16 for bf16 / fp16 x: blocks of 4 warps where each warp then takes
// at most one pair of chunks (the loads of one round in flight, more
// blocks over more SMs), else of 8 (fc2's K = 4096 on 8 strips)
template <typename TX, typename TO, bool VEC>
cudaError_t launch_gemv(const TX* x, const int8_t* w, const float* sc, TO* out, int m, int n,
                        int k, cudaStream_t stream) {
  const int strips = (n + kGvCols - 1) / kGvCols;
  const int chunks = (k + kGvChunk - 1) / kGvChunk;
  const int s4 = gemv_mma_splits(strips, chunks, 4);
  if (chunks <= s4 * 4 * kGvUnroll)
    return launch_cluster(quant_gemv_mma_kernel<TX, TO, VEC, 4>, dim3(strips, 1, s4), 128,
                          gv_smem(4), x, w, sc, out, m, n, k, split_rows(k, s4, kGvChunk),
                          stream);
  const int s8 = gemv_mma_splits(strips, chunks, 8);
  return launch_cluster(quant_gemv_mma_kernel<TX, TO, VEC, 8>, dim3(strips, 1, s8), 256,
                        gv_smem(8), x, w, sc, out, m, n, k, split_rows(k, s8, kGvChunk),
                        stream);
}

template <typename TX, typename TO>
cudaError_t launch(bool gemv, const void* x, const void* w, const void* scale,
                   void* out, int m, int n, int k, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  TO* op = static_cast<TO*>(out);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if constexpr (!std::is_same<TX, float>::value) {
    if (gemv) {
      // VEC: the 16-byte code and x loads are aligned and each wholly in
      // or out
      if (n % 16 == 0 && wa % 16 == 0 && k % 8 == 0 && xa % 16 == 0)
        return launch_gemv<TX, TO, true>(xp, wp, sp, op, m, n, k, stream);
      return launch_gemv<TX, TO, false>(xp, wp, sp, op, m, n, k, stream);
    }
    // VEC: the vector loads (8 bytes in the small kernel, 16 in the
    // staged one) are aligned and each chunk is wholly in or out
    const bool vec = m <= kSmallRows
                         ? k % 4 == 0 && n % 8 == 0 && xa % 8 == 0 && wa % 8 == 0
                         : k % 8 == 0 && n % 16 == 0 && xa % 16 == 0 && wa % 16 == 0;
    if (vec) return launch_mma<TX, TO, true>(xp, wp, sp, op, m, n, k, stream);
    return launch_mma<TX, TO, false>(xp, wp, sp, op, m, n, k, stream);
  } else if (gemv) {
    const int splits = gemv_splits(n, k);
    const int k_split = gemv_k_split(k, splits);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((n + kGemvStrip - 1) / kGemvStrip, splits, 1);
    cfg.blockDim = dim3(kGemvThreads, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = splits;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // VEC: 8-byte code loads and 16-byte x loads are aligned
    const cudaError_t e =
        n % kGemvCols == 0 && wa % kGemvCols == 0 && k % 8 == 0 && xa % 16 == 0
            ? cudaLaunchKernelEx(&cfg, quant_gemv_kernel<TX, TO, true>, xp, wp, sp, op,
                                 m, n, k, k_split)
            : cudaLaunchKernelEx(&cfg, quant_gemv_kernel<TX, TO, false>, xp, wp, sp,
                                 op, m, n, k, k_split);
    if (e != cudaSuccess) return e;
  } else {
    const dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM);
    if (n % 4 == 0 && wa % 4 == 0)
      quant_tiled_kernel<TX, TO, true><<<grid, kTileThreads, 0, stream>>>(xp, wp, sp, op,
                                                                          m, n, k);
    else
      quant_tiled_kernel<TX, TO, false><<<grid, kTileThreads, 0, stream>>>(xp, wp, sp,
                                                                           op, m, n, k);
  }
  return cudaGetLastError();
}

// dtype codes: 0 float32, 1 bfloat16, 2 float16; out is x's dtype or fp32
cudaError_t dispatch(bool gemv, const void* x, const void* w, const void* scale,
                     void* out, int m, int n, int k, int x_dtype, int out_dtype,
                     cudaStream_t s) {
  if (x_dtype == 0 && out_dtype == 0)
    return launch<float, float>(gemv, x, w, scale, out, m, n, k, s);
  if (x_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(gemv, x, w, scale, out, m, n, k, s);
  if (x_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(gemv, x, w, scale, out, m, n, k, s);
  if (x_dtype == 2 && out_dtype == 2)
    return launch<__half, __half>(gemv, x, w, scale, out, m, n, k, s);
  if (x_dtype == 2 && out_dtype == 0)
    return launch<__half, float>(gemv, x, w, scale, out, m, n, k, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// x (m, k) contiguous; wq (k, n) int8 contiguous; scale (n,) fp32; out
// (m, n) contiguous.  The GEMV takes 1 <= m <= 8.
int apex_quant_gemv(const void* x, const void* wq, const void* scale, void* out,
                    int m, int n, int k, int x_dtype, int out_dtype, void* stream) {
  if (m < 1 || m > kGemvRows || n < 1 || k < 1) return cudaErrorInvalidValue;
  return dispatch(true, x, wq, scale, out, m, n, k, x_dtype, out_dtype,
                  static_cast<cudaStream_t>(stream));
}

int apex_quant_tiled(const void* x, const void* wq, const void* scale, void* out,
                     int m, int n, int k, int x_dtype, int out_dtype, void* stream) {
  if (m < 1 || n < 1 || k < 1 || (m + kTileM - 1) / kTileM > 65535)
    return cudaErrorInvalidValue;
  return dispatch(false, x, wq, scale, out, m, n, k, x_dtype, out_dtype,
                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
