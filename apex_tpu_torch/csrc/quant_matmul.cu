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
// Row 16, what bounds it on the H100: bytes.  At M = 8 each code is used
// 8 times, 16 FLOPs a byte read, far below the card's ~295 bf16
// operations a byte; the (K, N) code stream is the cost (GPT-345M's qkv
// 3.1 MB, about 1 us at 3.35 TB/s).  The design: blocks of 256 threads
// each own a strip of 32 columns and a split of K; the strip's splits (at
// most 4, toward two blocks an SM: 4 for N = 1024, 2 for N = 3072 or
// 4096) form one thread-block cluster.  Of caps 1, 2, 4 and 8, 4 gave the
// least time summed over a layer's four decode linears on the H100 (8-block
// clusters ran the N = 1024 shapes slower than 2 or 4).  A block stages x (zero-padded to
// 8 rows) in shared memory as fp32, 16 bytes a load, 1024 K at a time;
// each thread owns an 8-column group of the strip (one 8-byte load of 8
// consecutive codes per K row, four threads cover a 32-byte sector) and
// every 64th K row of the split, with eight loads in flight before it
// converts and accumulates, in an (8 rows x 8 columns) fp32 accumulator.  Partials are reduced in a
// fixed order: shuffles across a warp's 8 K lanes, the 8 warps' partials
// in shared memory, and the cluster's rank-0 block adding the ranks' in
// rank order through distributed shared memory.  One launch, no atomics,
// no scratch in device memory; results repeat bitwise.  The column scale
// multiplies each sum once.  On the TPU the grid walked K in order with
// an fp32 VMEM accumulator; here K is split over warps and over the
// cluster's blocks instead.  Tails: N or K not a multiple of 8 (or a
// misaligned pointer) takes element loads with bounds checks, K tails end
// the walk early; both inside the kernel.  Later work: byte-to-float
// conversion by permutes instead of I2F, and bf16 x on the tensor cores
// (M padded to 16).
//
// Row 17, what bounds it: operations.  A 704-row prefill does 2 * 704
// FLOPs per code.  bf16 / fp16 x runs on the tensor cores: the codes +-127
// are exact in bf16 and fp16, so an mma.sync m16n8k16 product with fp32
// accumulation forms the same exact products as JAX's fp32 dot_general.
// Blocks own 64 x 64 output tiles (4 warps of 32 x 32), step K by 32 with
// the x rows and the codes (converted to x's type, stored n-major so a k
// pair is one 32-bit fragment word; rows padded to 80 bytes so fragment
// reads hit distinct banks) in shared memory, and apply the scale at the
// store.  fp32 x (the O0 check) takes the classic FMA tile: 64 x 64
// outputs, 256 threads each a 4 x 4 register tile, 16-deep K steps.
// Every edge is masked in both.  Later work: wgmma with TMA-fed,
// multi-stage shared-memory rings.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

namespace cg = cooperative_groups;

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

constexpr int kMmaM = 64;
constexpr int kMmaN = 64;
constexpr int kMmaK = 32;
constexpr int kMmaThreads = 128;   // 2 x 2 warps, each a 32 x 32 tile
constexpr int kMmaPad = 8;         // row pad: 80-byte rows, conflict-free

union Codes16 {
  int4 v;
  int8_t b[16];
};

template <typename TX> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};
template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ uint32_t pair_at(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 64 x 64 output tiles, 32-deep K steps: x rows and the codes (converted to
// x's type, exact for +-127, stored n-major so a k pair is one 32-bit
// word) in shared memory, m16n8k16 products accumulated in fp32 registers
template <typename TX, typename TO, bool VEC>
__global__ void __launch_bounds__(kMmaThreads)
quant_mma_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, TO* __restrict__ out, int m, int n,
                 int k) {
  __shared__ __align__(16) TX xs[kMmaM][kMmaK + kMmaPad];
  __shared__ __align__(16) TX ws[kMmaN][kMmaK + kMmaPad];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, tg = lane & 3;
  const int m0 = blockIdx.y * kMmaM;
  const int n0 = blockIdx.x * kMmaN;
  const TX zero = from_f<TX>(0.f);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kMmaK) {
    {  // x: row tid / 2, 16 consecutive k from (tid % 2) * 16
      const int r = tid >> 1, kk = (tid & 1) * 16;
      const int gm = m0 + r;
      const TX* xp = x + (size_t)gm * k + k0 + kk;
      if (VEC && gm < m && k0 + kk + 16 <= k) {
        const uint4* src = reinterpret_cast<const uint4*>(xp);
        uint4* dst = reinterpret_cast<uint4*>(&xs[r][kk]);
        dst[0] = __ldg(src);
        dst[1] = __ldg(src + 1);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          xs[r][kk + j] = gm < m && k0 + kk + j < k ? xp[j] : zero;
      }
    }
    {  // codes: k row tid / 4, 16 consecutive columns from (tid % 4) * 16
      const int kk = tid >> 2, nn = (tid & 3) * 16;
      const int gk = k0 + kk, gn = n0 + nn;
      const int8_t* wp = w + (size_t)gk * n + gn;
      Codes16 u;
      if (VEC && gk < k && gn + 16 <= n) {
        u.v = __ldg(reinterpret_cast<const int4*>(wp));
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) u.b[j] = gk < k && gn + j < n ? wp[j] : int8_t(0);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) ws[nn + j][kk] = from_f<TX>(static_cast<float>(u.b[j]));
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kMmaK; ks += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16 + g;
        a[i][0] = pair_at(&xs[r][ks + tg * 2]);
        a[i][1] = pair_at(&xs[r + 8][ks + tg * 2]);
        a[i][2] = pair_at(&xs[r][ks + tg * 2 + 8]);
        a[i][3] = pair_at(&xs[r + 8][ks + tg * 2 + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cn = wn * 32 + j * 8 + g;
        b[j][0] = pair_at(&ws[cn][ks + tg * 2]);
        b[j][1] = pair_at(&ws[cn][ks + tg * 2 + 8]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Mma<TX>::run(acc[i][j], a[i], b[j]);
    }
    __syncthreads();  // the tiles are rewritten by the next K step
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gm = m0 + wm * 32 + i * 16 + g + (e >> 1) * 8;
        const int gn = n0 + wn * 32 + j * 8 + tg * 2 + (e & 1);
        if (gm < m && gn < n) out[(size_t)gm * n + gn] = from_f<TO>(acc[i][j][e] * scale[gn]);
      }
}

template <typename TX, typename TO>
cudaError_t launch(bool gemv, const void* x, const void* w, const void* scale,
                   void* out, int m, int n, int k, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  TO* op = static_cast<TO*>(out);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  if (gemv) {
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
    const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
    const cudaError_t e =
        n % kGemvCols == 0 && wa % kGemvCols == 0 && k % 8 == 0 && xa % 16 == 0
            ? cudaLaunchKernelEx(&cfg, quant_gemv_kernel<TX, TO, true>, xp, wp, sp, op,
                                 m, n, k, k_split)
            : cudaLaunchKernelEx(&cfg, quant_gemv_kernel<TX, TO, false>, xp, wp, sp,
                                 op, m, n, k, k_split);
    if (e != cudaSuccess) return e;
  } else if constexpr (!std::is_same<TX, float>::value) {
    const dim3 grid((n + kMmaN - 1) / kMmaN, (m + kMmaM - 1) / kMmaM);
    const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
    if (k % 8 == 0 && n % 16 == 0 && xa % 16 == 0 && wa % 16 == 0)
      quant_mma_kernel<TX, TO, true><<<grid, kMmaThreads, 0, stream>>>(xp, wp, sp, op, m,
                                                                      n, k);
    else
      quant_mma_kernel<TX, TO, false><<<grid, kMmaThreads, 0, stream>>>(xp, wp, sp, op,
                                                                       m, n, k);
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
