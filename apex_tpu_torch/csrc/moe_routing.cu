// Fused MoE routing and capacity dispatch for Hopper (sm_90a), plain C
// interface.
//
// Replaces: apex_tpu/ops/moe_routing.py `_route_dispatch_pallas` (:145)
// running `_route_kernel` (:80-142) — row 18 of the kernel table.  From x
// (T, H) tokens (fp32, bf16 or fp16) and fp32 router logits (T, E) it
// writes the chosen experts and gates of top-1 (Switch) or top-2 (GShard
// Algorithm 1, `all` or `random` second policy), the choice-major capacity
// slots and keep flags, the zero-filled (E, C, H) dispatch buffer holding
// every kept token row, and the auxiliary load-balancing loss
// E * sum_e(frac_e * mean_prob_e) over first choices.  The integer outputs
// are bit-exact against the plain version (apex_tpu_torch/ops/
// moe_routing.py `moe_route_dispatch_reference`): the probabilities are
// computed as it computes them (max-subtracted expf, the fp32 sum, the
// divide) and the argmax takes the lowest index on ties, as jnp.argmax.
//
// What bounds it on the H100: bytes, and at the serve's decode tick the
// launches themselves.  The logits and x's kept rows are read once and the
// (E, C, H) buffer written once; at bench.py's bench_moe_ep shape (T 4096,
// H 256, E 8, C 640, fp32) that is ~9.6 MB, ~2.9 us at 3.35 TB/s.  The
// arithmetic (a softmax over E per token) is negligible.
//
// The TPU kernel is one program over the whole VMEM-resident problem: a
// cumsum over a (k*T, E) one-hot and a serial row loop.  Here tokens go in
// blocks of 32, one warp a token (`route_token`: the softmax and top-k in
// registers and shuffles); a block ranks each valid entry among its
// earlier entries of the same choice and expert, counts its entries per
// (choice, expert) and sums its probabilities per expert in a fixed order
// (`prob_sum`: the result does not depend on scheduling).  Then
// `dispatch_kernel`, 32 warps a block:
// each block sums the counts of the blocks and choices before its own
// (choice-major order) into per-(choice, expert) bases, a warp an
// expert-choice pair over the blocks, and every expert's fill; writes slot
// and keep; copies each kept entry's x row into buf[e, slot], a warp an
// entry, in 16-byte words (4- or 2-byte words when a row is not 16-byte
// sized or aligned); and its warps, strided over the grid, write zeros to
// every row past its expert's fill, so the buffer is written exactly once
// and never memset.  Block 0 also writes the aux loss.
//   - T <= 32 (the serve's decode tick): one launch.  Every block of
//     `dispatch_kernel<W, true>` routes the (at most) 32 tokens itself, in
//     shared memory, so that the copy and the zeros spread over the grid;
//     block 0 writes the route's outputs.
//   - T > 32: two launches, `route_kernel` (a block a 32 tokens: ranks,
//     counts and probability sums to a scratch of ints and floats), then
//     `dispatch_kernel<W, false>`, block b taking the route's block b's
//     entries (a warp an entry of top 1, so the kept rows' copies run
//     side by side) and further blocks only zero rows, up to two blocks an
//     SM.  The dispatch is a programmatic dependent launch: it may start
//     while the route runs and waits for the route's writes
//     (`griddepcontrol`).  A single launch would need a grid-wide wait:
//     second choices' slots follow every block's first choices.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTokPerBlock = 32;
constexpr int kWarps = kTokPerBlock;  // a warp a token, a warp an entry
constexpr int kThreads = 32 * kWarps;
constexpr int kSumWays = 8;           // prob_sum's partial sums
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int route_blocks(int t) {
  return (t + kTokPerBlock - 1) / kTokPerBlock;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// (value, index) argmax across the warp: the larger value, on a tie the
// lower index
__device__ __forceinline__ void warp_argmax(float& best, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (ob > best || (ob == best && oi < bi)) {
      best = ob;
      bi = oi;
    }
  }
}

// programmatic dependent launch (sm_90): the route launch lets the
// dispatch launch start; the dispatch waits for the route's writes
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Token t's route by one warp: its first (and second) expert and gate,
// with the gate 0 where a `random` second choice is dropped; each lane
// writes its experts' probabilities into prow.
__device__ __forceinline__ void route_token(const float* __restrict__ logits,
                                            const float* __restrict__ u, int t, int E,
                                            int top_k, int random, int lane, float* prow,
                                            int& i1, float& g1, int& i2, float& g2) {
  const float* row = logits + (size_t)t * E;
  float m = -INFINITY;
  for (int e = lane; e < E; e += 32) m = fmaxf(m, row[e]);
  m = warp_max(m);
  float s = 0.f;
  for (int e = lane; e < E; e += 32) s += expf(row[e] - m);
  s = warp_sum(s);
  // each lane scans its experts in ascending order: strictly greater
  // keeps the lowest index of a tie within the lane
  float b1 = -1.f;
  i1 = 0x7fffffff;
  for (int e = lane; e < E; e += 32) {
    const float p = expf(row[e] - m) / s;
    prow[e] = p;
    if (p > b1) { b1 = p; i1 = e; }
  }
  warp_argmax(b1, i1);
  g1 = b1;
  g2 = 0.f;
  i2 = 0;
  if (top_k == 2) {
    // probs * (1 - onehot(idx1)): the first choice's entry is 0
    float b2 = -1.f;
    i2 = 0x7fffffff;
    for (int e = lane; e < E; e += 32) {
      const float q = (e == i1) ? 0.f : expf(row[e] - m) / s;
      if (q > b2) { b2 = q; i2 = e; }
    }
    warp_argmax(b2, i2);
    const float denom = fmaxf(b1 + b2, 1e-9f);
    g1 = b1 / denom;
    g2 = b2 / denom;
    if (random && !(u[t] < 2.f * g2)) g2 = 0.f;
  }
}

// The route of the block's tokens t0 .. t0 + 31 into shared memory, warp
// j token t0 + j: ent[c][j] the expert of its choice c, or -1 where it
// claims no slot (gate 0, or past T), with its index and gate; its
// probabilities in row j of sp ([32][E]).
__device__ __forceinline__ void route_block(const float* __restrict__ logits,
                                            const float* __restrict__ u, int t0, int T,
                                            int E, int top_k, int random, float* sp,
                                            int (*ent)[kTokPerBlock],
                                            int (*eidx)[kTokPerBlock],
                                            float (*egate)[kTokPerBlock]) {
  const int j = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = t0 + j;
  int e1 = -1, e2 = -1;
  if (t < T) {
    int i1, i2;
    float g1, g2;
    route_token(logits, u, t, E, top_k, random, lane, sp + (size_t)j * E, i1, g1, i2, g2);
    if (lane == 0) {
      eidx[0][j] = i1;
      egate[0][j] = g1;
      eidx[1][j] = i2;
      egate[1][j] = g2;
    }
    e1 = g1 > 0.f ? i1 : -1;
    e2 = g2 > 0.f ? i2 : -1;
  }
  if (lane == 0) {
    ent[0][j] = e1;
    ent[1][j] = e2;
  }
  __syncthreads();
}

// The probability sum of expert e over the block's first n tokens, in a
// fixed order: the tokens j = w, w + 8, ... into the w-th of eight sums,
// then the eight in order
__device__ __forceinline__ float prob_sum(const float* sp, int E, int e, int n) {
  float s = 0.f;
  for (int w = 0; w < kSumWays; ++w) {
    float m = 0.f;
    for (int j = w; j < n; j += kSumWays) m += sp[(size_t)j * E + e];
    s += m;
  }
  return s;
}

// Launch 1 of the two-launch route: rank, counts (cnt[c][block][e]) and
// the block's probability sums (part_mp[block][e]) for the dispatch.
__global__ void __launch_bounds__(kThreads)
route_kernel(const float* __restrict__ logits, const float* __restrict__ u,
             int T, int E, int top_k, int random, int nb,
             int* __restrict__ idx, float* __restrict__ gate,
             int* __restrict__ rank, int* __restrict__ cnt,
             float* __restrict__ part_mp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sp = reinterpret_cast<float*>(smem_raw);  // [32][E]
  __shared__ int ent[2][kTokPerBlock];
  __shared__ int eidx[2][kTokPerBlock];
  __shared__ float egate[2][kTokPerBlock];
  const int t0 = blockIdx.x * kTokPerBlock;
  launch_dependents();
  route_block(logits, u, t0, T, E, top_k, random, sp, ent, eidx, egate);
  for (int i = threadIdx.x; i < top_k * kTokPerBlock; i += kThreads) {
    const int c = i / kTokPerBlock, j = i - c * kTokPerBlock;
    if (t0 + j >= T) continue;
    const int e = ent[c][j];
    int r = 0;
    for (int jj = 0; jj < j; ++jj) r += ent[c][jj] == e;
    rank[c * T + t0 + j] = r;
    idx[c * T + t0 + j] = eidx[c][j];
    gate[c * T + t0 + j] = egate[c][j];
  }
  for (int i = threadIdx.x; i < top_k * E; i += kThreads) {
    const int c = i / E, e = i - c * E;
    int n = 0;
    for (int j = 0; j < kTokPerBlock; ++j) n += ent[c][j] == e;
    cnt[((size_t)c * nb + blockIdx.x) * E + e] = n;
  }
  const int n = T - t0 < kTokPerBlock ? T - t0 : kTokPerBlock;
  for (int e = threadIdx.x; e < E; e += kThreads)
    part_mp[(size_t)blockIdx.x * E + e] = prob_sum(sp, E, e, n);
}

// One row of `n` W words from `in` to `out` by the warp's lanes, four
// loads in flight before their stores (in null: zeros)
template <typename W>
__device__ __forceinline__ void copy_row(const W* __restrict__ in, W* __restrict__ out,
                                         long long n, int lane) {
  if (in == nullptr) {
    for (long long i = lane; i < n; i += 32) out[i] = W{};
    return;
  }
  long long i = lane;
  for (; i + 96 < n; i += 128) {
    const W a = in[i], b = in[i + 32], c = in[i + 64], d = in[i + 96];
    out[i] = a;
    out[i + 32] = b;
    out[i + 64] = c;
    out[i + 96] = d;
  }
  for (; i < n; i += 32) out[i] = in[i];
}

// The dispatch (see the header).  kOne: T <= 32, every block routes the
// tokens itself (route, rank, cnt and part_mp unused); else block b takes
// tokens 32 b .. 32 b + 31 of the route launch's outputs (none past the
// route's blocks).  Block 0 writes the aux loss (and, under kOne, idx and
// gate).
template <typename W, bool kOne>
__global__ void __launch_bounds__(kThreads)
dispatch_kernel(const char* __restrict__ x, const float* __restrict__ logits,
                const float* __restrict__ u, int* __restrict__ idx,
                float* __restrict__ gate, const int* __restrict__ rank,
                const int* __restrict__ cnt, const float* __restrict__ part_mp,
                int T, int E, int C, int top_k, int random, int nb,
                long long row_bytes, int* __restrict__ slot,
                uint8_t* __restrict__ keep, float* __restrict__ aux,
                char* __restrict__ buf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [32][E] probabilities (kOne), then per (choice, expert) the counts
  // (kOne: this block's; else all blocks') and the counts of the blocks
  // before this one, the bases, and per expert the fill and the aux
  // loss's term
  float* sp = reinterpret_cast<float*>(smem_raw);
  int* tot = reinterpret_cast<int*>(sp + (kOne ? kTokPerBlock * E : 0));
  int* before = tot + top_k * E;
  int* base = before + top_k * E;
  int* fill = base + top_k * E;
  float* term = reinterpret_cast<float*>(fill + E);
  __shared__ int ent[2][kTokPerBlock];
  __shared__ int eidx[2][kTokPerBlock];
  __shared__ float egate[2][kTokPerBlock];
  __shared__ long long dst[2 * kTokPerBlock];   // an entry's buffer row, or -1
  __shared__ int srct[2 * kTokPerBlock];        // its token
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = kOne ? 0 : blockIdx.x * kTokPerBlock;
  if constexpr (kOne) {
    route_block(logits, u, 0, T, E, top_k, random, sp, ent, eidx, egate);
    for (int i = threadIdx.x; i < top_k * E; i += kThreads) {
      const int c = i / E, e = i - c * E;
      int n = 0;
      for (int j = 0; j < kTokPerBlock; ++j) n += ent[c][j] == e;
      tot[i] = n;
      before[i] = 0;
    }
  } else {
    grid_dependency_wait();
    // a warp a (choice, expert): its count over every block, and over
    // the blocks before this one
    for (int i = warp; i < top_k * E; i += kWarps) {
      const int c = i / E, e = i - c * E;
      int all = 0, earlier = 0;
      for (int b = lane; b < nb; b += 32) {
        const int n = cnt[((size_t)c * nb + b) * E + e];
        all += n;
        if (b < (int)blockIdx.x) earlier += n;
      }
      all = warp_sum_int(all);
      earlier = warp_sum_int(earlier);
      if (lane == 0) {
        tot[i] = all;
        before[i] = earlier;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < top_k * E; i += kThreads) {
    const int c = i / E, e = i - c * E;
    int b = before[i];
    for (int cc = 0; cc < c; ++cc) b += tot[cc * E + e];
    base[i] = b;
  }
  for (int e = threadIdx.x; e < E; e += kThreads) {
    int total = 0;
    for (int c = 0; c < top_k; ++c) total += tot[c * E + e];
    fill[e] = min(total, C);
  }
  __syncthreads();
  // slot and keep of the block's entries, and each one's buffer row
  const bool writer = !kOne || blockIdx.x == 0;
  for (int i = threadIdx.x; i < top_k * kTokPerBlock; i += kThreads) {
    const int c = i / kTokPerBlock, j = i - c * kTokPerBlock, t = t0 + j;
    long long d = -1;
    if (t < T) {
      const int o = c * T + t;
      int e, r;
      float g;
      if constexpr (kOne) {
        e = eidx[c][j];
        g = egate[c][j];
        r = 0;
        for (int jj = 0; jj < j; ++jj) r += ent[c][jj] == ent[c][j];
      } else {
        e = idx[o];
        g = gate[o];
        r = rank[o];
      }
      const int s = g > 0.f ? base[c * E + e] + r : -1;
      const bool k = s >= 0 && s < C;
      if (writer) {
        if constexpr (kOne) {
          idx[o] = e;
          gate[o] = g;
        }
        slot[o] = min(max(s, 0), C - 1);
        keep[o] = k;
      }
      if (k) d = (long long)e * C + s;
    }
    dst[i] = d;
    srct[i] = t;
  }
  __syncthreads();
  const long long n = row_bytes / (long long)sizeof(W);
  // kept rows: a warp an entry (kOne: over the grid's warps)
  const int w0 = kOne ? blockIdx.x * kWarps + warp : warp;
  const int ws = kOne ? gridDim.x * kWarps : kWarps;
  for (int i = w0; i < top_k * kTokPerBlock; i += ws)
    if (dst[i] >= 0)
      copy_row<W>(reinterpret_cast<const W*>(x + (long long)srct[i] * row_bytes),
                  reinterpret_cast<W*>(buf + dst[i] * row_bytes), n, lane);
  // rows past each expert's fill: zeros, the grid's warps strided
  const long long rows = (long long)E * C;
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < rows;
       r += (long long)gridDim.x * kWarps) {
    const int e = (int)(r / C), s = (int)(r - (long long)e * C);
    if (s >= fill[e]) copy_row<W>(nullptr, reinterpret_cast<W*>(buf + r * row_bytes), n, lane);
  }
  if (blockIdx.x != 0) return;
  // block 0: each expert's mean prob and first-choice fraction, summed
  // over the route's blocks in order
  for (int e = threadIdx.x; e < E; e += kThreads) {
    int first = 0;
    float s = 0.f;
    if constexpr (kOne) {
      first = tot[e];
      s += prob_sum(sp, E, e, T);
    } else {
      for (int b = 0; b < nb; ++b) {
        first += cnt[(size_t)b * E + e];
        s += part_mp[(size_t)b * E + e];
      }
    }
    term[e] = ((float)first / (float)T) * (s / (float)T);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int e = 0; e < E; ++e) s += term[e];
    *aux = (float)E * s;
  }
}

// a kernel's dynamic shared memory past the default 48 KB
template <typename K>
cudaError_t allow_smem(K* kernel, size_t smem) {
  return smem > 48 * 1024 ? cudaFuncSetAttribute(
                                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
                          : cudaSuccess;
}

template <typename W>
cudaError_t launch_dispatch(bool one, int grid, size_t smem, const void* x,
                            const float* logits, const float* u, int* idx, float* gate,
                            const int* rank, const int* cnt, const float* part_mp, int T,
                            int E, int C, int top_k, int random, int nb,
                            long long row_bytes, int* slot, uint8_t* keep, float* aux,
                            void* buf, cudaStream_t stream) {
  const char* xc = static_cast<const char*>(x);
  char* bc = static_cast<char*>(buf);
  if (one) {
    const cudaError_t e = allow_smem(dispatch_kernel<W, true>, smem);
    if (e != cudaSuccess) return e;
    dispatch_kernel<W, true><<<grid, kThreads, smem, stream>>>(
        xc, logits, u, idx, gate, rank, cnt, part_mp, T, E, C, top_k, random, nb, row_bytes,
        slot, keep, aux, bc);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dispatch_kernel<W, false>, xc, logits, u, idx, gate, rank,
                            cnt, part_mp, T, E, C, top_k, random, nb, row_bytes, slot, keep,
                            aux, bc);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// scratch (int32 words): none at T <= 32; else rank (top_k * T), counts
// (top_k * nb * E) and the fp32 probability sums (nb * E), nb = ceil(T /
// 32).  The wrapper sizes it by the same rule (ops/moe_routing.py
// `_scratch_words`).
int apex_moe_route_dispatch(const void* x, const float* logits,
                            const float* u, int* idx, float* gate, int* slot,
                            uint8_t* keep, float* aux, void* buf,
                            int* scratch, int T, int H, int E, int C, int top_k,
                            int random, int x_bytes, cudaStream_t stream) {
  if (T < 1 || H < 1 || E < 1 || C < 1 || (top_k != 1 && top_k != 2) ||
      (random && u == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool one = T <= kTokPerBlock;
  const int nb = route_blocks(T);
  int* rank = scratch;
  int* cnt = one ? nullptr : rank + top_k * T;
  float* part_mp = one ? nullptr : reinterpret_cast<float*>(cnt + top_k * nb * E);
  const size_t sp_bytes = (size_t)kTokPerBlock * E * sizeof(float);
  if (!one) {
    const cudaError_t err = allow_smem(route_kernel, sp_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    route_kernel<<<nb, kThreads, sp_bytes, stream>>>(logits, u, T, E, top_k, random, nb,
                                                     idx, gate, rank, cnt, part_mp);
    const cudaError_t e2 = cudaGetLastError();
    if (e2 != cudaSuccess) return static_cast<int>(e2);
  }
  // enough warps for a buffer row each, up to two blocks an SM (and at
  // least the route's blocks); under `one` each block routes the tokens
  const long long rows = (long long)E * C;
  const long long want = (rows + kWarps - 1) / kWarps;
  const int cap = 2 * sm_count();
  int grid = (int)(want < cap ? want : cap);
  if (!one && grid < nb) grid = nb;
  const size_t smem = (one ? sp_bytes : 0) + (3 * top_k * E + 2 * E) * sizeof(int);
  const long long row_bytes = (long long)H * x_bytes;
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(buf);
#define APEX_MOE_DISPATCH(W)                                                            \
  launch_dispatch<W>(one, grid, smem, x, logits, u, idx, gate, rank, cnt, part_mp, T, E, \
                     C, top_k, random, nb, row_bytes, slot, keep, aux, buf, stream)
  cudaError_t err;
  if (row_bytes % 16 == 0 && a % 16 == 0)
    err = APEX_MOE_DISPATCH(uint4);
  else if (row_bytes % 4 == 0 && a % 4 == 0)
    err = APEX_MOE_DISPATCH(uint32_t);
  else
    err = APEX_MOE_DISPATCH(uint16_t);
#undef APEX_MOE_DISPATCH
  return static_cast<int>(err);
}

}  // extern "C"
