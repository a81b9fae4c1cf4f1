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
// What bounds it on the H100: bytes.  The logits and x's kept rows are
// read once and the (E, C, H) buffer written once; at bench.py's
// bench_moe_ep shape (T 4096, H 256, E 8, C 640, fp32) that is ~9.6 MB,
// ~2.9 us at 3.35 TB/s.  The arithmetic (a softmax over E per token) is
// negligible.
//
// The TPU kernel is one program over the whole VMEM-resident problem: a
// cumsum over a (k*T, E) one-hot and a serial row loop.  Here the work is
// spread over the card in three launches on the caller's stream:
//   1. route: one warp per token (a block of 8 warps takes 32 tokens): the
//      softmax and top-k in registers and shuffles; per block, each valid
//      entry's rank among the block's earlier entries of the same choice
//      and expert, the per-(choice, expert) counts, and the per-expert sum
//      of the block's probabilities (in a fixed order: the result does not
//      depend on scheduling);
//   2. slot: each block sums the counts of the choices and blocks before
//      it (choice-major order) into its per-expert base, so a slot is that
//      base plus the in-block rank; it writes slot and keep and, for every
//      kept entry, the token that fills (expert, slot).  Block 0 also sums
//      the per-block totals into the fill of each expert, the mean probs
//      and the aux loss;
//   3. copy: one warp per buffer row: a kept row copies its token's row of
//      x in 16-byte vectors (4- or 2-byte words when the row is not 16-byte
//      sized or aligned), a row past its expert's fill is written with
//      zeros, so the buffer is written exactly once and never memset.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTokPerBlock = 32;
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

// Launch 1.  ent[c][j]: the expert of the block's j-th token's choice c,
// or -1 where it claims no slot (gate 0, or past T).
__global__ void __launch_bounds__(kThreads)
route_kernel(const float* __restrict__ logits, const float* __restrict__ u,
             int T, int E, int top_k, int random, int nb,
             int* __restrict__ idx, float* __restrict__ gate,
             int* __restrict__ rank, int* __restrict__ cnt,
             float* __restrict__ part_mp) {
  extern __shared__ float sh_mp[];                // [kWarps][E]
  __shared__ int ent[2][kTokPerBlock];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * kTokPerBlock;
  for (int i = threadIdx.x; i < kWarps * E; i += kThreads) sh_mp[i] = 0.f;
  __syncthreads();
  float* my_mp = sh_mp + warp * E;
  for (int j = warp; j < kTokPerBlock; j += kWarps) {
    const int t = t0 + j;
    int e1 = -1, e2 = -1;
    if (t < T) {
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
      int i1 = 0x7fffffff;
      for (int e = lane; e < E; e += 32) {
        const float p = expf(row[e] - m) / s;
        my_mp[e] += p;                    // lanes own distinct experts
        if (p > b1) { b1 = p; i1 = e; }
      }
      warp_argmax(b1, i1);
      float g1 = b1, g2 = 0.f;
      int i2 = 0;
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
      if (lane == 0) {
        idx[t] = i1;
        gate[t] = g1;
        if (top_k == 2) {
          idx[T + t] = i2;
          gate[T + t] = g2;
        }
      }
      e1 = g1 > 0.f ? i1 : -1;
      e2 = g2 > 0.f ? i2 : -1;
    }
    if (lane == 0) {
      ent[0][j] = e1;
      ent[1][j] = e2;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < top_k * kTokPerBlock; i += kThreads) {
    const int c = i / kTokPerBlock, j = i - c * kTokPerBlock;
    const int e = ent[c][j];
    if (t0 + j >= T) continue;
    int r = 0;
    for (int jj = 0; jj < j; ++jj) r += ent[c][jj] == e;
    rank[c * T + t0 + j] = r;
  }
  for (int i = threadIdx.x; i < top_k * E; i += kThreads) {
    const int c = i / E, e = i - c * E;
    int n = 0;
    for (int j = 0; j < kTokPerBlock; ++j) n += ent[c][j] == e;
    cnt[((size_t)c * nb + blockIdx.x) * E + e] = n;
  }
  for (int e = threadIdx.x; e < E; e += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += sh_mp[w * E + e];
    part_mp[(size_t)blockIdx.x * E + e] = s;
  }
}

// Launch 2.
__global__ void __launch_bounds__(kThreads)
slot_kernel(const int* __restrict__ idx, const float* __restrict__ gate,
            const int* __restrict__ rank, const int* __restrict__ cnt,
            const float* __restrict__ part_mp, int T, int E, int C,
            int top_k, int nb, int* __restrict__ slot,
            uint8_t* __restrict__ keep, int* __restrict__ src,
            int* __restrict__ fill, float* __restrict__ aux) {
  extern __shared__ int sh_base[];                // [top_k][E], then [E]
  const int t0 = blockIdx.x * kTokPerBlock;
  for (int i = threadIdx.x; i < top_k * E; i += kThreads) {
    const int c = i / E, e = i - c * E;
    int base = 0;
    for (int cc = 0; cc < c; ++cc)
      for (int b = 0; b < nb; ++b) base += cnt[((size_t)cc * nb + b) * E + e];
    for (int b = 0; b < (int)blockIdx.x; ++b)
      base += cnt[((size_t)c * nb + b) * E + e];
    sh_base[i] = base;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < top_k * kTokPerBlock; i += kThreads) {
    const int c = i / kTokPerBlock, t = t0 + i - c * kTokPerBlock;
    if (t >= T) continue;
    const int o = c * T + t;
    const int e = idx[o];
    const int s = gate[o] > 0.f ? sh_base[c * E + e] + rank[o] : -1;
    const bool k = s >= 0 && s < C;
    slot[o] = min(max(s, 0), C - 1);
    keep[o] = k;
    if (k) src[(size_t)e * C + s] = t;
  }
  if (blockIdx.x != 0) return;
  // block 0: each expert's fill, mean prob and first-choice fraction
  float* term = reinterpret_cast<float*>(sh_base + top_k * E);
  for (int e = threadIdx.x; e < E; e += kThreads) {
    int total = 0, first = 0;
    for (int c = 0; c < top_k; ++c)
      for (int b = 0; b < nb; ++b) {
        const int n = cnt[((size_t)c * nb + b) * E + e];
        total += n;
        if (c == 0) first += n;
      }
    fill[e] = min(total, C);
    float s = 0.f;
    for (int b = 0; b < nb; ++b) s += part_mp[(size_t)b * E + e];
    term[e] = ((float)first / (float)T) * (s / (float)T);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int e = 0; e < E; ++e) s += term[e];
    *aux = (float)E * s;
  }
}

// Launch 3: one warp per (expert, slot) row, `W` the word a lane moves
template <typename W>
__global__ void __launch_bounds__(kThreads)
copy_kernel(const char* __restrict__ x, const int* __restrict__ src,
            const int* __restrict__ fill, int E, int C, long long row_bytes,
            char* __restrict__ buf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long rows = (long long)E * C;
  const long long n = row_bytes / (long long)sizeof(W);
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < rows;
       r += (long long)gridDim.x * kWarps) {
    const int e = (int)(r / C), s = (int)(r - (long long)e * C);
    W* out = reinterpret_cast<W*>(buf + r * row_bytes);
    if (s < fill[e]) {
      const W* in = reinterpret_cast<const W*>(x + (long long)src[r] * row_bytes);
      for (long long i = lane; i < n; i += 32) out[i] = in[i];
    } else {
      for (long long i = lane; i < n; i += 32) out[i] = W{};
    }
  }
}

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// int32 scratch: rank (top_k*T), counts (top_k*nb*E), src (E*C), fill (E)
int apex_moe_route_scratch_ints(int T, int E, int C, int top_k) {
  return top_k * T + top_k * route_blocks(T) * E + E * C + E;
}

// fp32 scratch: the per-block mean-prob partials (nb*E)
int apex_moe_route_scratch_floats(int T, int E) {
  return route_blocks(T) * E;
}

int apex_moe_route_dispatch(const void* x, const float* logits,
                            const float* u, int* idx, float* gate, int* slot,
                            uint8_t* keep, float* aux, void* buf,
                            int* scratch_i, float* scratch_f, int T, int H,
                            int E, int C, int top_k, int random,
                            int x_bytes, cudaStream_t stream) {
  if (T < 1 || H < 1 || E < 1 || C < 1 || (top_k != 1 && top_k != 2) ||
      (random && u == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = route_blocks(T);
  int* rank = scratch_i;
  int* cnt = rank + top_k * T;
  int* src = cnt + top_k * nb * E;
  int* fill = src + E * C;
  route_kernel<<<nb, kThreads, kWarps * E * sizeof(float), stream>>>(
      logits, u, T, E, top_k, random, nb, idx, gate, rank, cnt, scratch_f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  slot_kernel<<<nb, kThreads, (top_k * E) * sizeof(int) + E * sizeof(float),
                stream>>>(idx, gate, rank, cnt, scratch_f, T, E, C, top_k, nb,
                          slot, keep, src, fill, aux);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long row_bytes = (long long)H * x_bytes;
  const long long rows = (long long)E * C;
  const int grid = (int)((rows + kWarps - 1) / kWarps < 65535
                             ? (rows + kWarps - 1) / kWarps : 65535);
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(buf);
  const char* xc = static_cast<const char*>(x);
  char* bc = static_cast<char*>(buf);
  if (row_bytes % 16 == 0 && a % 16 == 0)
    copy_kernel<uint4><<<grid, kThreads, 0, stream>>>(xc, src, fill, E, C,
                                                      row_bytes, bc);
  else if (row_bytes % 4 == 0 && a % 4 == 0)
    copy_kernel<uint32_t><<<grid, kThreads, 0, stream>>>(xc, src, fill, E, C,
                                                         row_bytes, bc);
  else
    copy_kernel<uint16_t><<<grid, kThreads, 0, stream>>>(xc, src, fill, E, C,
                                                         row_bytes, bc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
