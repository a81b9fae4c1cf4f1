// The tensor-core building blocks of the flash kernels for Hopper (sm_90a):
// the bf16 / fp16 forward (`mma_fwd_kernel`, `flash_fwd.cuh`) and the dK/dV
// and dQ passes of the backward (`flash_bwd.cuh`) share them.
//
// A block is 4 warps over 64 rows of its own (keys in dK/dV, queries in
// dQ), 16 a warp, kept in shared memory as they came (bf16 or fp16) and
// read as `mma.sync.m16n8k16` A fragments by `ldmatrix`.  The walked
// operands come in by `cp.async`, 16 bytes a thread, into two stages, so
// that tile t + 1 loads while tile t computes.  Every shared row is padded
// by 8 elements (16 bytes), so the 8 rows one `ldmatrix` reads start in 8
// different bank groups.  A score accumulator's element e of n-tile nt
// sits at row g + 8 (e >> 1) and column 8 nt + 2 t4 + (e & 1) of the
// warp's 16-row slice (g = lane / 4, t4 = lane % 4): `frag_col` names it,
// every lane's predicate is taken there, and two n-tiles of it pack (as a
// hi + lo pair, `a_frags_n`) into the A operands of the next product with
// no trip through shared memory.
#pragma once

#include <type_traits>

#include "flash_common.cuh"

namespace {

constexpr int kMmaThreads = 128;  // 4 warps of 16 rows
constexpr int kMmaRows = kMmaThreads / 32 * 16;  // a block's own rows

// shared row pitch, in elements: D plus 16 bytes
template <int D> __host__ __device__ constexpr int pitch() { return D + 8; }

// column of a score fragment's element e in n-tile nt (t4 = lane % 4)
__device__ __forceinline__ int frag_col(int nt, int t4, int e) {
  return 8 * nt + 2 * t4 + (e & 1);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; .trans delivers each transposed
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// cp.async of 16 (or 4) bytes; a src_bytes of 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a b: m16n8k16, T operands, fp32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two fp32 values rounded (to nearest even) to T, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// a T pair's two values, unpacked in registers (lo from the low half)
template <typename T>
__device__ __forceinline__ void unpack2(uint32_t v, float& lo, float& hi) {
  if constexpr (std::is_same<T, __half>::value) {
    lo = __half2float(__ushort_as_half((unsigned short)(v & 0xffffu)));
    hi = __half2float(__ushort_as_half((unsigned short)(v >> 16)));
  } else {
    lo = __uint_as_float(v << 16);
    hi = __uint_as_float(v & 0xffff0000u);
  }
}

// fp32 a and b as N T pairs: t[0] the rounded values, each next term the
// rounded remainder past the terms before it (each remainder exact in
// fp32).  Two terms (hi + lo) carry 16 of an fp32 significand's 24 bits
// in bf16 (22 in fp16): a product fed both reads P or dS to 2^-16
template <typename T, int N>
__device__ __forceinline__ void split_n(float a, float b, uint32_t (&t)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    t[i] = pack2<T>(a, b);
    float ha, hb;
    unpack2<T>(t[i], ha, hb);
    a -= ha;
    b -= hb;
  }
}

// the N-term A fragments of k-step kq from score n-tiles 2 kq, 2 kq + 1
template <typename T, int N, int NT>
__device__ __forceinline__ void a_frags_n(uint32_t (&f)[N][4], const float (&c)[NT][4],
                                          int kq) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t t[N];
    split_n<T, N>(c[2 * kq + (r >> 1)][2 * (r & 1)], c[2 * kq + (r >> 1)][2 * (r & 1) + 1],
                  t);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i][r] = t[i];
  }
}

// rows [r0, r0 + kRows) of a strided (s, D) operand into a [kRows][pitch]
// shared tile by cp.async; rows past s are zeros
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long stride, int r0,
                                          int s) {
  constexpr int kChunks = D * (int)sizeof(T) / 16;  // 16-byte chunks a row
  constexpr int kPer = 16 / (int)sizeof(T);
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kMmaThreads) {
    const int rr = idx / kChunks;
    const int c = idx - rr * kChunks;
    const int r = r0 + rr;
    const bool ok = r < s;
    cp_async16(dst + rr * pitch<D>() + c * kPer, src + (ok ? r : 0) * stride + c * kPer,
               ok ? 16 : 0);
  }
}

// S (16 x kN, fp32) = A B^T and dP = A2 B2^T for the warp's 16 rows:
// A, A2 the block's own [64][pitch] tiles (the warp's rows from `row0`),
// B, B2 a walked [kN][pitch] stage; the reduction runs over D
template <typename T, int D, int kN>
__device__ __forceinline__ void scores(float (&s)[kN / 8][4], float (&dp)[kN / 8][4],
                                       const T* a, const T* a2, const T* b, const T* b2,
                                       int row0, int lane) {
  constexpr int P = pitch<D>();
#pragma unroll
  for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4], a2f[4];
    const int ao = (row0 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8;
    ldsm_x4(af, a + ao);
    ldsm_x4(a2f, a2 + ao);
#pragma unroll
    for (int nb = 0; nb < kN / 16; ++nb) {
      uint32_t bf[4], b2f[4];
      const int bo = (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + kk * 16 +
                     ((lane >> 3) & 1) * 8;
      ldsm_x4(bf, b + bo);
      ldsm_x4(b2f, b2 + bo);
      mma16816<T>(s[2 * nb], af, bf[0], bf[1]);
      mma16816<T>(s[2 * nb + 1], af, bf[2], bf[3]);
      mma16816<T>(dp[2 * nb], a2f, b2f[0], b2f[1]);
      mma16816<T>(dp[2 * nb + 1], a2f, b2f[2], b2f[3]);
    }
  }
}

// S (16 x kN, fp32) = A B^T alone: the forward's one product
template <typename T, int D, int kN>
__device__ __forceinline__ void scores(float (&s)[kN / 8][4], const T* a, const T* b,
                                       int row0, int lane) {
  constexpr int P = pitch<D>();
#pragma unroll
  for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (row0 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nb = 0; nb < kN / 16; ++nb) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      mma16816<T>(s[2 * nb], af, bf[0], bf[1]);
      mma16816<T>(s[2 * nb + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x D, fp32) += (hi + lo) B for k-step kq of a split A operand:
// B the walked [kN][pitch] stage, whose rows are the reduction dim; each
// B fragment feeds both terms
template <typename T, int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const uint32_t (&hi)[4],
                                           const uint32_t (&lo)[4], const T* b, int kq,
                                           int lane) {
  constexpr int P = pitch<D>();
#pragma unroll
  for (int nd = 0; nd < D / 16; ++nd) {
    uint32_t bf[4];
    ldsm_x4_t(bf, b + (kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + nd * 16 +
                      (lane >> 4) * 8);
    mma16816<T>(acc[2 * nd], hi, bf[0], bf[1]);
    mma16816<T>(acc[2 * nd], lo, bf[0], bf[1]);
    mma16816<T>(acc[2 * nd + 1], hi, bf[2], bf[3]);
    mma16816<T>(acc[2 * nd + 1], lo, bf[2], bf[3]);
  }
}

// acc (16 x D, fp32) = acc * corr + (the sum of f's N terms) B over the
// kK k-steps of a walked [16 kK][pitch] stage B: the tile's product is
// summed from zero on the tensor cores, 16 output columns at a time, and
// added to acc by one fused multiply-add, rounded to nearest.  The tensor
// cores' fp32 sums truncate toward zero: carried across a whole walk they
// shrank o by 1.1e-6 of |o| against the plain version on an H100 (causal,
// (8, 16, 1024, 64), unit-normal inputs), tile by tile by 2.4e-7; the fp32
// pipes' kernel's o sat 1.6e-8 from it (`chip_smoke.py --phases numerics`).
// corr[hh] rescales the thread's row hh (its elements 2 hh, 2 hh + 1).
template <typename T, int D, int N, int kK>
__device__ __forceinline__ void accumulate_tile(float (&acc)[D / 8][4], const float (&corr)[2],
                                                const uint32_t (&f)[kK][N][4], const T* b,
                                                int lane) {
  constexpr int P = pitch<D>();
#pragma unroll
  for (int nd = 0; nd < D / 16; ++nd) {
    float part[2][4] = {};
#pragma unroll
    for (int kq = 0; kq < kK; ++kq) {
      uint32_t bf[4];
      ldsm_x4_t(bf, b + (kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + nd * 16 +
                        (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < N; ++i) mma16816<T>(part[0], f[kq][i], bf[0], bf[1]);
#pragma unroll
      for (int i = 0; i < N; ++i) mma16816<T>(part[1], f[kq][i], bf[2], bf[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * nd][e] = fmaf(acc[2 * nd][e], corr[e >> 1], part[0][e]);
      acc[2 * nd + 1][e] = fmaf(acc[2 * nd + 1][e], corr[e >> 1], part[1][e]);
    }
  }
}

// a warp's 16 x D accumulator, rounded once to T, to rows `rows` (the
// thread's two) of a strided (s, D) output; rows past s are not written
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, long long stride, const float (&acc)[D / 8][4],
                                           const int (&rows)[2], int s, int t4) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (rows[hh] >= s) continue;
    T* row = base + rows[hh] * stride;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(row + 8 * nt + 2 * t4) =
          pack2<T>(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
  }
}


// Whether every (b, h, s) row of a strided view of T starts n-byte
// aligned: 16 for the operands cp.async stages, 4 for the outputs
// `store_rows` writes in pairs
template <typename T>
bool rows_aligned(const void* p, Strides s, long long n) {
  const long long e = n / (long long)sizeof(T);
  return reinterpret_cast<uintptr_t>(p) % n == 0 && s.b % e == 0 && s.h % e == 0 &&
         s.s % e == 0;
}

}  // namespace
