// The warp-level primitives of `apex_tpu_torch/csrc/flash_mma.cuh`
// (ldmatrix, cp.async, mma.sync.m16n8k16), the split cluster barrier of
// `quant_matmul.cu` (barrier.cluster.arrive / wait) and the programmatic
// launch controls of `moe_routing.cu` (griddepcontrol), emulated on host
// threads, the matrix ones with the PTX ISA's fragment layouts: a lane's
// groupID g = lane / 4 and t = lane % 4; A (16 x 16, row) a0 (g,
// 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..); B
// (16 x 8, col) b0 (2t..2t+1, g), b1 (2t + 8.., g); C c0, c1 (g,
// 2t..2t+1), c2, c3 (g + 8, 2t..).
// The lower-addressed element of a pair sits in a register's low half.
#pragma once
#include <optional>

#include "cuda_bf16.h"
#include "cuda_fp16.h"
#include "cuda_runtime.h"

inline uint16_t emu_ld16(const void* p, int i) {
  uint16_t v;
  memcpy(&v, static_cast<const char*>(p) + 2 * i, 2);
  return v;
}

// ldmatrix .x4: lanes 8 m .. 8 m + 7 give matrix m's row addresses; lane
// l receives row l / 4, elements 2 (l % 4) and + 1 of each matrix, or
// with .trans the column l / 4 of rows 2 (l % 4) and + 1
inline void emu_ldmatrix(uint32_t (&r)[4], const void* p, bool trans) {
  const int l = emu_lane();
  emu_slot(l)[0] = (uint64_t)(uintptr_t)p;
  emu_warp_bar().arrive_and_wait();
  auto row = [](int lane) { return (const void*)(uintptr_t)emu_slot(lane)[0]; };
  for (int m = 0; m < 4; ++m) {
    uint16_t lo, hi;
    if (trans) {
      lo = emu_ld16(row(8 * m + 2 * (l & 3)), l >> 2);
      hi = emu_ld16(row(8 * m + 2 * (l & 3) + 1), l >> 2);
    } else {
      lo = emu_ld16(row(8 * m + (l >> 2)), 2 * (l & 3));
      hi = emu_ld16(row(8 * m + (l >> 2)), 2 * (l & 3) + 1);
    }
    r[m] = (uint32_t)lo | ((uint32_t)hi << 16);
  }
  emu_warp_bar().arrive_and_wait();
}
inline void ldsm_x4(uint32_t (&r)[4], const void* p) { emu_ldmatrix(r, p, false); }
inline void ldsm_x4_t(uint32_t (&r)[4], const void* p) { emu_ldmatrix(r, p, true); }

// cp.async completes at once here; src_bytes 0 writes zeros
inline void cp_async16(void* dst, const void* src, int src_bytes) {
  memset(dst, 0, 16);
  memcpy(dst, src, src_bytes);
}
inline void cp_async4(void* dst, const void* src, int src_bytes) {
  memset(dst, 0, 4);
  memcpy(dst, src, src_bytes);
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}

template <typename T>
inline float emu_to_f(uint16_t v) {
  if constexpr (std::is_same<T, __half>::value) return __half2float(__half{v});
  else return __bfloat162float(__nv_bfloat16{v});
}

// c += a b on the warp's fragments, fp32 sums in k order
template <typename T>
inline void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const int l = emu_lane();
  uint64_t* s = emu_slot(l);
  for (int i = 0; i < 4; ++i) s[i] = a[i];
  s[4] = b0;
  s[5] = b1;
  emu_warp_bar().arrive_and_wait();
  float A[16][16], B[16][8];
  for (int ln = 0; ln < 32; ++ln) {
    const uint64_t* o = emu_slot(ln);
    const int g = ln >> 2, t = ln & 3;
    auto lo = [](uint64_t v) { return emu_to_f<T>((uint16_t)(v & 0xffff)); };
    auto hi = [](uint64_t v) { return emu_to_f<T>((uint16_t)(v >> 16)); };
    for (int i = 0; i < 4; ++i) {
      const int r = g + 8 * (i & 1), k = 2 * t + 8 * (i >> 1);
      A[r][k] = lo(o[i]);
      A[r][k + 1] = hi(o[i]);
    }
    for (int i = 0; i < 2; ++i) {
      B[2 * t + 8 * i][g] = lo(o[4 + i]);
      B[2 * t + 8 * i + 1][g] = hi(o[4 + i]);
    }
  }
  emu_warp_bar().arrive_and_wait();
  const int g = l >> 2, t = l & 3;
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), n = 2 * t + (e & 1);
    float acc = c[e];
    for (int k = 0; k < 16; ++k) acc += A[r][k] * B[k][n];
    c[e] = acc;
  }
}

// barrier.cluster.arrive (.relaxed or not) and barrier.cluster.wait: the
// cluster's barrier in two halves, the thread's arrival kept until its
// wait (the host's barrier orders memory either way)
inline thread_local std::optional<std::barrier<>::arrival_token> emu_cluster_arrival;
inline void cluster_arrive_relaxed() { emu_cluster_arrival.emplace(emu_cluster->bar.arrive()); }
inline void cluster_arrive() { cluster_arrive_relaxed(); }
inline void cluster_wait() {
  emu_cluster->bar.wait(std::move(*emu_cluster_arrival));
  emu_cluster_arrival.reset();
}

// griddepcontrol.wait / .launch_dependents (programmatic dependent
// launch): the stand-in runs launches one after another, so a dependent
// launch starts after its primary has ended, and both are no-ops
inline void grid_dependency_wait() {}
inline void launch_dependents() {}
