// A CPU stand-in for the CUDA runtime the flash sources include, so that
// g++ can build them and run their kernels on host threads: one
// std::thread a CUDA thread, the blocks of a launch one after another,
// __syncthreads a block-wide barrier, warp collectives through a table
// of the warp's lanes and a warp-wide barrier.  `warp_prims.h` adds the
// warp-level matrix primitives; `tests/test_torch_flash_bwd_emulated.py`
// rewrites the sources' launches and shared declarations to use these.
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <barrier>
#include <memory>
#include <thread>
#include <type_traits>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n)
#define __restrict__

struct uint3 {
  unsigned x, y, z;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 {
  float x, y, z, w;
};
inline thread_local uint3 threadIdx;
inline uint3 blockIdx, blockDim, gridDim;

typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorMisalignedAddress = 716
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
constexpr int kEmuSharedBytes = 232448;  // an H100 block's shared memory
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
template <class F>
cudaError_t cudaFuncSetAttribute(F*, cudaFuncAttribute, int bytes) {
  return bytes <= kEmuSharedBytes ? cudaSuccess : cudaErrorInvalidValue;
}
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

// the running block's dynamic shared memory, barriers and exchange table
alignas(16) inline unsigned char emu_smem[kEmuSharedBytes];
struct EmuBlock {
  std::barrier<> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  uint64_t slot[1024][8];  // a thread's words for a collective
  int flag[1024];
  explicit EmuBlock(int threads) : bar(threads) {
    for (int w = 0; w < (threads + 31) / 32; ++w)
      warp_bar.push_back(std::make_unique<std::barrier<>>(32));
  }
};
inline EmuBlock* emu_block;

inline void __syncthreads() { emu_block->bar.arrive_and_wait(); }
inline int __syncthreads_or(int p) {
  emu_block->flag[threadIdx.x] = p != 0;
  emu_block->bar.arrive_and_wait();
  int any = 0;
  for (unsigned i = 0; i < blockDim.x; ++i) any |= emu_block->flag[i];
  emu_block->bar.arrive_and_wait();
  return any;
}
inline int emu_lane() { return threadIdx.x & 31; }
inline std::barrier<>& emu_warp_bar() { return *emu_block->warp_bar[threadIdx.x >> 5]; }
inline uint64_t* emu_slot(int lane) { return emu_block->slot[(threadIdx.x & ~31u) + lane]; }
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  memcpy(emu_slot(emu_lane()), &v, sizeof v);
  emu_warp_bar().arrive_and_wait();
  float r;
  memcpy(&r, emu_slot(emu_lane() ^ mask), sizeof r);
  emu_warp_bar().arrive_and_wait();
  return r;
}
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }

// kernel<<<grid, block, smem, stream>>>(args...), block by block
template <class K, class... A>
void emu_launch(dim3 grid, dim3 block, int, cudaStream_t, K kernel, A... args) {
  gridDim = {grid.x, grid.y, grid.z};
  blockDim = {block.x, block.y, block.z};
  for (unsigned y = 0; y < grid.y; ++y)
    for (unsigned x = 0; x < grid.x; ++x) {
      blockIdx = {x, y, 0};
      auto blk = std::make_unique<EmuBlock>(block.x);
      emu_block = blk.get();
      memset(emu_smem, 0xCD, sizeof emu_smem);  // stale shared memory
      std::vector<std::thread> threads;
      for (unsigned t = 0; t < block.x; ++t)
        threads.emplace_back([&, t] {
          threadIdx = {t, 0, 0};
          kernel(args...);
        });
      for (auto& t : threads) t.join();
    }
}

inline float __uint_as_float(unsigned u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
