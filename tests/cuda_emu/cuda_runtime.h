// A CPU stand-in for the CUDA runtime the kernels' sources include, so
// that g++ can build them and run their kernels on host threads: one
// std::thread a CUDA thread, the blocks of a launch one after another (the
// blocks of a thread-block cluster together, each with its own dynamic
// shared memory, which `cooperative_groups.h`'s stand-in maps across the
// cluster), __syncthreads a block-wide barrier, warp collectives through a
// table of the warp's lanes and a warp-wide barrier.  `warp_prims.h` adds
// the warp-level matrix primitives; `emulate.py` rewrites the sources'
// launches and shared declarations to use these.  Static `__shared__`
// arrays become statics, shared by every block: a kernel that declares
// them runs correctly only outside a cluster.
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
#define __grid_constant__

struct uint3 {
  unsigned x, y, z;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
struct uint2 {
  unsigned x, y;
};
struct uint4 {
  unsigned x, y, z, w;
};
struct int4 {
  int x, y, z, w;
};
struct char4 {
  signed char x, y, z, w;
};
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
template <class T>
inline T __ldg(const T* p) {
  T v;
  memcpy(&v, p, sizeof v);
  return v;
}
inline thread_local uint3 threadIdx, blockIdx;
inline uint3 blockDim, gridDim;

typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorMisalignedAddress = 716
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaLaunchAttributeID {
  cudaLaunchAttributeClusterDimension = 4,
  cudaLaunchAttributeProgrammaticStreamSerialization = 5
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct {
    struct {
      unsigned x, y, z;
    } clusterDim;
    int programmaticStreamSerializationAllowed;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
constexpr int kEmuSharedBytes = 232448;  // an H100 block's shared memory
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
constexpr int kEmuSMs = 8;  // the stand-in card's SMs: few, so tiles chosen
                            // against the SM count switch at small shapes
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  if (a != cudaDevAttrMultiProcessorCount) return cudaErrorInvalidValue;
  *v = kEmuSMs;
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
template <class F>
cudaError_t cudaFuncSetAttribute(F*, cudaFuncAttribute, int bytes) {
  return bytes <= kEmuSharedBytes ? cudaSuccess : cudaErrorInvalidValue;
}
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

// a thread's block: its dynamic shared memory, barriers and exchange
// table; its cluster: the blocks' shared memories and a barrier over all
// their threads
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
struct EmuCluster {
  std::barrier<> bar;
  unsigned size;
  unsigned char* smem[16];
  EmuCluster(int threads, unsigned n) : bar(threads), size(n) {}
};
inline thread_local EmuBlock* emu_block;
inline thread_local unsigned char* emu_smem;
inline thread_local EmuCluster* emu_cluster;
inline thread_local unsigned emu_cluster_rank;

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
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_bar().arrive_and_wait(); }
inline uint64_t* emu_slot(int lane) { return emu_block->slot[(threadIdx.x & ~31u) + lane]; }
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int mask) {
  memcpy(emu_slot(emu_lane()), &v, sizeof v);
  emu_warp_bar().arrive_and_wait();
  T r;
  memcpy(&r, emu_slot(emu_lane() ^ mask), sizeof r);
  emu_warp_bar().arrive_and_wait();
  return r;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  memcpy(emu_slot(emu_lane()), &v, sizeof v);
  emu_warp_bar().arrive_and_wait();
  T r;
  memcpy(&r, emu_slot(src & 31), sizeof r);
  emu_warp_bar().arrive_and_wait();
  return r;
}
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }

// a launch of grid over clusters of cl blocks: the clusters one after
// another, the blocks of a cluster together
template <class K, class... A>
void emu_run(dim3 grid, dim3 block, dim3 cl, K kernel, A... args) {
  gridDim = {grid.x, grid.y, grid.z};
  blockDim = {block.x, block.y, block.z};
  const unsigned n = cl.x * cl.y * cl.z;
  std::vector<std::unique_ptr<unsigned char[]>> bufs;
  for (unsigned r = 0; r < n; ++r) bufs.emplace_back(new unsigned char[kEmuSharedBytes]);
  for (unsigned z = 0; z < grid.z; z += cl.z)
    for (unsigned y = 0; y < grid.y; y += cl.y)
      for (unsigned x = 0; x < grid.x; x += cl.x) {
        EmuCluster cluster(n * block.x, n);
        std::vector<std::unique_ptr<EmuBlock>> blocks;
        for (unsigned r = 0; r < n; ++r) {
          blocks.push_back(std::make_unique<EmuBlock>(block.x));
          memset(bufs[r].get(), 0xCD, kEmuSharedBytes);  // stale shared memory
          cluster.smem[r] = bufs[r].get();
        }
        std::vector<std::thread> threads;
        for (unsigned r = 0; r < n; ++r)
          for (unsigned t = 0; t < block.x; ++t)
            threads.emplace_back([&, r, t] {
              blockIdx = {x + r % cl.x, y + (r / cl.x) % cl.y, z + r / (cl.x * cl.y)};
              threadIdx = {t, 0, 0};
              emu_block = blocks[r].get();
              emu_smem = bufs[r].get();
              emu_cluster = &cluster;
              emu_cluster_rank = r;
              kernel(args...);
            });
        for (auto& t : threads) t.join();
      }
}

// kernel<<<grid, block, smem, stream>>>(args...)
template <class K, class... A>
void emu_launch(dim3 grid, dim3 block, int, cudaStream_t, K kernel, A... args) {
  emu_run(grid, block, dim3(1, 1, 1), kernel, args...);
}

// cudaLaunchKernelEx with its cluster dimension, if any
template <class K, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, K kernel, A... args) {
  dim3 cl(1, 1, 1);
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      const auto& c = cfg->attrs[i].val.clusterDim;
      cl = dim3(c.x, c.y, c.z);
    }
  const dim3 g = cfg->gridDim;
  if (cl.x * cl.y * cl.z > 16 || g.x % cl.x || g.y % cl.y || g.z % cl.z)
    return cudaErrorInvalidValue;
  emu_run(g, cfg->blockDim, cl, kernel, args...);
  return cudaSuccess;
}

inline float __uint_as_float(unsigned u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  memcpy(&u, &f, 4);
  return u;
}
// byte n of the result: byte (s >> 4n) & 7 of y:x (x the low four)
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long v = (unsigned long long)y << 32 | x;
  unsigned r = 0;
  for (int n = 0; n < 4; ++n) r |= (unsigned)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xff) << (8 * n);
  return r;
}

// the round-to-nearest fp32 operations, each one IEEE operation: the
// result passes through a volatile, so the host compiler can contract
// none of them into a fused multiply-add
inline float __fadd_rn(float a, float b) {
  volatile float r = a + b;
  return r;
}
inline float __fsub_rn(float a, float b) {
  volatile float r = a - b;
  return r;
}
inline float __fmul_rn(float a, float b) {
  volatile float r = a * b;
  return r;
}
inline float __fdiv_rn(float a, float b) {
  volatile float r = a / b;
  return r;
}
inline float __fsqrt_rn(float a) {
  volatile float r = sqrtf(a);
  return r;
}
