// The thread-block cluster of `cooperative_groups` for the CPU stand-in of
// `cuda_runtime.h`: the cluster's blocks run together there, each with its
// own dynamic shared memory, which map_shared_rank maps by offset.
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {

struct cluster_group {
  void sync() const { emu_cluster->bar.arrive_and_wait(); }
  unsigned block_rank() const { return emu_cluster_rank; }
  unsigned num_blocks() const { return emu_cluster->size; }
  // p in this block's dynamic shared memory -> the same offset in block
  // `rank`'s (a static array, shared by every block here, maps to itself)
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {
    const auto off = reinterpret_cast<const unsigned char*>(p) - emu_smem;
    if (off < 0 || off >= kEmuSharedBytes) return p;
    return reinterpret_cast<T*>(emu_cluster->smem[rank] + off);
  }
};

inline cluster_group this_cluster() { return {}; }

}  // namespace cooperative_groups
