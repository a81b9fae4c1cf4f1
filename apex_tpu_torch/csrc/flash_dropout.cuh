// The attention-dropout keep mask of the E flash kernels, shared by the
// forward (flash_attention.cu) and the backward (flash_attention_bwd.cu).
//
// Replaces: apex_tpu/ops/flash_attention.py `_rand_keep` (:1836), the
// counter hash the Pallas E kernels draw their keep masks from
// (`_fwd_e_kernel` :1913, `_bwd_e_kernel` :2191, the blocked walk's
// :2043, :2336 and :2374) and the 4-D form of
// `_fallback_dropout_attention` (:2696).  JAX hashes one (W, W) tile of
// each (batch b, head hd) at a time: for the pair (r, c) of tile (i, j),
//
//   salt = s31(seed) * 0x85EBCA6B ^ b * 0xC2B2AE35 ^ hd * 0x27D4EB2F
//          ^ i * 0x165667B1 ^ j * 0x9E3779B9
//   x    = (r mod W) * W + (c mod W) + salt,   then murmur3's fmix32
//   keep = (x >> 8) * 2^-24 >= float32(rate)
//
// in uint32 arithmetic, with i = r / W, j = c / W.  W is the 128-padded
// sequence on the single-block route (i = j = 0), 512 on the blocked walk
// and s itself on the fallback (i = j = 0): the wrapper picks it by JAX's
// `_e_mode`.  The compare is done exactly in integers, (x >> 8) >= thr with
// thr = ceil(float32(rate) * 2^24) (>= 1 for any rate > 0).
//
// These kernels walk 32-row and 32-key tiles of their own, so the hash is
// taken per pair from its global coordinates: a thread splits its own
// row's (or key's) part off once (`drop_row`), each staged tile adds its
// part (`drop_counter`), and a pair costs one add and fmix32's six
// operations and a compare.  A 32-wide tile never straddles two W tiles:
// W is a multiple of 32, or no smaller than the sequence.
#pragma once

#include <stdint.h>

namespace {

struct Drop {
  uint32_t seed;  // s31(seed) * 0x85EBCA6B
  int w;          // the hash's row stride and tile width
  uint32_t thr;   // keep iff (fmix32(x) >> 8) >= thr; 0: no dropout
  float inv;      // float32(1 / (1 - rate))
};

// A thread's fixed coordinate (a query row r, or a key c) split into its
// part of the salt and of the counter.
struct DropRow {
  uint32_t salt;  // the (b, hd) salt ^ the row's (or key's) tile salt
  uint32_t off;   // (r mod W) * W for a row, c mod W for a key
};

constexpr uint32_t kSaltB = 0xC2B2AE35u, kSaltH = 0x27D4EB2Fu,
                   kSaltI = 0x165667B1u, kSaltJ = 0x9E3779B9u;

// The host side of the entries: false for an argument the lane cannot take.
inline bool make_drop(int seed, int w, int thr, float inv, int sq, int sk, Drop* dr) {
  dr->seed = (uint32_t)seed * 0x85EBCA6Bu;
  dr->w = w;
  dr->thr = (uint32_t)thr;
  dr->inv = inv;
  if (thr == 0) return true;
  return seed >= 0 && thr > 0 && thr <= (1 << 24) && w > 0 &&
         (w % 32 == 0 || (w >= sq && w >= sk));
}

__device__ __forceinline__ uint32_t drop_head_salt(const Drop& dr, int bi, int hi) {
  return dr.seed ^ (uint32_t)bi * kSaltB ^ (uint32_t)hi * kSaltH;
}

// a query row r: salt with the row tile's i, counter part (r mod W) * W
__device__ __forceinline__ DropRow drop_row(const Drop& dr, int bi, int hi, int r) {
  const int i = r / dr.w;
  return DropRow{drop_head_salt(dr, bi, hi) ^ (uint32_t)i * kSaltI,
                 (uint32_t)(r - i * dr.w) * (uint32_t)dr.w};
}

// a key c: salt with the key tile's j, counter part c mod W
__device__ __forceinline__ DropRow drop_key(const Drop& dr, int bi, int hi, int c) {
  const int j = c / dr.w;
  return DropRow{drop_head_salt(dr, bi, hi) ^ (uint32_t)j * kSaltJ,
                 (uint32_t)(c - j * dr.w)};
}

// the counter of the pair (row, key c0) for a staged tile of keys from c0
// (a multiple of 32); key c0 + jj's is this + jj
__device__ __forceinline__ uint32_t drop_counter(const Drop& dr, DropRow row, int c0) {
  const int j = c0 / dr.w;
  return row.off + (uint32_t)(c0 - j * dr.w) + (row.salt ^ (uint32_t)j * kSaltJ);
}

// the counter of the pair (row r0, key) for a staged tile of query rows
// from r0 (a multiple of 32); row r0 + ii's is this + ii * W
__device__ __forceinline__ uint32_t drop_counter_rows(const Drop& dr, DropRow key,
                                                      int r0) {
  const int i = r0 / dr.w;
  return (uint32_t)(r0 - i * dr.w) * (uint32_t)dr.w + key.off +
         (key.salt ^ (uint32_t)i * kSaltI);
}

// murmur3's fmix32 of the counter, its top 24 bits against the threshold
__device__ __forceinline__ bool drop_keep(uint32_t x, uint32_t thr) {
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  x ^= x >> 16;
  return (x >> 8) >= thr;
}

}  // namespace
