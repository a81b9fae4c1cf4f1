// The attention-dropout keep masks of the flash kernels, shared by the
// forward (flash_attention.cu) and the backward (flash_attention_bwd.cu).
// Two hashes, one a template lane each (`DropMode`), so a kernel
// instantiated for one carries none of the other's code.
//
// kTileHash replaces: apex_tpu/ops/flash_attention.py `_rand_keep`
// (:1836), the counter hash the Pallas E kernels draw their keep masks from
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
// kCoordHash replaces `_rand_keep_coords` (:258), the tiling-independent
// hash of `flash_attention_partial`'s dropout (`_flash_fwd` :375 and :488,
// `_flash_bwd`'s passes): a pure function of the pair's global position,
//
//   salt = s31(seed) * 0x85EBCA6B ^ b * 0xC2B2AE35 ^ (h0 + hd) * 0x27D4EB2F
//   x    = (s31(q0) + r) * 0x01000193 + (s31(k0) + c) + salt
//
// with the same fmix32 and compare; q0 and k0 are the dropout's own
// offsets (JAX's dsalt[2:4], which the entry sets to the causal offsets)
// and h0 the global index of head 0 (JAX's head_offset).
//
// These kernels walk tiles of their own (32 rows or keys on the fp32
// pipes; 64, or 32 rows in the d = 128 dK/dV pass, on the tensor cores),
// so either hash is taken per pair from its global coordinates: a thread
// splits its own row's (or key's) part off once (`drop_row`, `drop_key`),
// each staged tile adds its part (`drop_counter`, `drop_counter_rows`),
// and a pair costs one add and fmix32's six operations and a compare.
// Under the tile hash a walked tile never straddles two W tiles: W is a
// multiple of 64 (every tile's width divides it, and tiles start at
// multiples of their width), or no smaller than either sequence (one W
// tile).  `make_drop` refuses any other W.
#pragma once

#include <stdint.h>

namespace {

// A kernel's dropout lane: none, the E kernels' tile hash, or the
// partial entry's coordinate hash.
enum DropMode : int { kNoDrop = 0, kTileHash = 1, kCoordHash = 2 };

struct Drop {
  uint32_t seed;  // s31(seed) * 0x85EBCA6B
  int w;          // kTileHash: the hash's row stride and tile width
  uint32_t thr;   // keep iff (fmix32(x) >> 8) >= thr; 0: no dropout
  float inv;      // float32(1 / (1 - rate))
  uint32_t q0, k0, h0;  // kCoordHash: s31 of the q and k offsets, head 0
};

// A thread's fixed coordinate (a query row r, or a key c) split into its
// part of the salt and of the counter.
struct DropRow {
  uint32_t salt;  // the (b, hd) salt ^ the row's (or key's) tile salt
  uint32_t off;   // (r mod W) * W for a row, c mod W for a key
};

constexpr uint32_t kSaltB = 0xC2B2AE35u, kSaltH = 0x27D4EB2Fu,
                   kSaltI = 0x165667B1u, kSaltJ = 0x9E3779B9u;
constexpr uint32_t kCoordRowStride = 0x01000193u;

// The host side of the entries: false for an argument the hash `mode`
// (kTileHash or kCoordHash) cannot take.
inline bool make_drop(int mode, int seed, int w, int thr, float inv, int q0, int k0,
                      int h0, int sq, int sk, Drop* dr) {
  dr->seed = (uint32_t)seed * 0x85EBCA6Bu;
  dr->w = w;
  dr->thr = (uint32_t)thr;
  dr->inv = inv;
  dr->q0 = (uint32_t)q0;
  dr->k0 = (uint32_t)k0;
  dr->h0 = (uint32_t)h0;
  if (thr == 0) return true;
  if (seed < 0 || thr < 0 || thr > (1 << 24)) return false;
  if (mode == kCoordHash) return q0 >= 0 && k0 >= 0 && h0 >= 0;
  return mode == kTileHash && w > 0 && (w % 64 == 0 || (w >= sq && w >= sk));
}

// the (b, hd) salt; the coordinate hash's head is global, h0 + hi
template <int kMode>
__device__ __forceinline__ uint32_t drop_head_salt(const Drop& dr, int bi, int hi) {
  const uint32_t hd = kMode == kCoordHash ? dr.h0 + (uint32_t)hi : (uint32_t)hi;
  return dr.seed ^ (uint32_t)bi * kSaltB ^ hd * kSaltH;
}

// a query row r.  Tile hash: salt with the row tile's i, counter part
// (r mod W) * W.  Coordinate hash: counter part (q0 + r) * 0x01000193 + k0.
template <int kMode>
__device__ __forceinline__ DropRow drop_row(const Drop& dr, int bi, int hi, int r) {
  if constexpr (kMode == kCoordHash) {
    return DropRow{drop_head_salt<kMode>(dr, bi, hi),
                   (dr.q0 + (uint32_t)r) * kCoordRowStride + dr.k0};
  } else {
    const int i = r / dr.w;
    return DropRow{drop_head_salt<kMode>(dr, bi, hi) ^ (uint32_t)i * kSaltI,
                   (uint32_t)(r - i * dr.w) * (uint32_t)dr.w};
  }
}

// a key c.  Tile hash: salt with the key tile's j, counter part c mod W.
// Coordinate hash: counter part k0 + c.
template <int kMode>
__device__ __forceinline__ DropRow drop_key(const Drop& dr, int bi, int hi, int c) {
  if constexpr (kMode == kCoordHash) {
    return DropRow{drop_head_salt<kMode>(dr, bi, hi), dr.k0 + (uint32_t)c};
  } else {
    const int j = c / dr.w;
    return DropRow{drop_head_salt<kMode>(dr, bi, hi) ^ (uint32_t)j * kSaltJ,
                   (uint32_t)(c - j * dr.w)};
  }
}

// the counter of the pair (row, key c0) for a staged tile of keys from c0
// (a multiple of the tile's width); key c0 + jj's is this + jj
template <int kMode>
__device__ __forceinline__ uint32_t drop_counter(const Drop& dr, DropRow row, int c0) {
  if constexpr (kMode == kCoordHash) {
    return row.off + (uint32_t)c0 + row.salt;
  } else {
    const int j = c0 / dr.w;
    return row.off + (uint32_t)(c0 - j * dr.w) + (row.salt ^ (uint32_t)j * kSaltJ);
  }
}

// the counter of the pair (row r0, key) for a staged tile of query rows
// from r0 (a multiple of the tile's width); row r0 + ii's is this + ii *
// drop_row_stride
template <int kMode>
__device__ __forceinline__ uint32_t drop_counter_rows(const Drop& dr, DropRow key,
                                                      int r0) {
  if constexpr (kMode == kCoordHash) {
    return (dr.q0 + (uint32_t)r0) * kCoordRowStride + key.off + key.salt;
  } else {
    const int i = r0 / dr.w;
    return (uint32_t)(r0 - i * dr.w) * (uint32_t)dr.w + key.off +
           (key.salt ^ (uint32_t)i * kSaltI);
  }
}

// the counter's step from one query row to the next
template <int kMode>
__device__ __forceinline__ uint32_t drop_row_stride(const Drop& dr) {
  return kMode == kCoordHash ? kCoordRowStride : (uint32_t)dr.w;
}

// murmur3's fmix32 of the counter, its top 24 bits against the threshold
__device__ __forceinline__ bool drop_keep(uint32_t x, uint32_t thr) {
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  x ^= x >> 16;
  return (x >> 8) >= thr;
}

}  // namespace
