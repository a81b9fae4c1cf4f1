// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: apex_tpu/ops/flash_attention.py `_flash_fwd` — both of its
// Pallas bodies, `_fwd_single_kernel` (the whole padded sequence in one
// block) and `_fwd_kernel` (the gridded online softmax) — for the
// (b, h, s, d) layout, causal or not, with the kv_mask lane of
// `_flash_attention_masked` (an optional (b, sk) fp32 key mask, a key
// attended where it is > 0); `_flash_fwd_packed` (row 7), whose q, k and v
// are three views of one packed qkv, which this kernel reads through
// strides as any other; and, through the E-layout entry, `_flash_fwd_e`
// (row 10) with its kv_mask lane
// (`_fwd_e_kernel`'s has_kvm) — and `_flash_fwd_e_blocked` (row 11), the E
// forward the JAX package streams in (512, 512) tiles once the padded
// sequence outgrows one VMEM block: this kernel walks keys in
// shared-memory tiles whatever s is, so the same launch serves it.
// The E forward's dropout lane (`_fwd_e_kernel`'s keep at :1913 and the
// blocked walk's at :2043) drops the unnormalized p of each (q, k) pair
// whose counter hash (`flash_dropout.cuh`, JAX's `_rand_keep`) falls under the
// rate, and scales the kept ones by 1 / (1 - rate); l sums the undropped
// p, as in JAX.
// It writes o in the input dtype and the fp32 per-row log-sum-exp
// (natural log) the backward will read.  A row with no attended key
// (every key masked, or under causal masking none at or before it)
// writes o = 0 and lse = -inf (the partial entry's launcher,
// `flash_attention_partial.cu`, writes JAX's finite -1e30 * scale).  Head
// dim 64 or 128.  The kernel itself is in `flash_fwd.cuh`; this file
// instantiates the lanes above.
//
// What bounds it on the H100: operations, from a few hundred tokens on.
// Attention does 4 * d operations per (q, k) pair against 4 * d * 2
// bytes per row (q, k, v, o in bf16): about s / 2 operations per byte
// without a mask and s / 4 under causal masking, against the ~295 per
// byte where the bf16 tensor cores, not memory, become the limit.  So a
// full-attention prefill is bound by operations from s ~ 600, a causal
// one from s ~ 1200; the serve's longest causal prefill (s = 1024, d =
// 64) sits just under that balance, and at its peaks the card could
// finish it in ~2.5 us either way.  Below that the launch and the
// grid's fill dominate.
//
// What the simple design does about it: one block per (b*h, 64-row q
// tile).  At d = 64 one thread owns a q row, holding it and its fp32
// output accumulator in registers (128 floats).  At d = 128 that would
// be 256 floats, past the 255-register limit, so two threads share a
// row, each owning 64 of its dims (in float4 chunks interleaved with
// its partner's, so the pair reads different shared-memory banks), and
// a score is two partial dot products joined by one warp shuffle: the
// registers a thread holds are the d = 64 kernel's.  The block walks
// k/v in 32-key tiles staged through shared memory as fp32; every row
// reads the same key at the same time, so shared memory serves
// broadcasts only, and each key costs a row 2 * d fused multiply-adds.
// The online softmax (running max m, running sum l, rescale of the
// accumulator once per tile) keeps the (s, s) score matrix out of
// device memory, exactly as the Pallas kernel does, and under causal
// masking the loop stops at the tile's last row, so k tiles wholly
// above the diagonal are never loaded.  There is no separate
// single-block body: a sequence shorter than one tile is the same loop
// run once, and a ragged last tile is masked by position.
// With a kv_mask each staged tile also stages its keys' mask values, and
// a tile whose keys are all masked (BERT's padded tails) is skipped by
// the whole block (one __syncthreads_or): padding costs no products.
// This runs on the fp32 pipes, not the tensor cores: mma/wgmma tiles and
// TMA staging are later work.
// Dropout adds no memory traffic: each (q, k) pair's keep bit is hashed
// from the pair's global coordinates (about ten integer operations beside
// the pair's 3 * d fused multiply-adds), so the kernel's 32-key tiles need
// not match JAX's (ps, ps) or (512, 512) tiles, and the backward
// regenerates the same bits.  The lane is a template parameter: the
// dropout-free instantiations carry no hash code.
#include "flash_common.cuh"
#include "flash_dropout.cuh"
#include "flash_fwd.cuh"

namespace {

// the lanes of this file's entries: kv_mask and the tile-hash dropout
template <typename T, int D, int kTPR>
struct Lanes {
  static auto pick(const FwdArgs& a) {
    if (a.kvm)
      return a.dr.thr ? flash_fwd_kernel<T, D, kTPR, true, kTileHash, false>
                      : flash_fwd_kernel<T, D, kTPR, true, kNoDrop, false>;
    return a.dr.thr ? flash_fwd_kernel<T, D, kTPR, false, kTileHash, false>
                    : flash_fwd_kernel<T, D, kTPR, false, kNoDrop, false>;
  }
};

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (b, h, sq, d), k/v (b, h, sk, d), o (b, h, sq, d) given by element
// strides over (b, h, s) with a unit stride on d; lse (b, h, sq) fp32
// contiguous; kvm null, or the (b, sk) fp32 key mask, contiguous.  dtype
// codes: 0 float32, 1 bfloat16, 2 float16.  d = 64 or 128.  Dropout
// (`flash_dropout.cuh`'s tile hash): drop_thr 0 runs none; else drop_seed
// >= 0, the hash's row stride and tile drop_w, a multiple of 32 or at
// least sq and sk, and drop_inv = float32(1 / (1 - rate)).
int apex_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, const void* kvm, int b, int h, int sq,
                             int sk, int d,
                             long long q_sb, long long q_sh, long long q_ss,
                             long long k_sb, long long k_sh, long long k_ss,
                             long long v_sb, long long v_sh, long long v_ss,
                             long long o_sb, long long o_sh, long long o_ss,
                             float scale, int causal, int drop_seed, int drop_w,
                             int drop_thr, float drop_inv, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0 || sk <= 0 || b * h > 65535)
    return cudaErrorInvalidValue;
  Drop dr;
  if (!make_drop(kTileHash, drop_seed, drop_w, drop_thr, drop_inv, 0, 0, 0, sq, sk,
                 &dr))
    return cudaErrorInvalidValue;
  const FwdArgs a{q, k, v, o, lse, static_cast<const float*>(kvm), b, h, sq, sk, d,
                  Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss},
                  Strides{v_sb, v_sh, v_ss}, Strides{o_sb, o_sh, o_ss}, scale,
                  causal, 0, -INFINITY, dr, static_cast<cudaStream_t>(stream)};
  return launch_fwd<Lanes>(a, dtype);
}

}  // extern "C"
