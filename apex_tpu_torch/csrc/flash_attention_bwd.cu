// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces: apex_tpu/ops/flash_attention.py `_flash_bwd` (row 8: the
// (b, h, sq, d) / (b, h, sk, d) backward of `flash_attention`, Pallas
// bodies `_bwd_dq_kernel`, `_bwd_dkv_kernel` and the fused one-pass
// `_bwd_fused_kernel`, with the kv_mask of `_flash_attention_masked`; the
// partial entry's lanes, `flash_attention_partial.cu`, launch the same
// passes), `_flash_bwd_packed` (row 9:
// the same backward over three views of one packed qkv, writing three
// views of one dqkv), `_flash_bwd_e` (row 12, body `_bwd_e_kernel`)
// and `_flash_bwd_e_blocked` (row 13, the same backward the JAX package
// streams in (512, 512) tiles once the padded sequence outgrows one VMEM
// block: the passes below walk shared-memory tiles whatever s is).
// Every operand is a strided (b, h, s, d) view, so one entry serves both
// layouts: q/k/v and dq/dk/dv may be separate (b, h, s, d) tensors, or
// the heads' [q|k|v] lanes of the E layout's qkv (b, s, h, 3d) and of one
// dqkv buffer, written in place, never as three tensors then
// concatenated.  Causal (key j visible to query i iff j <= i, both
// counted from 0: top-left aligned when sq != sk) or full, with the
// kv_mask lane (`_bwd_e_kernel`'s has_kvm): an optional (b, sk) fp32 key
// mask, a key attended where it is > 0.  Head dim 64 or 128.  The E
// backward's dropout lane (`_bwd_e_kernel`'s keep at :2191, the blocked
// walk's at :2336 and :2374) regenerates the forward's keep mask from the
// same counter hash (`flash_dropout.cuh`): dv reads the dropped, rescaled
// p and dp = (do v^T) keep / (1 - rate), so ds = p (dp - delta) with delta
// from the dropped o.
//
// Math, per (b, h): p = exp(scale * q k^T - lse) recomputed from the
// forward's natural-log lse (so no (sq, sk) matrix is ever stored),
// delta_i = sum_d do_i * o_i, ds = p * (do v^T - delta), and
// dq = scale * ds k, dk = scale * ds^T q, dv = p^T do, all in fp32, cast
// once to the operands' dtype.  `scale` is used as given, in fp32: the
// JAX backward folds it into v after rounding it to v's dtype, which at
// d = 128 in bf16 (1/sqrt(128) -> 0.08837890625) moves dq and dk by
// 1.07e-4 relative; the port keeps the scale its forward used.  A masked
// (q, k) pair takes p = 0 by a select made before the exponential is
// read: a row that attends nothing has lse = -inf from the forward (or
// the partial's -1e30 * scale), where exp(s - lse) would be inf or wrong.
// The lse cotangent of the partial entry (dlse: d loss / d lse) adds
// dlse_i * scale * p_ij to each score's gradient, since d lse_i / d s_ij
// = scale * p_ij: the delta pass folds it in as delta_i - dlse_i, as
// JAX's `_flash_bwd` does (:1040-1044), and nothing else changes.
//
// What bounds it on the H100: operations.  It does 10 * d operations per
// (q, k) pair (recomputed scores, do v^T, and the three products) against
// about 16 * d bytes per row moved in bf16 (q, k, v, o, do read, dq, dk,
// dv written): at s = 1024 causal that is ~43 GFLOP against ~134 MB for
// b = 8, h = 16, d = 64, so the bf16 tensor cores would be the limit
// (~44 us); at s = 16384 it is 2.7 TFLOP for h = 16, d = 128.
//
// What the simple design does about it (correct first, not fast): three
// passes, every one deterministic (no atomics, every output element
// written by exactly one thread).
//  1. delta: one warp per (b, h, query row) reduces do . o (less the lse
//     cotangent, on the partial entry); the same pass converts lse to
//     base-2 units.
//  2. dK/dV: one block per (b * h, 64-key tile), kTPR threads per key
//     (4 at d = 64, 8 at d = 128), each owning 16 of the key's dims of
//     k, v, dk and dv in registers (64 floats at either head dim).  The
//     block walks the sq query rows in 32-row tiles staged through shared
//     memory as fp32, starting at the tile's first key under causal
//     masking (the rows above see none of its keys); each (q, k) dot
//     product is kTPR partial sums joined by warp shuffles.
//  3. dQ: one block per (b * h, 64-query tile), the same thread layout
//     over q, do and dq, walking the sk key rows in 32-row tiles and
//     stopping at the tile's last query under causal masking.
// A thread's 16 dims are four float4 chunks interleaved with its
// neighbours' (dims 4 * kTPR * c + 4 * t .. + 3), so the threads of a row
// read different shared-memory banks.  With a kv_mask, a dK/dV block
// whose 64 keys are all masked writes zeros without walking the rows,
// and the dQ pass skips every staged key tile that is wholly masked
// (BERT's padded tails cost no products).  The products run on the fp32
// pipes, not the tensor cores: mma/wgmma tiles are later work.  The
// kernels are in `flash_bwd.cuh`; this file instantiates the lanes above.
#include "flash_bwd.cuh"
#include "flash_common.cuh"
#include "flash_dropout.cuh"

namespace {

// Two kernels, so each keeps its own launch bounds: the unmasked one as
// it always was (ptxas gives it 128 registers at d = 64), the masked one
// held to the registers that let a second 256-thread block in at d = 64
// (128 a thread; unbounded, the mask took it to 130 and one block, 20 %
// slower).  At d = 128 a block is 512 threads, which itself caps a thread
// at 128 registers, one block an SM.
template <typename T, int D>
__global__ void __launch_bounds__(kTile * tpr<D>()) bwd_dkv_kernel(DKV_PARAMS) {
  bwd_dkv_body<T, D, false, kNoDrop, false>(DKV_ARGS);
}

template <typename T, int D>
__global__ void __launch_bounds__(kTile * tpr<D>(), 512 / (kTile * tpr<D>()))
    bwd_dkv_masked_kernel(DKV_PARAMS) {
  bwd_dkv_body<T, D, true, kNoDrop, false>(DKV_ARGS);
}

// The dropout lane, with or without the kv_mask, held to the masked
// kernel's registers (the hash's few live values would otherwise push
// d = 64 past 128 and to one block an SM).
template <typename T, int D, bool kMask>
__global__ void __launch_bounds__(kTile * tpr<D>(), 512 / (kTile * tpr<D>()))
    bwd_dkv_drop_kernel(DKV_PARAMS) {
  bwd_dkv_body<T, D, kMask, kTileHash, false>(DKV_ARGS);
}

// the lanes of this file's entries: kv_mask and the tile-hash dropout
template <typename T, int D>
struct Lanes {
  static auto dkv(const BwdArgs& a) {
    if (a.dr.thr)
      return a.kvm ? bwd_dkv_drop_kernel<T, D, true> : bwd_dkv_drop_kernel<T, D, false>;
    return a.kvm ? bwd_dkv_masked_kernel<T, D> : bwd_dkv_kernel<T, D>;
  }
  static auto dq(const BwdArgs& a) {
    if (a.kvm)
      return a.dr.thr ? bwd_dq_kernel<T, D, true, kTileHash, false>
                      : bwd_dq_kernel<T, D, true, kNoDrop, false>;
    return a.dr.thr ? bwd_dq_kernel<T, D, false, kTileHash, false>
                    : bwd_dq_kernel<T, D, false, kNoDrop, false>;
  }
};

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Every operand is a (b, h, s, d) view given by element strides over
// (b, h, s) with a unit stride on d: q, o, do and dq over sq rows; k, v,
// dk and dv over sk rows (the E entry passes the lanes of the (b, s, h,
// 3d) qkv and dqkv buffers with sq = sk, the packed entry the views of
// its (3, b, h, s, d) qkv and dqkv, the (b, h, s, d) entry its own
// tensors).  lse (b, h, sq) fp32 contiguous, natural log of the scaled
// scores' sum; delta and lse2 are fp32 scratch of b * h * sq each; kvm
// null, or the forward's (b, sk) fp32 key mask, contiguous.  dtype codes:
// 0 float32, 1 bfloat16, 2 float16.  d = 64 or 128.  Dropout: the
// forward's drop_seed, drop_w, drop_thr and drop_inv (drop_thr 0: none).
int apex_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* dq, void* dk, void* dv, void* delta, void* lse2,
    const void* kvm, int b, int h, int sq, int sk, int d, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, long long do_sb, long long do_sh, long long do_ss,
    long long dq_sb, long long dq_sh, long long dq_ss, long long dk_sb,
    long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh,
    long long dv_ss, float scale, int causal, int drop_seed, int drop_w,
    int drop_thr, float drop_inv, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0 || sk <= 0 || b * h > 65535)
    return cudaErrorInvalidValue;
  Drop dr;
  if (!make_drop(kTileHash, drop_seed, drop_w, drop_thr, drop_inv, 0, 0, 0, sq, sk,
                 &dr))
    return cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, o, dout, lse, nullptr, dq, dk, dv, delta, lse2,
                  static_cast<const float*>(kvm), b, h, sq, sk, d,
                  Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss},
                  Strides{v_sb, v_sh, v_ss}, Strides{o_sb, o_sh, o_ss},
                  Strides{do_sb, do_sh, do_ss}, Strides{dq_sb, dq_sh, dq_ss},
                  Strides{dk_sb, dk_sh, dk_ss}, Strides{dv_sb, dv_sh, dv_ss}, scale,
                  causal, 0, dr, static_cast<cudaStream_t>(stream)};
  return launch_bwd<Lanes>(a, dtype);
}

}  // extern "C"
