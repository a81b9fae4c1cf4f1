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
// delta_i = sum_d do_i * o_i, ds = p * (do v^T - delta) * scale, and
// dq = ds k, dk = ds^T q, dv = p^T do, each accumulated in fp32 and cast
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
// Rounding points.  JAX's kernels round the dropped p to the operand
// dtype before p^T do (`apex_tpu/ops/flash_attention.py:924`, `:1022`,
// `:2196`, `:2381`) and ds before ds k and ds^T q (`:844`, `:925`,
// `:1023-1024`, `:2203-2204`, `:2342`, `:2389`).  This kernel does not
// round there: it feeds p and ds to the tensor cores as two bf16 (fp16)
// terms, hi = round(x) and lo = round(x - hi), each product taken twice
// from the same B fragments, so they enter at 2^-16 (2^-22) of their
// fp32 value, and the plain version keeps fp32 p and ds.  Two versions
// that both round at JAX's points differ wherever fp32 noise before the
// rounding (the order of the score sums, exp2 against exp, delta's
// order) carries a value across a rounding boundary: one flipped p or ds
// moves a gradient element by an operand ulp times its partner, past
// the card's element hold (one bf16 ulp of the output plus 1e-5) where
// the element's sum cancels.  `tests/test_torch_flash_bwd_rounding.py`
// measures it: two such versions, differing only in the order of their
// fp32 sums, miss that hold at (1, 4, 1024, 64) causal, while the split
// holds within it.
//
// What bounds it on the H100: operations.  The algorithm does 10 * d
// operations per (q, k) pair (recomputed scores, do v^T, and the three
// products) against about 16 * d bytes per row moved in bf16 (q, k, v,
// o, do read, dq, dk, dv written): at s = 1024 causal that is ~43 GFLOP
// against ~134 MB for b = 8, h = 16, d = 64, so the bf16 tensor cores
// are the limit (~44 us); at s = 16384 it is 2.7 TFLOP for h = 16,
// d = 128 (2.78 ms at 989 TFLOP/s).  The split makes the kernel's own
// tensor work 16 * d a pair (the three accumulating products twice).
//
// The design: three passes, every one deterministic (no atomics, every
// output element written by exactly one thread).
//  1. delta: one warp per (b, h, query row) reduces do . o (less the lse
//     cotangent, on the partial entry); the same pass converts lse to
//     base-2 units.
//  2. dK/dV: one block of 4 warps per (b * h, 64-key tile), 16 keys a
//     warp.  K and V stay in shared memory as bf16/fp16; the query rows
//     and their lse2 and delta come in through cp.async in tiles of 64
//     rows at d = 64 (32 at d = 128, so the dK and dV accumulators, 128
//     fp32 registers a thread, and the score tiles fit), two stages, the
//     next tile landing while this one computes.  Per tile a warp forms
//     S^T = K Q^T and dP^T = V dO^T with `mma.sync.m16n8k16` (keys are
//     the fragment's rows, operands by `ldmatrix`), applies every lane's
//     predicate per fragment element, and adds P^T dO and dS^T Q with
//     P^T and dS^T packed from the accumulators straight into A
//     fragments.  Under causal masking the walk starts at the tile's
//     first key's first row; a block whose 64 keys the kv_mask all drops
//     writes zeros without walking.
//  3. dQ: one block of 4 warps per (b * h, 64-query tile), last tiles
//     first (they walk the most keys), Q and dO in shared memory, the
//     keys walked in 64-row cp.async stages, stopping at the tile's last
//     query under causal masking; with a kv_mask, a key tile whose keys
//     are all masked is neither loaded nor multiplied (BERT's padded
//     tails cost no products).
// Shared rows are padded by 16 bytes, so the eight rows an `ldmatrix`
// reads fall in eight bank groups.  fp32 operands run the fp32-pipe
// passes of the same three-pass shape (a thread owns 16 dims of a key or
// query, 32-row fp32 tiles, warp-shuffle dot products): the tensor cores
// take fp32 only as TF32, which would cut fp32's gradients to ~3 digits.
// Registers, spills and blocks an SM of each instantiation: `chip_smoke.py`
// prints them from `ptxas -v` beside `cuobjdump -sass`'s HMMA counts, and
// PERF.md records them.  The kernels are in `flash_bwd.cuh`; this file
// instantiates the lanes above.
#include "flash_bwd.cuh"
#include "flash_common.cuh"
#include "flash_dropout.cuh"

namespace {

// The fp32 passes.  Two dK/dV kernels, so each keeps its own launch
// bounds: the unmasked one as it always was (ptxas gives it 128 registers
// at d = 64), the masked one held to the registers that let a second
// 256-thread block in at d = 64 (128 a thread; unbounded, the mask took it
// to 130 and one block, 20 % slower).  At d = 128 a block is 512 threads,
// which itself caps a thread at 128 registers, one block an SM.
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

// the lanes of this file's entries: kv_mask and the tile-hash dropout;
// dkv and dq pick the fp32 kernels, mma launches the tensor-core passes
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
  static cudaError_t mma(const BwdArgs& a, float alpha) {
    if (a.dr.thr)
      return a.kvm ? launch_mma<T, D, true, kTileHash, false>(a, alpha)
                   : launch_mma<T, D, false, kTileHash, false>(a, alpha);
    return a.kvm ? launch_mma<T, D, true, kNoDrop, false>(a, alpha)
                 : launch_mma<T, D, false, kNoDrop, false>(a, alpha);
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
