// Flash attention's partial entry for Hopper (sm_90a), plain C interface:
// the forward and backward of one (q block, k block) pair of ring
// attention's score matrix, at global positions.
//
// Replaces: apex_tpu/ops/flash_attention.py `flash_attention_partial` —
// the lanes of `_flash_fwd` (row 6) and `_flash_bwd` (row 8) that only it
// reaches: the causal offsets (`has_off`, `_tri_mask`: query i at global
// position q_off + i sees key j at k_off + j iff k_off + j <= q_off + i),
// the lse cotangent (`dlse`, folded into delta at :1040-1044) and the
// coordinate-hash dropout (`_rand_keep_coords` :258, drawn at :375, :488
// and in the backward's passes; `flash_dropout.cuh`'s kCoordHash).
//
// The kernels are the row-6/8 kernels (`flash_fwd.cuh`, `flash_bwd.cuh`),
// instantiated here with their kOff lane: a row's last visible key is row
// + diag (diag = q_off - k_off, one add made once), the causal loops end
// (forward, dQ) and start (dK/dV) at the tile's shifted diagonal, clamped
// to the sequence, so a block wholly in the future loads no key and a
// block wholly in the past runs every tile.  A row that sees no key writes
// o = 0 and JAX's lse, the finite -1e30 * scale (dead_lse): the logaddexp
// merge of two such partials stays finite, where -inf would give NaN; the
// backward's select before the exponential gives its pairs p = 0, so the
// finite lse is never exponentiated.  The delta pass takes the lse
// cotangent as delta - dlse: d lse_i / d s_ij = scale p_ij, so that is all
// it adds.  The lanes live in this file so the others' instantiations stay
// as they were (the offsets add a live register, which at d = 64 would take
// the unmasked dK/dV kernel past 128 registers and to one block an SM) and
// the sources build in parallel.
//
// What bounds it on the H100: operations, as rows 6 and 8.  bench.py's
// bench_ring_flash substep (b = 1, h = 16, s = 8192, d = 64, every key
// visible) does 4 d and 10 d operations a pair, 0.28 and 0.69 ms at the
// bf16 tensor cores' 989 TFLOP/s.  The bf16/fp16 lanes run the
// tensor-core kernels, `mma_fwd_kernel` (`flash_fwd.cuh`) and the
// passes of `flash_bwd.cuh`, which walk 64-key (64-row) tiles and take
// the coordinate hash per pair at any offset; fp32 runs the fp32-pipe
// kernels.
#include "flash_bwd.cuh"
#include "flash_common.cuh"
#include "flash_dropout.cuh"
#include "flash_fwd.cuh"

namespace {

// The partial's fp32 dK/dV lanes, held to the masked kernel's registers
// (two 256-thread blocks an SM at d = 64).
template <typename T, int D, int kMode>
__global__ void __launch_bounds__(kTile * tpr<D>(), 512 / (kTile * tpr<D>()))
    bwd_dkv_partial_kernel(DKV_PARAMS) {
  bwd_dkv_body<T, D, false, kMode, true>(DKV_ARGS);
}

// the partial's lanes: the offsets, with or without the coordinate hash
template <typename T, int D, int kTPR>
struct FwdLanes {
  static auto pick(const FwdArgs& a) {
    return a.dr.thr ? flash_fwd_kernel<T, D, kTPR, false, kCoordHash, true>
                    : flash_fwd_kernel<T, D, kTPR, false, kNoDrop, true>;
  }
  static auto mma(const FwdArgs& a) {
    return a.dr.thr ? mma_fwd_kernel<T, D, false, kCoordHash, true>
                    : mma_fwd_kernel<T, D, false, kNoDrop, true>;
  }
};

template <typename T, int D>
struct BwdLanes {
  static auto dkv(const BwdArgs& a) {
    return a.dr.thr ? bwd_dkv_partial_kernel<T, D, kCoordHash>
                    : bwd_dkv_partial_kernel<T, D, kNoDrop>;
  }
  static auto dq(const BwdArgs& a) {
    return a.dr.thr ? bwd_dq_kernel<T, D, false, kCoordHash, true>
                    : bwd_dq_kernel<T, D, false, kNoDrop, true>;
  }
  static cudaError_t mma(const BwdArgs& a, float alpha) {
    return a.dr.thr ? launch_mma<T, D, false, kCoordHash, true>(a, alpha)
                    : launch_mma<T, D, false, kNoDrop, true>(a, alpha);
  }
};

}  // namespace

extern "C" {

const char* apex_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (b, h, sq, d), k/v (b, h, sk, d), o (b, h, sq, d) given by element
// strides over (b, h, s) with a unit stride on d; lse (b, h, sq) fp32
// contiguous.  dtype codes: 0 float32, 1 bfloat16, 2 float16.  d = 64 or
// 128.  Under causal masking query i sees key j iff j <= i + diag (diag =
// q_off - k_off, in [-sq, sk]); dead_lse is the lse of a row that sees no
// key.  Dropout (`flash_dropout.cuh`'s coordinate hash): drop_thr 0 runs
// none; else drop_seed, drop_q0, drop_k0 and drop_h0 >= 0 (s31 of the
// seed, the dropout's q and k offsets, the global index of head 0) and
// drop_inv = float32(1 / (1 - rate)).
int apex_flash_partial_fwd(const void* q, const void* k, const void* v, void* o,
                           void* lse, int b, int h, int sq, int sk, int d,
                           long long q_sb, long long q_sh, long long q_ss,
                           long long k_sb, long long k_sh, long long k_ss,
                           long long v_sb, long long v_sh, long long v_ss,
                           long long o_sb, long long o_sh, long long o_ss,
                           float scale, int causal, int diag, float dead_lse,
                           int drop_seed, int drop_thr, float drop_inv, int drop_q0,
                           int drop_k0, int drop_h0, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0 || sk <= 0 || b * h > 65535 || diag < -sq ||
      diag > sk)
    return cudaErrorInvalidValue;
  Drop dr;
  if (!make_drop(kCoordHash, drop_seed, 0, drop_thr, drop_inv, drop_q0, drop_k0,
                 drop_h0, sq, sk, &dr))
    return cudaErrorInvalidValue;
  const FwdArgs a{q, k, v, o, lse, nullptr, b, h, sq, sk, d,
                  Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss},
                  Strides{v_sb, v_sh, v_ss}, Strides{o_sb, o_sh, o_ss}, scale,
                  causal, diag, dead_lse, dr, static_cast<cudaStream_t>(stream)};
  return launch_fwd<FwdLanes>(a, dtype);
}

// The backward of apex_flash_partial_fwd: every operand a (b, h, s, d)
// view as that entry's (q, o, do, dq over sq rows; k, v, dk, dv over sk
// rows); lse its fp32 output; dlse null, or the lse cotangent, fp32 (b, h,
// sq) contiguous; delta and lse2 fp32 scratch of b * h * sq each; diag and
// dropout the forward's.
int apex_flash_partial_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, const void* dlse, void* dq, void* dk, void* dv, void* delta,
    void* lse2, int b, int h, int sq, int sk, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss, long long dq_sb,
    long long dq_sh, long long dq_ss, long long dk_sb, long long dk_sh,
    long long dk_ss, long long dv_sb, long long dv_sh, long long dv_ss, float scale,
    int causal, int diag, int drop_seed, int drop_thr, float drop_inv, int drop_q0,
    int drop_k0, int drop_h0, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0 || sk <= 0 || b * h > 65535 || diag < -sq ||
      diag > sk)
    return cudaErrorInvalidValue;
  Drop dr;
  if (!make_drop(kCoordHash, drop_seed, 0, drop_thr, drop_inv, drop_q0, drop_k0,
                 drop_h0, sq, sk, &dr))
    return cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, o, dout, lse, static_cast<const float*>(dlse), dq, dk, dv,
                  delta, lse2, nullptr, b, h, sq, sk, d,
                  Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss},
                  Strides{v_sb, v_sh, v_ss}, Strides{o_sb, o_sh, o_ss},
                  Strides{do_sb, do_sh, do_ss}, Strides{dq_sb, dq_sh, dq_ss},
                  Strides{dk_sb, dk_sh, dk_ss}, Strides{dv_sb, dv_sh, dv_ss}, scale,
                  causal, diag, dr, static_cast<cudaStream_t>(stream)};
  return launch_bwd<BwdLanes>(a, dtype);
}

}  // extern "C"
