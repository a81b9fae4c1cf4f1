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
// dim 64 or 128.  The kernels themselves are in `flash_fwd.cuh`; this
// file instantiates the lanes above.
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
// What the design does about it: bf16 and fp16 operands run on the
// tensor cores (`mma_fwd_kernel`, with `flash_mma.cuh`'s tiles), fp32
// operands on the fp32 pipes (`flash_fwd_kernel`: the tensor cores take
// fp32 only as TF32, which would break the fp32 serve's holds).
//
// The tensor-core kernel: one block of 4 warps per (b*h, 64-row q tile),
// 16 rows a warp, the last q tiles first (under causal masking they walk
// the most keys).  Q is staged once by cp.async into a padded shared
// tile and read as `mma.sync.m16n8k16` A fragments by `ldmatrix` each
// walked tile (keeping them in registers would hold 16 more at d = 64,
// 32 at d = 128, beside the 64 of the d = 128 o accumulator).  K and V
// are walked in 64-key tiles, two cp.async stages each, so tile t + 1
// loads while tile t computes: 46 KB of dynamic shared memory at d = 64,
// 87 KB at d = 128, two blocks an SM.  S = Q K^T lands in fp32
// fragments; each element's predicate (position < sk, causal j <= row
// (+ diag on the partial lane), the kv_mask staged by tile) is taken at
// its fragment column, and only on tiles that straddle an edge; a tile
// whose keys the kv_mask masks entirely (BERT's padded tails) is neither
// loaded nor multiplied.  The online softmax keeps each row's running
// max and sum (the quad of 4 lanes that shares a row reduces the max by
// two shuffles; l stays a per-lane part until the end), so the (s, s)
// score matrix never reaches device memory, and under causal masking the
// walk ends at the block's last visible key.  P then feeds P V straight
// from the S fragments, V the B operand through `ldmatrix.trans`; the
// tile's product is summed from zero on the tensor cores and joins the
// fp32 o accumulator by one FFMA that also takes the rescale (the tensor
// cores' sums truncate toward zero, and carried across the whole walk
// they shrank o by 1.1e-6 of |o|: `accumulate_tile`).  o is divided by l
// and rounded once to the operand dtype.
//
// Why P is split: JAX rounds the unnormalized p to v's dtype before
// P V (`apex_tpu/ops/flash_attention.py:400`, `:506`, `:1916`,
// `:2048`); the plain version (`mha_reference`) keeps fp32 p.  Two
// versions that both round there differ wherever fp32 noise carries a p
// across a rounding boundary, and the flip moves o past the card's
// element hold (one bf16 ulp plus 1e-5) where a row's sum cancels
// (`tests/test_torch_flash_fwd_rounding.py`).  So p enters the tensor
// cores as terms that carry its fp32 value, each the rounded remainder
// past the ones before, each product taken once a term from the same V
// fragments: three in bf16 (8-bit significands; two carry 16 of p's 24
// bits, and flip o's final rounding against the plain version ~8x as
// often as fp32 p does), two in fp16 (22 bits).  That is 8 * d
// tensor-core operations a pair in bf16 and 6 * d in fp16, against the
// algorithm's 4 * d.
//
// The fp32 kernel: one block per (b*h, 64-row q tile), a thread a row at
// d = 64 (its q row and fp32 accumulator in registers, 128 floats), two
// threads a row at d = 128 (each owning 64 dims in float4 chunks
// interleaved with its partner's; a score is two partial dots joined by
// one shuffle).  K and V are staged as fp32 in 32-key shared tiles that
// every row reads at once (broadcasts), 2 * d fused multiply-adds a key
// a row, with the same online softmax, causal end and kv_mask skip.
//
// Dropout adds no memory traffic: each (q, k) pair's keep bit is hashed
// from the pair's global coordinates (about ten integer operations a
// pair), so the kernels' tiles need not match JAX's (ps, ps) or (512,
// 512) tiles, and the backward regenerates the same bits.  The lane is a
// template parameter: the dropout-free instantiations carry no hash code.
#include "flash_common.cuh"
#include "flash_dropout.cuh"
#include "flash_fwd.cuh"

namespace {

// the lanes of this file's entries: kv_mask and the tile-hash dropout,
// on the fp32 pipes (pick) and the tensor cores (mma)
template <typename T, int D, int kTPR>
struct Lanes {
  static auto pick(const FwdArgs& a) {
    if (a.kvm)
      return a.dr.thr ? flash_fwd_kernel<T, D, kTPR, true, kTileHash, false>
                      : flash_fwd_kernel<T, D, kTPR, true, kNoDrop, false>;
    return a.dr.thr ? flash_fwd_kernel<T, D, kTPR, false, kTileHash, false>
                    : flash_fwd_kernel<T, D, kTPR, false, kNoDrop, false>;
  }
  static auto mma(const FwdArgs& a) {
    if (a.kvm)
      return a.dr.thr ? mma_fwd_kernel<T, D, true, kTileHash, false>
                      : mma_fwd_kernel<T, D, true, kNoDrop, false>;
    return a.dr.thr ? mma_fwd_kernel<T, D, false, kTileHash, false>
                    : mma_fwd_kernel<T, D, false, kNoDrop, false>;
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
// >= 0, the hash's row stride and tile drop_w, a multiple of 64 or at
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
