"""Flash attention: the CUDA kernels and their plain versions.

Port of every entry of ``apex_tpu/ops/flash_attention.py``:
``flash_attention`` (``_flash_fwd`` and its custom VJPs' ``_flash_bwd``,
with the (b, sk) ``kv_mask`` of ``_flash_attention_masked``) for the
(b, h, s, d) layout, forward and backward; ``flash_attention_partial``
(the same kernels' offsets, lse-cotangent and coordinate-hash dropout
lanes); ``flash_attention_qkv`` (``_flash_fwd_packed`` /
``_flash_bwd_packed``, rows 7 and 9); and ``flash_attention_e``
(``_flash_fwd_e``/``_flash_bwd_e`` and, past a padded sequence of 1024,
``_flash_fwd_e_blocked``/``_flash_bwd_e_blocked``), the
projection-native E layout the transformer layer trains through.
Causal or full, head dim 64 or 128; a ``kv_mask`` keeps a key where it
is > 0 (the padding mask BERT's flash route rides).  The JAX package packs
d=64 head pairs onto 128 TPU lanes, groups E heads by lane budget and
streams long E sequences in (512, 512) VMEM tiles; those are devices of
the TPU's memory, so the port keeps heads apart, walks shared-memory
tiles at every length, and matches the numerics, not the layout.

On a CUDA tensor :func:`flash_attention` launches
``csrc/flash_attention.cu`` or raises; on a CPU tensor it runs
:func:`mha_reference`.  The kernel reads q/k/v through their strides
(a unit stride on d is all it needs), so the serving model hands it
views of the fused QKV projection without copies, and it writes o
into a (b, s, h, d) buffer returned as a (b, h, s, d) view — the
layout the model's output projection reads.  It is differentiable
(:class:`FlashAttentionFunction`): the backward launches
``csrc/flash_attention_bwd.cu`` on a CUDA tensor and runs
:func:`flash_attention_backward_reference` on a CPU one.

:func:`flash_attention_e` takes qkv (b, s, h, 3d), lanes [head][q|k|v]
as the fused QKV projection emits them, and returns (b, s, h*d).  Its
forward is the same kernel launched on strided views of qkv (no copy,
no transpose); its backward, the same backward kernel, writes dq, dk
and dv straight into the heads' lanes of one dqkv buffer.  Both report
natural-log lse of the scaled scores, one convention throughout.  A
padded length past 1024 (:func:`e_mode` "blocked", JAX's ``_e_mode``)
runs the same kernels but counts them as ``flash_attention_e_blocked``
and ``flash_attention_e_bwd_blocked`` (rows 11 and 13).

Attention dropout on the E entry runs inside the kernels (the dropout
lanes of rows 10-13): each (q, k) pair's keep bit is JAX's counter hash
(``_rand_keep``) of the pair's coordinates, regenerated bit for bit by
the backward and by :func:`rand_keep`, the plain version.  The hash's
form follows the route JAX's ``_e_mode(s, h, d, drop=True)`` gives the
shape (:func:`e_mode`): the 128-padded s as its row stride on the
single-block route, 512-wide salted tiles on the blocked walk, s on
JAX's fallback.  The forward drops the unnormalized p and normalizes by
the undropped sum; dv reads the dropped p / (1 - rate) and ds = p (dp
keep / (1 - rate) - delta).  These launches count as
``flash_attention_e_dropout`` / ``flash_attention_e_bwd_dropout`` (the
kv_mask lane included), past a padded length of 1024 as
``flash_attention_e_blocked_dropout`` /
``flash_attention_e_bwd_blocked_dropout``.  The seed is a non-negative
int32 on the host (:func:`dropout_seed` draws one from a CPU
generator), so no launch waits on the card.

A batch row whose every key is masked out (or, under causal masking, a
query row that sees no unmasked key) attends nothing: o = 0 and lse =
-inf there, and its gradients are 0.  The JAX kernels write o = 0 too
(their lse is the finite -1e30 * scale, which nothing reads but the
partial entry's merge).

:func:`flash_attention_partial` is ring attention's building block:
``(o, lse)`` of q against one block of keys at global positions
(``q_offset + i`` sees ``k_offset + j`` iff ``k_offset + j <= q_offset +
i`` under causal masking; the offsets act only under causal masking, as
in JAX), differentiable in both outputs (:class:`FlashAttentionPartialFunction`:
the lse cotangent enters the backward's delta pass).  A row that sees
no key there writes JAX's finite lse, -1e30 * scale in fp32, not -inf:
the logaddexp merge of two such partials then stays finite where -inf
would give NaN.  Its dropout hashes each pair's GLOBAL coordinates
(JAX's ``_rand_keep_coords``; :func:`rand_keep_global` is the plain
mask), salted by the global head (``head_offset`` + the head), so the
shards of one score matrix draw disjoint windows of one mask.  Its
kernels are rows 6/8's with their offsets lane, instantiated in
``csrc/flash_attention_partial.cu`` (so the other lanes compile as they
were).  These launches count as ``flash_attention_partial`` /
``flash_attention_partial_bwd``, with dropout as
``flash_attention_partial_dropout`` /
``flash_attention_partial_bwd_dropout``.

:func:`flash_attention_qkv` takes the packed (3, b, h, s, d) projections.
JAX's packed kernels exist so that q, k and v can be row ranges of one
operand without relayout copies; the port's kernels read through strides
already, so rows 7 and 9 are the row-6/8 kernels launched on the views
``qkv[0]``, ``qkv[1]``, ``qkv[2]`` (the backward writing dq, dk, dv into
the three views of one dqkv buffer), counted as ``flash_attention_qkv``
/ ``flash_attention_qkv_bwd``.  The kv_mask of the (b, h, s, d) entry
counts as ``flash_attention_kvmask`` / ``flash_attention_bwd_kvmask``.

The backward uses ``scale`` as the forward did.  JAX's ``_flash_bwd``
rounds it to v's dtype before folding it into v: at d = 128 in bf16
that moves dq and dk by 1.07e-4 relative; the port does not follow it.
"""
from __future__ import annotations

import math
import struct
from typing import NamedTuple, Optional, Tuple

import torch

from .. import _build
from ._counts import bump

__all__ = ["flash_attention", "flash_attention_with_lse", "mha_reference",
           "flash_attention_backward", "flash_attention_backward_reference",
           "FlashAttentionFunction", "flash_attention_partial",
           "flash_attention_partial_reference",
           "FlashAttentionPartialFunction", "rand_keep_global",
           "flash_attention_qkv", "flash_attention_qkv_reference",
           "FlashAttentionQKVFunction", "e_mode", "rand_keep", "dropout_seed",
           "flash_attention_e", "flash_attention_e_with_lse",
           "flash_attention_e_reference",
           "flash_attention_e_backward",
           "flash_attention_e_backward_reference", "FlashAttentionEFunction"]

_NEG = -1e30
_TAKES = (torch.float32, torch.bfloat16, torch.float16)
_HEAD_DIMS = (64, 128)
# JAX's E routing (apex_tpu/ops/flash_attention.py:1750-1825) at its flag
# defaults (apex_tpu/analysis/flags.py): a longer 128-padded E sequence
# than _E_MAX_SEQ takes the blocked walk, up to _E_MAX_SEQ_BLOCKED, in
# (_E_BLOCK, _E_BLOCK) tiles; head groups fit _E_LANE_BUDGET lanes and a
# VMEM budget for the score temporaries, halved with dropout
_E_MAX_SEQ = 1024
_E_MAX_SEQ_BLOCKED = 32768
_E_BLOCK = 512
_E_LANE_BUDGET = 768
_E_TEMP_BUDGET = 4 << 20
_E_TEMP_BUDGET_BLOCKED = 2 << 20


def _keep_mask(sq, sk, causal, kv_mask, device, diag: int = 0):
    """The (b or 1, 1, sq or 1, sk) boolean of attended (query, key)
    pairs, or None when every pair is attended; under causal masking
    query i sees key j iff j <= i + ``diag``."""
    keep = None
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=device).tril(diag)
    if kv_mask is not None:
        km = (kv_mask > 0)[:, None, None, :]
        keep = km if keep is None else keep & km
    return keep


def _dropped(p, rate, keep):
    """p with dropped pairs 0 and kept ones times float32(1 / (1 - rate)),
    the kernels' factor."""
    if keep is None:
        return p
    return torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)


def _diag(causal: bool, q_offset, k_offset, sq: int, sk: int) -> int:
    """q_offset - k_offset under causal masking (0 otherwise), clamped to
    [-sq, sk], where it already hides every key or shows them all."""
    if not causal:
        return 0
    return max(-sq, min(sk, int(q_offset) - int(k_offset)))


def mha_reference(q, k, v, scale: Optional[float] = None,
                  causal: bool = False, return_lse: bool = False,
                  kv_mask: Optional[torch.Tensor] = None,
                  dropout_rate: float = 0.0,
                  dropout_keep: Optional[torch.Tensor] = None,
                  q_offset: int = 0, k_offset: int = 0):
    """Unfused reference (the jnp twin ``mha_reference``): fp32 scores
    materialized as (b, h, sq, sk), masked with -1e30, fp32 softmax,
    output in q's dtype.  ``return_lse=True`` also returns the fp32
    (b, h, sq) log-sum-exp of the scaled scores, the kernel's second
    output.  ``kv_mask`` (b, sk) keeps the keys where it is > 0, as the
    kernels do: a row with no key left gives o = 0 and lse = -inf (the
    jnp twin gives the uniform mix there; the JAX kernels give 0).
    ``dropout_keep`` (b, h, sq, sk) bool drops the probabilities where it
    is False and scales the kept ones by 1 / (1 - ``dropout_rate``)
    after the softmax (lse stays the undropped one).  Under causal
    masking query i sits at ``q_offset + i`` and key j at ``k_offset +
    j``; a row that then sees no key gives o = 0 and lse = -inf."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    sq, sk = s.shape[-2:]
    diag = _diag(causal, q_offset, k_offset, sq, sk)
    if kv_mask is None and diag >= 0:
        if causal:
            s = s.masked_fill(~_keep_mask(sq, sk, True, None, s.device,
                                          diag), _NEG)
        p = _dropped(torch.softmax(s, dim=-1), dropout_rate, dropout_keep)
        o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
        if return_lse:
            return o, torch.logsumexp(s, dim=-1)
        return o
    s = s.masked_fill(~_keep_mask(sq, sk, causal, kv_mask, s.device, diag),
                      -math.inf)
    # the row max is a shift softmax does not see, so it takes no
    # gradient; a dead row (max -inf) shifts by 0 and sums to 0
    m = s.amax(dim=-1, keepdim=True).detach()
    e = torch.exp(s - m.masked_fill(m == -math.inf, 0.0))
    l = e.sum(dim=-1, keepdim=True)
    p = _dropped(e / l.masked_fill(l == 0, 1.0), dropout_rate, dropout_keep)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(l)).squeeze(-1)
    return o


def _check_qkv(q, k, v, what):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if q.dtype not in _TAKES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} kernel takes q/k/v of one dtype "
                        f"in {_TAKES}, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head dim in "
                         f"{_HEAD_DIMS}, got {d}")
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{what} kernel needs a unit "
                             f"stride on {name}'s last dim")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if b * h > 65535:
        raise ValueError(f"b * h = {b * h} exceeds the kernel grid")


def _kv_mask_arg(kv_mask, b, sk, device):
    """The kernels' mask format: contiguous fp32 (b, sk), or None."""
    if kv_mask is None:
        return None
    if kv_mask.shape != (b, sk) or kv_mask.device != device:
        raise ValueError(f"kv_mask must be (b, sk) = {(b, sk)} on {device}, "
                         f"got {tuple(kv_mask.shape)} on {kv_mask.device}")
    return kv_mask.to(torch.float32).contiguous()


_TILE_HASH, _COORD_HASH = 1, 2   # flash_dropout.cuh's DropMode


class _Drop(NamedTuple):
    """The kernels' dropout arguments (:func:`_drop_args`,
    :func:`_partial_drop`)."""

    rate: float
    seed: int          # s31 of the caller's seed
    width: int         # the tile hash's row stride and tile, W
    threshold: int     # keep iff (fmix32 >> 8) >= threshold
    inv: float         # 1 / (1 - rate), rounded to fp32 by the launch
    mode: int = _TILE_HASH
    q0: int = 0        # the coordinate hash's offsets and head 0
    k0: int = 0
    h0: int = 0


def _launch_drop(drop, partial: bool = False):
    """The dropout arguments of a launch: the tile hash's (seed, W,
    threshold, inv), or the partial entry's coordinate hash's (seed,
    threshold, inv, q0, k0, h0); threshold 0 runs none."""
    if partial:
        return (0, 0, 1.0, 0, 0, 0) if drop is None else \
            (drop.seed, drop.threshold, drop.inv, drop.q0, drop.k0, drop.h0)
    return (0, 0, 0, 1.0) if drop is None else \
        (drop.seed, drop.width, drop.threshold, drop.inv)


def _strides(*ts):
    """The (b, h, s) element strides of each (b, h, s, d) view."""
    return [x for t in ts for x in (t.stride(0), t.stride(1), t.stride(2))]


def _launch(q, k, v, scale, causal, counter="flash_attention",
            kv_mask=None, drop=None, diag=None):
    """One forward launch; ``diag`` not None launches the partial entry's
    lanes (``csrc/flash_attention_partial.cu``: causal offsets q_off -
    k_off = ``diag``, JAX's dead-row lse, the coordinate-hash ``drop``).
    The bf16/fp16 kernel reads q, k and v in 16-byte chunks
    (:func:`_aligned_rows`)."""
    _check_qkv(q, k, v, counter)
    q, k, v = _aligned_rows(q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    kvm = _kv_mask_arg(kv_mask, b, sk, q.device)
    o = torch.empty((b, sq, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if sq == 0 or sk == 0 or b * h == 0:
        return o.zero_(), lse.fill_(-math.inf if diag is None
                                    else _dead_lse(scale))
    tail = (_build.dtype_code(q.dtype), _build.stream_ptr(q.device))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr())
    with torch.cuda.device(q.device):
        if diag is None:
            name = "flash_attention"
            rc = _build.library(name).apex_flash_attention_fwd(
                *ptrs, None if kvm is None else kvm.data_ptr(), b, h, sq, sk,
                d, *_strides(q, k, v, o), float(scale), int(bool(causal)),
                *_launch_drop(drop), *tail)
        else:
            name = "flash_attention_partial"
            rc = _build.library(name).apex_flash_partial_fwd(
                *ptrs, b, h, sq, sk, d, *_strides(q, k, v, o), float(scale),
                int(bool(causal)), int(diag), _dead_lse(scale),
                *_launch_drop(drop, partial=True), *tail)
    _build.check(name, rc, f"{counter} kernel")
    bump(counter)
    return o, lse


def flash_attention_backward_reference(q, k, v, o, lse, do,
                                       scale: Optional[float] = None,
                                       causal: bool = False,
                                       kv_mask: Optional[torch.Tensor]
                                       = None,
                                       dropout_rate: float = 0.0,
                                       dropout_keep: Optional[torch.Tensor]
                                       = None,
                                       q_offset: int = 0, k_offset: int = 0,
                                       dlse: Optional[torch.Tensor] = None):
    """Plain version of the backward kernel: ``(dq, dk, dv)`` from q
    (b, h, sq, d), k and v (b, h, sk, d), the forward's o (b, h, sq, d)
    and natural-log lse (b, h, sq), and do (b, h, sq, d) — p recomputed
    from lse, delta = rowsum(do*o), all in fp32, each cast once to its
    operand's dtype.  Masked pairs take p = 0 before the exponential is
    read (a dead row's lse is -inf, or the partial's -1e30 * scale).
    With the forward's ``dropout_keep``, dv reads the dropped p / (1 -
    rate) and dp is dropped and scaled alike before ds = p (dp - delta).
    ``q_offset``/``k_offset``: the forward's causal offsets; ``dlse``
    (b, h, sq): the cotangent of lse, folded in as delta - dlse (d lse_i
    / d s_ij is scale p_ij)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    sc = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.exp(sc - lse.unsqueeze(-1))
    sq, sk = q.shape[2], k.shape[2]
    keep = _keep_mask(sq, sk, causal, kv_mask, q.device,
                      _diag(causal, q_offset, k_offset, sq, sk))
    if keep is not None:
        p = torch.where(keep, p, torch.zeros((), device=p.device))
    delta = (dof * of).sum(-1, keepdim=True)
    if dlse is not None:
        delta = delta - dlse.float().unsqueeze(-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", _dropped(p, dropout_rate,
                                                  dropout_keep), dof)
    dp = _dropped(torch.einsum("bhqd,bhkd->bhqk", dof, vf), dropout_rate,
                  dropout_keep)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _rows16(t) -> bool:
    """Whether every (b, h, s) row of a view starts 16 bytes aligned."""
    e = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(x % e == 0 for x in t.stride()[:3])


def _aligned_rows(*ts):
    """The views as the bf16/fp16 kernels read them, in rows of 16-byte
    chunks: each view whose rows are not so aligned is copied (the
    model's views all are); fp32 views as they are."""
    if ts[0].dtype == torch.float32:
        return ts
    return tuple(t if _rows16(t) else
                 t.clone(memory_format=torch.contiguous_format) for t in ts)


def _launch_backward(q, k, v, o, lse, do, dq, dk, dv, scale, causal,
                     counter, kv_mask=None, drop=None, diag=None, dlse=None):
    """One launch of the backward kernel on (b, h, s, d) views: q, o,
    do, dq over sq rows, k, v, dk, dv over sk rows (outputs written in
    place).  ``diag`` not None launches the partial entry's lanes, with
    ``dlse`` None or the lse cotangent (b, h, sq).  The bf16/fp16 passes
    read q, k, v and do in 16-byte chunks (:func:`_aligned_rows`)."""
    _check_qkv(q, k, v, counter)
    q, k, v, do = _aligned_rows(q, k, v, do)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    kvm = _kv_mask_arg(kv_mask, b, sk, q.device)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or \
                t.stride(-1) != 1 or t.device != q.device:
            raise ValueError(f"{name} must be {q.dtype} (b, h, sq, d) = "
                             f"{tuple(q.shape)} with a unit stride on d, on "
                             f"{q.device}; got {t.dtype} {tuple(t.shape)}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 {(b, h, sq)}")
    if dlse is not None:
        if dlse.shape != (b, h, sq) or dlse.device != q.device:
            raise ValueError(f"dlse must be {(b, h, sq)} on {q.device}, got "
                             f"{tuple(dlse.shape)} on {dlse.device}")
        dlse = dlse.to(torch.float32).contiguous()
    scratch = torch.empty((2, b, h, sq), dtype=torch.float32,
                          device=q.device)
    strides = _strides(q, k, v, o, do, dq, dk, dv)
    tail = (_build.dtype_code(q.dtype), _build.stream_ptr(q.device))
    with torch.cuda.device(q.device):
        if diag is None:
            name = "flash_attention_bwd"
            rc = _build.library(name).apex_flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
                None if kvm is None else kvm.data_ptr(), b, h, sq, sk, d,
                *strides, float(scale), int(bool(causal)),
                *_launch_drop(drop), *tail)
        else:
            name = "flash_attention_partial"
            rc = _build.library(name).apex_flash_partial_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(),
                None if dlse is None else dlse.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), scratch[0].data_ptr(),
                scratch[1].data_ptr(), b, h, sq, sk, d, *strides,
                float(scale), int(bool(causal)), int(diag),
                *_launch_drop(drop, partial=True), *tail)
    _build.check(name, rc, f"{counter} kernel")
    bump(counter)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor,
                             scale: Optional[float] = None,
                             causal: bool = False,
                             kv_mask: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention` (row 8), from its
    inputs, its o and fp32 natural-log lse (b, h, sq), and the output
    gradient do (b, h, sq, d); each gradient in its operand's shape and
    dtype.  Counts as ``flash_attention_bwd``, with a ``kv_mask`` as
    ``flash_attention_bwd_kvmask``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, lse, do,
                                                  scale=scale,
                                                  causal=causal,
                                                  kv_mask=kv_mask)
    _on_cuda(q, "flash_attention")
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    if dq.numel() and dk.numel():
        _launch_backward(q, k, v, o, lse, do, dq, dk, dv, scale, causal,
                         "flash_attention_bwd" if kv_mask is None
                         else "flash_attention_bwd_kvmask",
                         kv_mask=kv_mask)
    else:
        for t in (dq, dk, dv):
            t.zero_()
    return dq, dk, dv


def _on_cuda(t, what):
    """Raise unless ``t`` lies on a CUDA device (its CPU case is handled
    before)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")


def _forward(q, k, v, scale, causal, kv_mask=None):
    kv_mask = _kv_mask_arg(kv_mask, q.shape[0], k.shape[2], q.device)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, scale=scale, causal=causal,
                             return_lse=True, kv_mask=kv_mask)
    _on_cuda(q, "flash_attention")
    return _launch(q, k, v, scale, causal,
                   counter="flash_attention" if kv_mask is None
                   else "flash_attention_kvmask", kv_mask=kv_mask)


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention over (b, h, s, d) under autograd (the JAX
    package's ``_flash_attention_fused`` and ``_flash_attention_masked``
    custom VJPs): the forward saves q, k, v, o, the fp32 lse and the
    kv_mask and returns ``(o, lse)``; the backward is row 8.  The lse
    output takes no cotangent here (a graph that differentiates through
    it raises): :class:`FlashAttentionPartialFunction`, the partial
    entry's, folds one into the backward's delta.  The mask takes no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, kv_mask=None):
        o, lse = _forward(q, k, v, scale, causal, kv_mask)
        ctx.save_for_backward(q, k, v, o, lse, kv_mask)
        ctx.scale, ctx.causal = scale, causal
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        if dlse is not None:
            raise NotImplementedError(
                "flash_attention_with_lse: lse takes no gradient (use "
                "flash_attention_partial, whose backward folds the lse "
                "cotangent in)")
        q, k, v, o, lse, kv_mask = ctx.saved_tensors
        do = dout if dout.stride(-1) == 1 else dout.contiguous()
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do,
                                              scale=ctx.scale,
                                              causal=ctx.causal,
                                              kv_mask=kv_mask)
        return dq, dk, dv, None, None, None


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, scale: Optional[float] = None,
                             causal: bool = False,
                             kv_mask: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: softmax(q k^T * scale [causal] [kv_mask]) v and the
    fp32 per-row log-sum-exp, (b, h, sq).  Differentiable in o."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttentionFunction.apply(q, k, v, float(scale),
                                        bool(causal), kv_mask)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None,
                    causal: bool = False,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused attention: softmax(q k^T * scale [masked]) v.

    q (b, h, sq, d); k, v (b, h, sk, d); d 64 or 128; ``scale``
    defaults to 1/sqrt(d).  Causal masking keeps key positions <= the
    query's (both counted from 0).  ``kv_mask`` (b, sk) keeps the keys
    where it is > 0 (JAX's ``_flash_attention_masked``; pass it as
    contiguous fp32, the kernels' format, to spare a conversion a call):
    a row with no key left gives o = 0, as JAX's kernel does, and zero
    gradients.  Differentiable: the backward is the row-8 kernel on CUDA
    tensors, its plain version on CPU tensors."""
    return flash_attention_with_lse(q, k, v, scale=scale, causal=causal,
                                    kv_mask=kv_mask)[0]


# --- the E layout: qkv (b, s, h, 3d) -> (b, s, h*d) --------------------

def _padded(s: int) -> int:
    return -(-s // 128) * 128


def _heads_per_group(h: int, d: int, tile: int, budget: int):
    """JAX's ``_pick_heads_per_group`` (tile = the padded s) and
    ``_pick_heads_per_group_blocked`` (tile = the block): the largest
    divisor hg of h whose 3 hg d lanes fit the lane budget and are a
    multiple of 128, and few enough that hg is at most ``budget`` over
    tile^2 (at least 1); None when no hg qualifies."""
    cap = max(1, _E_LANE_BUDGET // (3 * d))
    cap = min(cap, max(1, budget // (tile * tile)))
    for hg in range(min(cap, h), 0, -1):
        if h % hg == 0 and (3 * hg * d) % 128 == 0:
            return hg
    return None


def e_mode(s: int, h: Optional[int] = None, d: Optional[int] = None,
           drop: bool = False) -> str:
    """The route JAX's ``_e_mode(s, h, d, drop)`` gives an E call of
    sequence ``s`` with ``h`` heads of dim ``d``: ``"single"`` (one
    block of the 128-padded s), ``"blocked"`` (the (512, 512) tile walk)
    or ``"fallback"`` (JAX's transposing path; with dropout its
    ``_fallback_dropout_attention``).  The port's kernels serve every
    route; the route picks the form of the dropout hash
    (:func:`rand_keep`).  Without ``h`` and ``d``: by the padded length
    alone, ``"blocked"`` past 1024 — the names the launch counters use
    (the kernels are the same at every length)."""
    ps = _padded(s)
    if h is None or d is None:
        return "blocked" if ps > _E_MAX_SEQ else "single"
    halve = 2 if drop else 1
    if ps <= _E_MAX_SEQ and _heads_per_group(
            h, d, ps, _E_TEMP_BUDGET // halve) is not None:
        return "single"
    if ps <= _E_MAX_SEQ_BLOCKED and _heads_per_group(
            h, d, min(_E_BLOCK, ps),
            _E_TEMP_BUDGET_BLOCKED // halve) is not None:
        return "blocked"
    return "fallback"


def _drop_width(mode: str, sq: int, sk: int) -> int:
    """The hash's row stride and tile W on a route: the 128-padded s on
    the single block, the (512 or, below 512, padded) block on the
    blocked walk, sk on the fallback."""
    ps = _padded(sq)
    return {"single": ps, "blocked": min(_E_BLOCK, ps), "fallback": sk}[mode]


def _seed31(seed) -> int:
    """JAX's fold of a dropout seed: the int32's low 31 bits."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"dropout_seed {seed} is not an int32")
    return seed & 0x7FFFFFFF


def _f32(x: float) -> float:
    """x rounded to float32."""
    return struct.unpack("f", struct.pack("f", x))[0]


def _threshold(rate: float) -> int:
    """ceil(float32(rate) * 2^24): JAX keeps a pair iff its hash's top 24
    bits times 2^-24 are >= float32(rate), that is iff the bits are >=
    this (an exact integer compare)."""
    return math.ceil(_f32(rate) * (1 << 24))


def dropout_seed(generator: torch.Generator) -> int:
    """A seed for the E kernels' dropout: a non-negative int32, uniform in
    [0, 2^31 - 1) as JAX's ``dropout_seed_from_key`` draws it, from the
    CPU ``generator`` — drawn on the host, so no launch waits on the
    card for it."""
    if generator.device.type != "cpu":
        raise ValueError(f"dropout seeds come from a CPU generator, not "
                         f"one on {generator.device}")
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=generator))


def _drop_args(rate, seed, s: int, h: int, d: int) -> Optional[_Drop]:
    """The dropout of an E call of (s, h, d), or None at rate 0."""
    rate = float(rate)
    if rate == 0.0:
        return None
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    return _Drop(rate, _seed31(seed),
                 _drop_width(e_mode(s, h, d, drop=True), s, s),
                 _threshold(rate), 1.0 / (1.0 - rate))


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """(x * k) mod 2^32 for int64 x in [0, 2^32) and a 32-bit k, in two
    16-bit halves of k so no int64 product overflows."""
    return (x * (k & 0xFFFF) + (((x * (k >> 16)) & 0xFFFF) << 16)) & _M32


def _hash24(bi: int, h: int, sq: int, sk: int, seed31: int, width: int,
            device) -> torch.Tensor:
    """The top 24 bits of JAX's counter hash (``_rand_keep``) for every
    (head, query, key) pair of batch row ``bi``: int64 (h, sq, sk)."""
    r = torch.arange(sq, device=device)
    c = torch.arange(sk, device=device)
    ri, ci = r // width, c // width
    x = ((r - ri * width) * width)[:, None] + (c - ci * width)[None, :]
    tile = ((ri * 0x165667B1) & _M32)[:, None] ^ \
        ((ci * 0x9E3779B9) & _M32)[None, :]
    # made on the device: a host list copied there would wait for the
    # card to drain
    heads = ((torch.arange(h, device=device) * 0x27D4EB2F) & _M32) ^ \
        ((seed31 * 0x85EBCA6B ^ bi * 0xC2B2AE35) & _M32)
    return _fmix_top24((x + (tile[None] ^ heads[:, None, None])) & _M32)


def _fmix_top24(x: torch.Tensor) -> torch.Tensor:
    """murmur3's fmix32 of uint32 counters held in int64, its top 24
    bits."""
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return (x ^ (x >> 16)) >> 8


def _coord_hash24(bi: int, h: int, sq: int, sk: int, drop: _Drop,
                  device) -> torch.Tensor:
    """The top 24 bits of JAX's coordinate hash (``_rand_keep_coords``)
    for every (head, query, key) pair of batch row ``bi`` (global):
    int64 (h, sq, sk)."""
    r = torch.arange(sq, device=device) + drop.q0
    c = torch.arange(sk, device=device) + drop.k0
    heads = _mul32((torch.arange(h, device=device) + drop.h0) & _M32,
                   0x27D4EB2F) ^ ((drop.seed * 0x85EBCA6B
                                   ^ bi * 0xC2B2AE35) & _M32)
    x = (_mul32(r & _M32, 0x01000193)[:, None] + c[None, :]) & _M32
    return _fmix_top24((x[None] + heads[:, None, None]) & _M32)


def _keep_of(drop: _Drop, b: int, h: int, sq: int, sk: int, device,
             batch_offset: int = 0):
    keep = torch.empty((b, h, sq, sk), dtype=torch.bool, device=device)
    for bi in range(b):   # one batch row's int64 temporaries at a time
        if drop.mode != _COORD_HASH:
            keep[bi] = _hash24(bi, h, sq, sk, drop.seed, drop.width,
                               device) >= drop.threshold
            continue
        for hi in range(h):   # and, at ring lengths, one head's
            keep[bi, hi] = _coord_hash24(
                batch_offset + bi, 1, sq, sk, drop._replace(h0=drop.h0 + hi),
                device)[0] >= drop.threshold
    return keep


def rand_keep(b: int, h: int, sq: int, sk: int, seed, rate: float,
              mode: str, device=None) -> torch.Tensor:
    """Plain version of the kernels' dropout mask: the (b, h, sq, sk)
    bool of kept (query, key) pairs, JAX's counter hash bit for bit in
    the form of route ``mode`` (:func:`e_mode` with ``drop=True``):
    ``"single"`` hashes (ps, ps) with ps the 128-padded sq, ``"blocked"``
    (512, 512) tiles salted by their (q-block, k-block), ``"fallback"``
    (sq, sk).  Built a batch row at a time: the int64 temporaries of a
    whole (8, 16, 1024, 1024) batch would be 1 GiB each."""
    thr = _threshold(float(rate))
    drop = _Drop(float(rate), _seed31(seed), _drop_width(mode, sq, sk), thr,
                 1.0 / (1.0 - float(rate)))
    return _keep_of(drop, b, h, sq, sk, device)


def _ref_drop(drop: Optional[_Drop], b, h, sq, sk, device) -> dict:
    """The plain versions' dropout arguments for ``drop``."""
    if drop is None:
        return {}
    return dict(dropout_rate=drop.rate,
                dropout_keep=_keep_of(drop, b, h, sq, sk, device))


def _e_counter(s: int, kv_mask, bwd: bool = False,
               drop: bool = False) -> str:
    """The launch counter of an E call: the dropout lane (with or without
    a kv_mask), else the kv_mask lane at any length, else rows 10/12 —
    each past a padded length of 1024 under the row-11/13 name."""
    name = "flash_attention_e" + ("_bwd" if bwd else "")
    if kv_mask is not None and not drop:
        return name + "_kvmask"
    if e_mode(s) == "blocked":
        name += "_blocked"
    return name + ("_dropout" if drop else "")


def _split_e(qkv):
    """(b, h, s, d) views of q, k, v inside qkv (b, s, h, 3d) — no
    copy: strides (s*h*3d, 3d, h*3d, 1)."""
    d = qkv.shape[-1] // 3
    q, k, v = qkv.split(d, dim=-1)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def flash_attention_e_reference(qkv, scale: Optional[float] = None,
                                causal: bool = False,
                                kv_mask: Optional[torch.Tensor] = None,
                                dropout_rate: float = 0.0,
                                dropout_seed=None):
    """Plain version of :func:`flash_attention_e`: :func:`mha_reference`
    on the split views with :func:`rand_keep`'s mask, differentiated by
    autograd."""
    b, s, h, td = qkv.shape
    drop = _drop_args(dropout_rate, dropout_seed, s, h, td // 3)
    q, k, v = _split_e(qkv)
    o = mha_reference(q, k, v, scale=scale, causal=causal, kv_mask=kv_mask,
                      **_ref_drop(drop, b, h, s, s, qkv.device))
    return o.transpose(1, 2).reshape(b, s, h * (td // 3))


def _backward_e_reference(qkv, o, lse, do, scale, causal, kv_mask, drop):
    b, s, h, _ = qkv.shape
    grads = flash_attention_backward_reference(
        *_split_e(qkv), o.transpose(1, 2), lse, do.transpose(1, 2),
        scale=scale, causal=causal, kv_mask=kv_mask,
        **_ref_drop(drop, b, h, s, s, qkv.device))
    return torch.cat([t.transpose(1, 2) for t in grads], dim=-1)


def flash_attention_e_backward_reference(qkv, o, lse, do,
                                         scale: Optional[float] = None,
                                         causal: bool = False,
                                         kv_mask: Optional[torch.Tensor]
                                         = None,
                                         dropout_rate: float = 0.0,
                                         dropout_seed=None):
    """Plain version of the E backward: dqkv (b, s, h, 3d) from qkv, the
    forward's o (b, s, h, d) and natural-log lse (b, h, s), and do (b, s,
    h, d) — :func:`flash_attention_backward_reference` on the split
    views (with the forward's dropout mask), the three gradients laid
    back into qkv's lanes."""
    b, s, h, td = qkv.shape
    return _backward_e_reference(
        qkv, o, lse, do, scale, causal, kv_mask,
        _drop_args(dropout_rate, dropout_seed, s, h, td // 3))


def _backward_e(qkv, o, lse, do, scale, causal, kv_mask, drop):
    if qkv.device.type == "cpu":
        return _backward_e_reference(qkv, o, lse, do, scale, causal,
                                     kv_mask, drop)
    _on_cuda(qkv, "flash_attention_e")
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    _launch_backward(*_split_e(qkv), o.transpose(1, 2), lse,
                     do.transpose(1, 2), *_split_e(dqkv), scale, causal,
                     _e_counter(qkv.shape[1], kv_mask, bwd=True,
                                drop=drop is not None),
                     kv_mask=kv_mask, drop=drop)
    return dqkv


def flash_attention_e_backward(qkv: torch.Tensor, o: torch.Tensor,
                               lse: torch.Tensor, do: torch.Tensor,
                               scale: Optional[float] = None,
                               causal: bool = False,
                               kv_mask: Optional[torch.Tensor] = None,
                               dropout_rate: float = 0.0,
                               dropout_seed=None) -> torch.Tensor:
    """dqkv (b, s, h, 3d) in qkv's layout and dtype, from the forward's
    o (b, s, h, d) and fp32 natural-log lse (b, h, s) and the output
    gradient do (b, s, h, d); ``kv_mask``, ``dropout_rate`` and
    ``dropout_seed`` the forward's.  The masked lane counts as
    ``flash_attention_e_bwd_kvmask``, the dropout lane as
    ``flash_attention_e_bwd_dropout``, a padded length past 1024 under
    the ``_bwd_blocked`` names."""
    b, s, h, td = qkv.shape
    if scale is None:
        scale = (td // 3) ** -0.5
    return _backward_e(qkv, o, lse, do, scale, causal, kv_mask,
                       _drop_args(dropout_rate, dropout_seed, s, h, td // 3))


def _forward_e(qkv, scale, causal, kv_mask=None, drop=None):
    """``(o (b, s, h, d), lse (b, h, s))`` of the E forward; counted as
    :func:`_e_counter` names the call."""
    q, k, v = _split_e(qkv)
    if qkv.device.type == "cpu":
        b, s, h, _ = qkv.shape
        o, lse = mha_reference(q, k, v, scale=scale, causal=causal,
                               return_lse=True, kv_mask=kv_mask,
                               **_ref_drop(drop, b, h, s, s, qkv.device))
    elif qkv.device.type == "cuda":
        o, lse = _launch(q, k, v, scale, causal,
                         counter=_e_counter(qkv.shape[1], kv_mask,
                                            drop=drop is not None),
                         kv_mask=kv_mask, drop=drop)
    else:
        raise ValueError(f"flash_attention_e runs on cuda or cpu, not "
                         f"{qkv.device}")
    return o.transpose(1, 2), lse


def flash_attention_e_with_lse(qkv: torch.Tensor,
                               scale: Optional[float] = None,
                               causal: bool = False,
                               kv_mask: Optional[torch.Tensor] = None,
                               dropout_rate: float = 0.0,
                               dropout_seed=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The E forward without autograd: ``(o, lse)`` with o (b, s, h*d)
    and the fp32 natural-log lse (b, h, s) of the undropped scores."""
    b, s, h, td = qkv.shape
    if scale is None:
        scale = (td // 3) ** -0.5
    o, lse = _forward_e(qkv, scale, causal, kv_mask,
                        _drop_args(dropout_rate, dropout_seed, s, h, td // 3))
    return o.flatten(2), lse


class FlashAttentionEFunction(torch.autograd.Function):
    """Flash attention over the E layout under autograd (the JAX
    package's ``_flash_e_fused``, ``_flash_e_masked``, ``_flash_e_drop``
    and ``_flash_e_masked_drop`` custom VJPs): the forward saves qkv, o,
    the fp32 lse and the kv_mask, and keeps the dropout's arguments (the
    seed a Python int); the backward regenerates the keep mask and
    writes one dqkv in qkv's layout.  The mask takes no gradient."""

    @staticmethod
    def forward(ctx, qkv, kv_mask, scale, causal, drop):
        o, lse = _forward_e(qkv, scale, causal, kv_mask, drop)
        ctx.save_for_backward(qkv, o, lse, kv_mask)
        ctx.scale, ctx.causal, ctx.drop = scale, causal, drop
        return o.flatten(2)

    @staticmethod
    def backward(ctx, dout):
        qkv, o, lse, kv_mask = ctx.saved_tensors
        do = dout.reshape(o.shape)
        if do.stride(-1) != 1:
            do = do.contiguous()
        dqkv = _backward_e(qkv, o, lse, do, ctx.scale, ctx.causal, kv_mask,
                           ctx.drop)
        return dqkv, None, None, None, None


def flash_attention_e(qkv: torch.Tensor, scale: Optional[float] = None,
                      causal: bool = False,
                      kv_mask: Optional[torch.Tensor] = None,
                      dropout_rate: float = 0.0,
                      dropout_seed=None) -> torch.Tensor:
    """Self-attention over the projection-native layout: ``qkv`` (b, s,
    h, 3*d), lanes [head][q|k|v] as ``proj(x).reshape(b, s, h, 3*d)``
    gives them, to the context (b, s, h*d) the output projection reads.
    ``kv_mask`` (b, s): a key is attended where it is > 0 (pass it as
    contiguous fp32, the kernels' format, to spare a conversion a call).
    ``dropout_rate`` > 0 drops attention probabilities inside the kernels
    by JAX's counter hash of ``dropout_seed`` (a non-negative int32, a
    Python int: :func:`dropout_seed`); rate 0 is the dropout-free call.
    Differentiable; the kernels on CUDA tensors, their plain versions on
    CPU tensors."""
    b, s, h, td = qkv.shape
    if scale is None:
        scale = (td // 3) ** -0.5
    return FlashAttentionEFunction.apply(
        qkv, kv_mask, float(scale), bool(causal),
        _drop_args(dropout_rate, dropout_seed, s, h, td // 3))


# --- the partial (o, lse) entry: ring attention's building block -------

def _u31(x, what: str) -> int:
    """A non-negative int32 (a dropout offset or head offset): JAX folds
    it through ``_u32of``, which a negative value would wrap."""
    x = int(x)
    if not 0 <= x < 2 ** 31:
        raise ValueError(f"{what} must be a non-negative int32, got {x}")
    return x


def _partial_drop(rate, seed, q_offset, k_offset, head_offset
                  ) -> Optional[_Drop]:
    """The coordinate-hash dropout of a partial call, or None at rate 0;
    its offsets are the call's own (JAX's dsalt), causal or not."""
    rate = float(rate)
    if rate == 0.0:
        return None
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    return _Drop(rate, _seed31(seed), 0, _threshold(rate), 1.0 / (1.0 - rate),
                 _COORD_HASH, _u31(q_offset, "q_offset"),
                 _u31(k_offset, "k_offset"), _u31(head_offset, "head_offset"))


def rand_keep_global(shape, seed, rate: float, batch_offset: int = 0,
                     head_offset: int = 0, q_offset: int = 0,
                     k_offset: int = 0, device=None) -> torch.Tensor:
    """Plain version of the partial kernels' dropout mask (JAX's
    ``rand_keep_global``): the (b, h, sq, sk) bool of kept pairs, the
    coordinate hash of (seed, ``batch_offset`` + b, ``head_offset`` + h,
    ``q_offset`` + row, ``k_offset`` + col) bit for bit.  Built a batch
    row at a time."""
    b, h, sq, sk = shape
    drop = _partial_drop(rate, seed, q_offset, k_offset, head_offset)
    if drop is None:
        return torch.ones((b, h, sq, sk), dtype=torch.bool, device=device)
    return _keep_of(drop, b, h, sq, sk, device,
                    batch_offset=_u31(batch_offset, "batch_offset"))


def _dead_lse(scale: float) -> float:
    """JAX's lse of a row that sees no key: the fp32 -1e30 times the fp32
    scale, rounded to fp32 as the kernels' ``m * scale`` is (the double
    product of two fp32 values is exact)."""
    return _f32(_f32(_NEG) * _f32(scale))


def _partial_forward_reference(q, k, v, scale, causal, diag, drop):
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    o, lse = mha_reference(q, k, v, scale=scale, causal=causal,
                           return_lse=True, q_offset=diag,
                           **_ref_drop(drop, b, h, sq, sk, q.device))
    return o, torch.where(lse == -math.inf, _dead_lse(scale), lse)


def flash_attention_partial_reference(q, k, v, scale: Optional[float] = None,
                                      causal: bool = False, q_offset=0,
                                      k_offset=0, dropout_rate: float = 0.0,
                                      dropout_seed=None, head_offset=0):
    """Plain version of :func:`flash_attention_partial`:
    :func:`mha_reference` with the offsets and :func:`rand_keep_global`'s
    mask, a dead row's lse JAX's -1e30 * scale; differentiable by
    autograd in o and lse."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    sq, sk = q.shape[2], k.shape[2]
    return _partial_forward_reference(
        q, k, v, scale, causal, _diag(causal, q_offset, k_offset, sq, sk),
        _partial_drop(dropout_rate, dropout_seed, q_offset, k_offset,
                      head_offset))


def _partial_counter(drop, bwd: bool = False) -> str:
    return "flash_attention_partial" + ("_bwd" if bwd else "") + \
        ("" if drop is None else "_dropout")


class FlashAttentionPartialFunction(torch.autograd.Function):
    """:func:`flash_attention_partial` under autograd (the JAX package's
    ``_flash_partial``, ``_flash_partial_nooff`` and
    ``_flash_partial_drop`` custom VJPs): the forward saves q, k, v, o
    and the fp32 lse and keeps the causal ``diag`` and the dropout's
    arguments (host ints); the backward takes both cotangents, the lse's
    folded into the delta pass, and regenerates the keep mask."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, diag, drop):
        if q.device.type == "cpu":
            o, lse = _partial_forward_reference(q, k, v, scale, causal, diag,
                                                drop)
        else:
            _on_cuda(q, "flash_attention_partial")
            o, lse = _launch(q, k, v, scale, causal,
                             counter=_partial_counter(drop), drop=drop,
                             diag=diag)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal, ctx.diag, ctx.drop = scale, causal, diag, drop
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if dout is None else dout.to(o.dtype)
        if do.stride(-1) != 1:
            do = do.contiguous()
        b, h, sq, _ = q.shape
        sk = k.shape[2]
        if q.device.type == "cpu":
            grads = flash_attention_backward_reference(
                q, k, v, o, lse, do, scale=ctx.scale, causal=ctx.causal,
                q_offset=ctx.diag, dlse=dlse,
                **_ref_drop(ctx.drop, b, h, sq, sk, q.device))
            return (*grads, None, None, None, None)
        dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                      for t in (q, k, v))
        _launch_backward(q, k, v, o, lse, do, dq, dk, dv, ctx.scale,
                         ctx.causal, _partial_counter(ctx.drop, bwd=True),
                         drop=ctx.drop, diag=ctx.diag, dlse=dlse)
        return dq, dk, dv, None, None, None, None


def flash_attention_partial(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: Optional[float] = None,
                            causal: bool = False, q_offset: int = 0,
                            k_offset: int = 0, dropout_rate: float = 0.0,
                            dropout_seed=None, head_offset: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise attention's partial: ``(o, lse)`` of q (b, h, sq, d)
    against this block of keys k, v (b, h, sk, d), for the flash merge
    ``lse = logaddexp(lse1, lse2); o = o1 exp(lse1 - lse) + o2 exp(lse2 -
    lse)`` (ring attention's substep).

    Under ``causal`` query i sits at global position ``q_offset + i`` and
    key j at ``k_offset + j`` (host ints); without it the offsets place
    only the dropout.  A row that sees no key gives o = 0 and lse = JAX's
    -1e30 * scale (fp32), which the merge annihilates.  ``dropout_rate``
    > 0 drops pairs inside the kernels by the coordinate hash of
    ``dropout_seed`` (a non-negative int32, a Python int) at the global
    (batch, ``head_offset`` + head, row, col): bit-equal to
    :func:`rand_keep_global` at those offsets; l and lse stay undropped.
    Differentiable in o and lse (the lse cotangent folds into the
    backward's delta, as JAX's ``_flash_bwd`` does); the kernels on CUDA
    tensors, their plain versions on CPU tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    sq, sk = q.shape[2], k.shape[2]
    return FlashAttentionPartialFunction.apply(
        q, k, v, float(scale), bool(causal),
        _diag(causal, q_offset, k_offset, sq, sk),
        _partial_drop(dropout_rate, dropout_seed, q_offset, k_offset,
                      head_offset))


# --- the packed-qkv entry: (3, b, h, s, d) -> (b, h, s, d) --------------

def _check_packed(qkv):
    if qkv.dim() != 5 or qkv.shape[0] != 3:
        raise ValueError(f"qkv must be (3, b, h, s, d), got "
                         f"{tuple(qkv.shape)}")


def flash_attention_qkv_reference(qkv, scale: Optional[float] = None,
                                  causal: bool = False,
                                  kv_mask: Optional[torch.Tensor] = None):
    """Plain version of :func:`flash_attention_qkv`:
    :func:`mha_reference` on ``qkv[0]``, ``qkv[1]``, ``qkv[2]``,
    differentiable by autograd."""
    _check_packed(qkv)
    return mha_reference(*qkv.unbind(0), scale=scale, causal=causal,
                         kv_mask=kv_mask)


class FlashAttentionQKVFunction(torch.autograd.Function):
    """:func:`flash_attention_qkv` under autograd (the JAX package's
    ``_flash_qkv_fused`` and ``_flash_qkv_masked`` custom VJPs): the
    row-6 kernel on the three views of qkv (row 7), saving qkv, o, the
    fp32 lse and the kv_mask; the backward (row 9) writes dq, dk and dv
    straight into the three views of one dqkv buffer."""

    @staticmethod
    def forward(ctx, qkv, kv_mask, scale, causal):
        q, k, v = qkv.unbind(0)
        kv_mask = _kv_mask_arg(kv_mask, q.shape[0], k.shape[2], q.device)
        if qkv.device.type == "cpu":
            o, lse = mha_reference(q, k, v, scale=scale, causal=causal,
                                   return_lse=True, kv_mask=kv_mask)
        else:
            _on_cuda(qkv, "flash_attention_qkv")
            o, lse = _launch(q, k, v, scale, causal,
                             counter="flash_attention_qkv", kv_mask=kv_mask)
        ctx.save_for_backward(qkv, o, lse, kv_mask)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, dout):
        qkv, o, lse, kv_mask = ctx.saved_tensors
        do = dout if dout.stride(-1) == 1 else dout.contiguous()
        if qkv.device.type == "cpu":
            dqkv = torch.stack(flash_attention_backward_reference(
                *qkv.unbind(0), o, lse, do, scale=ctx.scale,
                causal=ctx.causal, kv_mask=kv_mask))
        else:
            dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
            _launch_backward(*qkv.unbind(0), o, lse, do, *dqkv.unbind(0),
                             ctx.scale, ctx.causal, "flash_attention_qkv_bwd",
                             kv_mask=kv_mask)
        return dqkv, None, None, None


def flash_attention_qkv(qkv: torch.Tensor, scale: Optional[float] = None,
                        causal: bool = False,
                        kv_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Self-attention over packed projections: ``qkv`` (3, b, h, s, d) to
    the context (b, h, s, d), the same as ``flash_attention(qkv[0],
    qkv[1], qkv[2], scale, causal, kv_mask)`` and bit-equal to it (the
    same kernels, launched on the three views).  ``kv_mask`` (b, s)
    keeps the keys where it is > 0.  Differentiable into one dqkv in
    qkv's layout; the kernels on CUDA tensors, their plain versions on
    CPU tensors."""
    _check_packed(qkv)
    if scale is None:
        scale = qkv.shape[-1] ** -0.5
    return FlashAttentionQKVFunction.apply(qkv, kv_mask, float(scale),
                                           bool(causal))
