"""Flash attention: the CUDA kernels and their plain versions.

Port of ``apex_tpu/ops/flash_attention.py``'s ``flash_attention``
(``_flash_fwd`` and its custom VJP's ``_flash_bwd``) for the (b, h, s,
d) layout, forward and backward, and of ``flash_attention_e``
(``_flash_fwd_e``/``_flash_bwd_e`` and, past a padded sequence of 1024,
``_flash_fwd_e_blocked``/``_flash_bwd_e_blocked``), the
projection-native E layout the transformer layer trains through.
Causal or full, head dim 64 or 128; the E entry also takes a (b, s)
``kv_mask`` (a key is attended where it is > 0), the padding mask
BERT's flash route rides — no offsets, lse cotangent or dropout in this
slice, and no kv_mask on the (b, h, s, d) entry.  The JAX package packs
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

A batch row whose every key is masked out (or, under causal masking, a
query row that sees no unmasked key) attends nothing: o = 0 and lse =
-inf there, and its gradients are 0.  The JAX kernels write o = 0 too
(their lse is the finite -1e30 * scale, which nothing reads).

The backward uses ``scale`` as the forward did.  JAX's ``_flash_bwd``
rounds it to v's dtype before folding it into v: at d = 128 in bf16
that moves dq and dk by 1.07e-4 relative; the port does not follow it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import _build
from ._counts import bump

__all__ = ["flash_attention", "flash_attention_with_lse", "mha_reference",
           "flash_attention_backward", "flash_attention_backward_reference",
           "FlashAttentionFunction", "e_mode",
           "flash_attention_e", "flash_attention_e_with_lse",
           "flash_attention_e_reference",
           "flash_attention_e_backward",
           "flash_attention_e_backward_reference", "FlashAttentionEFunction"]

_NEG = -1e30
_TAKES = (torch.float32, torch.bfloat16, torch.float16)
_HEAD_DIMS = (64, 128)
# JAX's _E_MAX_SEQ: a longer 128-padded E sequence takes the blocked walk
_E_MAX_SEQ = 1024


def _keep_mask(sq, sk, causal, kv_mask, device):
    """The (b or 1, 1, sq or 1, sk) boolean of attended (query, key)
    pairs, or None when every pair is attended."""
    keep = None
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=device).tril()
    if kv_mask is not None:
        km = (kv_mask > 0)[:, None, None, :]
        keep = km if keep is None else keep & km
    return keep


def mha_reference(q, k, v, scale: Optional[float] = None,
                  causal: bool = False, return_lse: bool = False,
                  kv_mask: Optional[torch.Tensor] = None):
    """Unfused reference (the jnp twin ``mha_reference``): fp32 scores
    materialized as (b, h, sq, sk), masked with -1e30, fp32 softmax,
    output in q's dtype.  ``return_lse=True`` also returns the fp32
    (b, h, sq) log-sum-exp of the scaled scores, the kernel's second
    output.  ``kv_mask`` (b, sk) keeps the keys where it is > 0, as the
    kernels do: a row with no key left gives o = 0 and lse = -inf (the
    jnp twin gives the uniform mix there; the JAX kernels give 0)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    sq, sk = s.shape[-2:]
    if kv_mask is None:
        if causal:
            s = s.masked_fill(~_keep_mask(sq, sk, True, None, s.device),
                              _NEG)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
        if return_lse:
            return o, torch.logsumexp(s, dim=-1)
        return o
    s = s.masked_fill(~_keep_mask(sq, sk, causal, kv_mask, s.device),
                      -math.inf)
    # the row max is a shift softmax does not see, so it takes no
    # gradient; a dead row (max -inf) shifts by 0 and sums to 0
    m = s.amax(dim=-1, keepdim=True).detach()
    e = torch.exp(s - m.masked_fill(m == -math.inf, 0.0))
    l = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", e / l.masked_fill(l == 0, 1.0),
                     v.float()).to(q.dtype)
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


def _launch(q, k, v, scale, causal, counter="flash_attention",
            kv_mask=None):
    _check_qkv(q, k, v, counter)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    kvm = _kv_mask_arg(kv_mask, b, sk, q.device)
    o = torch.empty((b, sq, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if sq == 0 or sk == 0 or b * h == 0:
        return o.zero_(), lse.fill_(-math.inf)
    lib = _build.library("flash_attention")
    strides = []
    for t in (q, k, v, o):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    with torch.cuda.device(q.device):
        rc = lib.apex_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), None if kvm is None else kvm.data_ptr(), b, h,
            sq, sk, d, *strides, float(scale), int(bool(causal)),
            _build.dtype_code(q.dtype), _build.stream_ptr(q.device))
    _build.check("flash_attention", rc, f"{counter} kernel")
    bump(counter)
    return o, lse


def flash_attention_backward_reference(q, k, v, o, lse, do,
                                       scale: Optional[float] = None,
                                       causal: bool = False,
                                       kv_mask: Optional[torch.Tensor]
                                       = None):
    """Plain version of the backward kernel: ``(dq, dk, dv)`` from q
    (b, h, sq, d), k and v (b, h, sk, d), the forward's o (b, h, sq, d)
    and natural-log lse (b, h, sq), and do (b, h, sq, d) — p recomputed
    from lse, delta = rowsum(do*o), all in fp32, each cast once to its
    operand's dtype.  Masked pairs take p = 0 before the exponential is
    read (a dead row's lse is -inf)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    sc = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.exp(sc - lse.unsqueeze(-1))
    keep = _keep_mask(q.shape[2], k.shape[2], causal, kv_mask, q.device)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros((), device=p.device))
    delta = (dof * of).sum(-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _launch_backward(q, k, v, o, lse, do, dq, dk, dv, scale, causal,
                     counter, kv_mask=None):
    """One launch of the backward kernel on (b, h, s, d) views: q, o,
    do, dq over sq rows, k, v, dk, dv over sk rows (outputs written in
    place)."""
    _check_qkv(q, k, v, counter)
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
    scratch = torch.empty((2, b, h, sq), dtype=torch.float32,
                          device=q.device)
    strides = []
    for t in (q, k, v, o, do, dq, dk, dv):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    lib = _build.library("flash_attention_bwd")
    with torch.cuda.device(q.device):
        rc = lib.apex_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
            None if kvm is None else kvm.data_ptr(), b, h, sq, sk, d,
            *strides, float(scale), int(bool(causal)),
            _build.dtype_code(q.dtype), _build.stream_ptr(q.device))
    _build.check("flash_attention_bwd", rc, f"{counter} kernel")
    bump(counter)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor,
                             scale: Optional[float] = None,
                             causal: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention` (row 8), from its
    inputs, its o and fp32 natural-log lse (b, h, sq), and the output
    gradient do (b, h, sq, d); each gradient in its operand's shape and
    dtype.  Counts as ``flash_attention_bwd``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, lse, do,
                                                  scale=scale,
                                                  causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dq.numel() and dk.numel():
        _launch_backward(q, k, v, o, lse, do, dq, dk, dv, scale, causal,
                         "flash_attention_bwd")
    else:
        for t in (dq, dk, dv):
            t.zero_()
    return dq, dk, dv


def _forward(q, k, v, scale, causal):
    if q.device.type == "cpu":
        return mha_reference(q, k, v, scale=scale, causal=causal,
                             return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k, v, scale, causal)


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention over (b, h, s, d) under autograd (the JAX
    package's ``_flash_attention_fused`` custom VJP): the forward saves
    q, k, v, o and the fp32 lse and returns ``(o, lse)``; the backward
    is row 8.  The lse output takes no cotangent (JAX's
    ``flash_attention_partial`` folds one into delta; that entry, with
    ring attention, is not ported): a graph that differentiates through
    it raises."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        o, lse = _forward(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        if dlse is not None:
            raise NotImplementedError(
                "flash_attention_with_lse: a gradient through lse (the lse "
                "cotangent of JAX's flash_attention_partial) is not ported")
        q, k, v, o, lse = ctx.saved_tensors
        do = dout if dout.stride(-1) == 1 else dout.contiguous()
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do,
                                              scale=ctx.scale,
                                              causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, scale: Optional[float] = None,
                             causal: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: softmax(q k^T * scale [causal]) v and the fp32
    per-row log-sum-exp, (b, h, sq).  Differentiable in o."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttentionFunction.apply(q, k, v, float(scale),
                                        bool(causal))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None,
                    causal: bool = False) -> torch.Tensor:
    """Fused attention: softmax(q k^T * scale [causal]) v.

    q (b, h, sq, d); k, v (b, h, sk, d); d 64 or 128; ``scale``
    defaults to 1/sqrt(d).  Causal masking keeps key positions <= the
    query's (both counted from 0).  Differentiable: the backward is the
    row-8 kernel on CUDA tensors, its plain version on CPU tensors."""
    return flash_attention_with_lse(q, k, v, scale=scale,
                                    causal=causal)[0]


# --- the E layout: qkv (b, s, h, 3d) -> (b, s, h*d) --------------------

def e_mode(s: int) -> str:
    """``"single"`` or ``"blocked"``: the JAX E route (``_e_mode``) a
    sequence of ``s`` takes, by its 128-padded length against 1024 — the
    name the port counts its E launches under (the kernels are the same
    at every length)."""
    return "blocked" if -(-s // 128) * 128 > _E_MAX_SEQ else "single"


def _e_counter(s: int, kv_mask, bwd: bool = False) -> str:
    """The launch counter of an E call: the kv_mask lane at any length,
    else rows 11/13 past a padded length of 1024, else rows 10/12."""
    name = "flash_attention_e" + ("_bwd" if bwd else "")
    if kv_mask is not None:
        return name + "_kvmask"
    return name + ("_blocked" if e_mode(s) == "blocked" else "")


def _split_e(qkv):
    """(b, h, s, d) views of q, k, v inside qkv (b, s, h, 3d) — no
    copy: strides (s*h*3d, 3d, h*3d, 1)."""
    d = qkv.shape[-1] // 3
    q, k, v = qkv.split(d, dim=-1)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def flash_attention_e_reference(qkv, scale: Optional[float] = None,
                                causal: bool = False,
                                kv_mask: Optional[torch.Tensor] = None):
    """Plain version of :func:`flash_attention_e`: :func:`mha_reference`
    on the split views, differentiated by autograd."""
    b, s, h, td = qkv.shape
    q, k, v = _split_e(qkv)
    o = mha_reference(q, k, v, scale=scale, causal=causal, kv_mask=kv_mask)
    return o.transpose(1, 2).reshape(b, s, h * (td // 3))


def flash_attention_e_backward_reference(qkv, o, lse, do,
                                         scale: Optional[float] = None,
                                         causal: bool = False,
                                         kv_mask: Optional[torch.Tensor]
                                         = None):
    """Plain version of the E backward: dqkv (b, s, h, 3d) from qkv, the
    forward's o (b, s, h, d) and natural-log lse (b, h, s), and do (b, s,
    h, d) — :func:`flash_attention_backward_reference` on the split
    views, the three gradients laid back into qkv's lanes."""
    grads = flash_attention_backward_reference(
        *_split_e(qkv), o.transpose(1, 2), lse, do.transpose(1, 2),
        scale=scale, causal=causal, kv_mask=kv_mask)
    return torch.cat([t.transpose(1, 2) for t in grads], dim=-1)


def flash_attention_e_backward(qkv: torch.Tensor, o: torch.Tensor,
                               lse: torch.Tensor, do: torch.Tensor,
                               scale: Optional[float] = None,
                               causal: bool = False,
                               kv_mask: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """dqkv (b, s, h, 3d) in qkv's layout and dtype, from the forward's
    o (b, s, h, d) and fp32 natural-log lse (b, h, s) and the output
    gradient do (b, s, h, d); ``kv_mask`` the forward's (b, s) mask.
    The masked lane counts as ``flash_attention_e_bwd_kvmask``, a
    padded length past 1024 as ``flash_attention_e_bwd_blocked``."""
    if scale is None:
        scale = (qkv.shape[-1] // 3) ** -0.5
    if qkv.device.type == "cpu":
        return flash_attention_e_backward_reference(qkv, o, lse, do,
                                                    scale=scale,
                                                    causal=causal,
                                                    kv_mask=kv_mask)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_e runs on cuda or cpu, not "
                         f"{qkv.device}")
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    _launch_backward(*_split_e(qkv), o.transpose(1, 2), lse,
                     do.transpose(1, 2), *_split_e(dqkv), scale, causal,
                     _e_counter(qkv.shape[1], kv_mask, bwd=True),
                     kv_mask=kv_mask)
    return dqkv


def _forward_e(qkv, scale, causal, kv_mask=None):
    """``(o (b, s, h, d), lse (b, h, s))`` of the E forward; with a
    ``kv_mask`` the launch counts as ``flash_attention_e_kvmask``, past
    a padded length of 1024 as ``flash_attention_e_blocked``."""
    q, k, v = _split_e(qkv)
    if qkv.device.type == "cpu":
        o, lse = mha_reference(q, k, v, scale=scale, causal=causal,
                               return_lse=True, kv_mask=kv_mask)
    elif qkv.device.type == "cuda":
        o, lse = _launch(q, k, v, scale, causal,
                         counter=_e_counter(qkv.shape[1], kv_mask),
                         kv_mask=kv_mask)
    else:
        raise ValueError(f"flash_attention_e runs on cuda or cpu, not "
                         f"{qkv.device}")
    return o.transpose(1, 2), lse


def flash_attention_e_with_lse(qkv: torch.Tensor,
                               scale: Optional[float] = None,
                               causal: bool = False,
                               kv_mask: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The E forward without autograd: ``(o, lse)`` with o (b, s, h*d)
    and the fp32 natural-log lse (b, h, s)."""
    if scale is None:
        scale = (qkv.shape[-1] // 3) ** -0.5
    o, lse = _forward_e(qkv, scale, causal, kv_mask)
    return o.flatten(2), lse


class FlashAttentionEFunction(torch.autograd.Function):
    """Flash attention over the E layout under autograd (the JAX
    package's ``_flash_e_fused`` and ``_flash_e_masked`` custom VJPs):
    the forward saves qkv, o, the fp32 lse and the kv_mask; the backward
    writes one dqkv in qkv's layout.  The mask takes no gradient."""

    @staticmethod
    def forward(ctx, qkv, kv_mask, scale, causal):
        o, lse = _forward_e(qkv, scale, causal, kv_mask)
        ctx.save_for_backward(qkv, o, lse, kv_mask)
        ctx.scale, ctx.causal = scale, causal
        return o.flatten(2)

    @staticmethod
    def backward(ctx, dout):
        qkv, o, lse, kv_mask = ctx.saved_tensors
        do = dout.reshape(o.shape)
        if do.stride(-1) != 1:
            do = do.contiguous()
        dqkv = flash_attention_e_backward(qkv, o, lse, do, scale=ctx.scale,
                                          causal=ctx.causal, kv_mask=kv_mask)
        return dqkv, None, None, None


def flash_attention_e(qkv: torch.Tensor, scale: Optional[float] = None,
                      causal: bool = False,
                      kv_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Self-attention over the projection-native layout: ``qkv`` (b, s,
    h, 3*d), lanes [head][q|k|v] as ``proj(x).reshape(b, s, h, 3*d)``
    gives them, to the context (b, s, h*d) the output projection reads.
    ``kv_mask`` (b, s): a key is attended where it is > 0 (pass it as
    contiguous fp32, the kernels' format, to spare a conversion a call).
    Differentiable; the kernels on CUDA tensors, their plain versions on
    CPU tensors."""
    if scale is None:
        scale = (qkv.shape[-1] // 3) ** -0.5
    return FlashAttentionEFunction.apply(qkv, kv_mask, float(scale),
                                         bool(causal))
