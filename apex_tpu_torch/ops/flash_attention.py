"""Flash attention: the CUDA kernels and their plain versions.

Port of ``apex_tpu/ops/flash_attention.py``'s ``flash_attention``
(``_flash_fwd`` and its two Pallas bodies) for the (b, h, s, d) layout,
forward only, and of ``flash_attention_e`` (``_flash_fwd_e`` and
``_flash_bwd_e``), the projection-native E layout the transformer layer
trains through, forward and backward.  Causal or full — no kv_mask,
offsets or dropout in this slice.  The JAX package packs d=64 head
pairs onto 128 TPU lanes and groups E heads by lane budget; those are
lane-layout devices of the TPU, so the port keeps heads apart and
matches the numerics, not the layout.

On a CUDA tensor :func:`flash_attention` launches
``csrc/flash_attention.cu`` or raises; on a CPU tensor it runs
:func:`mha_reference`.  The kernel reads q/k/v through their strides
(a unit stride on d is all it needs), so the serving model hands it
views of the fused QKV projection without copies, and it writes o
into a (b, s, h, d) buffer returned as a (b, h, s, d) view — the
layout the model's output projection reads.

:func:`flash_attention_e` takes qkv (b, s, h, 3d), lanes [head][q|k|v]
as the fused QKV projection emits them, and returns (b, s, h*d).  Its
forward is the same kernel launched on strided views of qkv (no copy,
no transpose); its backward (``csrc/flash_attention_bwd.cu``) writes dq,
dk and dv straight into the heads' lanes of one dqkv buffer.  Both
report natural-log lse of the scaled scores, one convention throughout.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import _build
from ._counts import bump

__all__ = ["flash_attention", "flash_attention_with_lse", "mha_reference",
           "flash_attention_e", "flash_attention_e_with_lse",
           "flash_attention_e_reference",
           "flash_attention_e_backward",
           "flash_attention_e_backward_reference", "FlashAttentionEFunction"]

_NEG = -1e30
_TAKES = (torch.float32, torch.bfloat16, torch.float16)
_HEAD_DIMS = (64,)


def mha_reference(q, k, v, scale: Optional[float] = None,
                  causal: bool = False, return_lse: bool = False):
    """Unfused reference (the jnp twin ``mha_reference``): fp32 scores
    materialized as (b, h, sq, sk), masked with -1e30, fp32 softmax,
    output in q's dtype.  ``return_lse=True`` also returns the fp32
    (b, h, sq) log-sum-exp of the scaled scores, the kernel's second
    output."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2:]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~mask, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
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


def _launch(q, k, v, scale, causal, counter="flash_attention"):
    _check_qkv(q, k, v, counter)
    b, h, sq, d = q.shape
    sk = k.shape[2]
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
            lse.data_ptr(), b, h, sq, sk, d, *strides, float(scale),
            int(bool(causal)), _build.dtype_code(q.dtype),
            _build.stream_ptr(q.device))
    _build.check("flash_attention", rc, f"{counter} kernel")
    bump(counter)
    return o, lse


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, scale: Optional[float] = None,
                             causal: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: softmax(q k^T * scale [causal]) v and the fp32
    per-row log-sum-exp, (b, h, sq)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return mha_reference(q, k, v, scale=scale, causal=causal,
                             return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k, v, scale, causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None,
                    causal: bool = False) -> torch.Tensor:
    """Fused attention: softmax(q k^T * scale [causal]) v.

    q (b, h, sq, d); k, v (b, h, sk, d); ``scale`` defaults to
    1/sqrt(d).  Causal masking keeps key positions <= the query's (both
    counted from 0).  Forward only."""
    return flash_attention_with_lse(q, k, v, scale=scale,
                                    causal=causal)[0]


# --- the E layout: qkv (b, s, h, 3d) -> (b, s, h*d) --------------------

def _split_e(qkv):
    """(b, h, s, d) views of q, k, v inside qkv (b, s, h, 3d) — no
    copy: strides (s*h*3d, 3d, h*3d, 1)."""
    d = qkv.shape[-1] // 3
    q, k, v = qkv.split(d, dim=-1)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def flash_attention_e_reference(qkv, scale: Optional[float] = None,
                                causal: bool = False):
    """Plain version of :func:`flash_attention_e`: :func:`mha_reference`
    on the split views, differentiated by autograd."""
    b, s, h, td = qkv.shape
    q, k, v = _split_e(qkv)
    o = mha_reference(q, k, v, scale=scale, causal=causal)
    return o.transpose(1, 2).reshape(b, s, h * (td // 3))


def flash_attention_e_backward_reference(qkv, o, lse, do,
                                         scale: Optional[float] = None,
                                         causal: bool = False):
    """Plain version of the backward kernel: dqkv (b, s, h, 3d) from
    qkv, the forward's o (b, s, h, d) and natural-log lse (b, h, s),
    and do (b, s, h, d) — p recomputed from lse, delta = rowsum(do*o),
    all in fp32, cast once to qkv's dtype."""
    b, s, h, td = qkv.shape
    d = td // 3
    if scale is None:
        scale = d ** -0.5
    q, k, v = (t.float() for t in _split_e(qkv))
    of = o.float().transpose(1, 2)
    dof = do.float().transpose(1, 2)
    sc = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=qkv.device).tril()
        sc = sc.masked_fill(~mask, -math.inf)
    p = torch.exp(sc - lse.unsqueeze(-1))
    delta = (dof * of).sum(-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, v) - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q)
    dqkv = torch.cat([t.transpose(1, 2) for t in (dq, dk, dv)], dim=-1)
    return dqkv.to(qkv.dtype)


def _launch_backward(qkv, o, lse, do, scale, causal):
    q, k, v = _split_e(qkv)
    _check_qkv(q, k, v, "flash_attention_e_bwd")
    b, h, s, d = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != (b, s, h, d) or t.dtype != qkv.dtype or \
                t.stride(-1) != 1 or t.device != qkv.device:
            raise ValueError(f"{name} must be {qkv.dtype} (b, s, h, d) = "
                             f"{(b, s, h, d)} with a unit stride on d, on "
                             f"{qkv.device}; got {t.dtype} "
                             f"{tuple(t.shape)}")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 or \
            not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 {(b, h, s)}")
    dqkv = torch.empty((b, s, h, 3 * d), dtype=qkv.dtype, device=qkv.device)
    dq, dk, dv = _split_e(dqkv)
    scratch = torch.empty((2, b, h, s), dtype=torch.float32,
                          device=qkv.device)
    strides = []
    for t in (q, k, v, o.transpose(1, 2), do.transpose(1, 2), dq, dk, dv):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    lib = _build.library("flash_attention_bwd")
    with torch.cuda.device(qkv.device):
        rc = lib.apex_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
            b, h, s, d, *strides, float(scale), int(bool(causal)),
            _build.dtype_code(qkv.dtype), _build.stream_ptr(qkv.device))
    _build.check("flash_attention_bwd", rc, "flash_attention_e_bwd kernel")
    bump("flash_attention_e_bwd")
    return dqkv


def flash_attention_e_backward(qkv: torch.Tensor, o: torch.Tensor,
                               lse: torch.Tensor, do: torch.Tensor,
                               scale: Optional[float] = None,
                               causal: bool = False) -> torch.Tensor:
    """dqkv (b, s, h, 3d) in qkv's layout and dtype, from the forward's
    o (b, s, h, d) and fp32 natural-log lse (b, h, s) and the output
    gradient do (b, s, h, d)."""
    if scale is None:
        scale = (qkv.shape[-1] // 3) ** -0.5
    if qkv.device.type == "cpu":
        return flash_attention_e_backward_reference(qkv, o, lse, do,
                                                    scale=scale,
                                                    causal=causal)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_e runs on cuda or cpu, not "
                         f"{qkv.device}")
    return _launch_backward(qkv, o, lse, do, scale, causal)


def _forward_e(qkv, scale, causal):
    """``(o (b, s, h, d), lse (b, h, s))`` of the E forward."""
    q, k, v = _split_e(qkv)
    if qkv.device.type == "cpu":
        o, lse = mha_reference(q, k, v, scale=scale, causal=causal,
                               return_lse=True)
    elif qkv.device.type == "cuda":
        o, lse = _launch(q, k, v, scale, causal,
                         counter="flash_attention_e")
    else:
        raise ValueError(f"flash_attention_e runs on cuda or cpu, not "
                         f"{qkv.device}")
    return o.transpose(1, 2), lse


def flash_attention_e_with_lse(qkv: torch.Tensor,
                               scale: Optional[float] = None,
                               causal: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The E forward without autograd: ``(o, lse)`` with o (b, s, h*d)
    and the fp32 natural-log lse (b, h, s)."""
    if scale is None:
        scale = (qkv.shape[-1] // 3) ** -0.5
    o, lse = _forward_e(qkv, scale, causal)
    return o.flatten(2), lse


class FlashAttentionEFunction(torch.autograd.Function):
    """Flash attention over the E layout under autograd (the JAX
    package's ``_flash_e_fused`` custom VJP): the forward saves qkv, o
    and the fp32 lse; the backward writes one dqkv in qkv's layout."""

    @staticmethod
    def forward(ctx, qkv, scale, causal):
        o, lse = _forward_e(qkv, scale, causal)
        ctx.save_for_backward(qkv, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o.flatten(2)

    @staticmethod
    def backward(ctx, dout):
        qkv, o, lse = ctx.saved_tensors
        do = dout.reshape(o.shape)
        if do.stride(-1) != 1:
            do = do.contiguous()
        dqkv = flash_attention_e_backward(qkv, o, lse, do, scale=ctx.scale,
                                          causal=ctx.causal)
        return dqkv, None, None


def flash_attention_e(qkv: torch.Tensor, scale: Optional[float] = None,
                      causal: bool = False) -> torch.Tensor:
    """Self-attention over the projection-native layout: ``qkv`` (b, s,
    h, 3*d), lanes [head][q|k|v] as ``proj(x).reshape(b, s, h, 3*d)``
    gives them, to the context (b, s, h*d) the output projection reads.
    Differentiable; the kernels on CUDA tensors, their plain versions on
    CPU tensors."""
    if scale is None:
        scale = (qkv.shape[-1] // 3) ** -0.5
    return FlashAttentionEFunction.apply(qkv, float(scale), bool(causal))
