"""Flash-attention forward: the CUDA kernel and its plain version.

Port of ``apex_tpu/ops/flash_attention.py``'s ``flash_attention``
(``_flash_fwd`` and its two Pallas bodies) for the (b, h, s, d) layout,
forward only, causal or full — no kv_mask, offsets or dropout in this
slice.  The JAX package packs d=64 head pairs onto 128 TPU lanes; that
is a lane-layout device of the TPU, so the port keeps heads unpacked
and matches the numerics, not the layout.

On a CUDA tensor :func:`flash_attention` launches
``csrc/flash_attention.cu`` or raises; on a CPU tensor it runs
:func:`mha_reference`.  The kernel reads q/k/v through their strides
(a unit stride on d is all it needs), so the serving model hands it
views of the fused QKV projection without copies, and it writes o
into a (b, s, h, d) buffer returned as a (b, h, s, d) view — the
layout the model's output projection reads.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import _build
from ._counts import bump

__all__ = ["flash_attention", "flash_attention_with_lse", "mha_reference"]

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


def _launch(q, k, v, scale, causal):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if q.dtype not in _TAKES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes q/k/v of one dtype "
                        f"in {_TAKES}, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim in "
                         f"{_HEAD_DIMS}, got {d}")
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention kernel needs a unit "
                             f"stride on {name}'s last dim")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if b * h > 65535:
        raise ValueError(f"b * h = {b * h} exceeds the kernel grid")
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
    _build.check("flash_attention", rc, "flash_attention kernel")
    bump("flash_attention")
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
