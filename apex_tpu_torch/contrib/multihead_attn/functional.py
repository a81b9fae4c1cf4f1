"""Functional attention cores of the MHA module family.

Port of ``apex_tpu/contrib/multihead_attn/functional.py``: the same
routing (:func:`_flash_route`) over the port's kernels.

* :func:`attn_core` (b, h, s, d): no mask or the causal time mask, no
  dropout -> :func:`~apex_tpu_torch.ops.flash_attention`; a key-padding
  byte mask, no dropout -> its kv_mask lane (rows 6 and 8); otherwise the
  scores in the model dtype through the causal softmax (rows 3 and 4) or
  the padding-mask softmax (rows 5 and 4), or an fp32 softmax under an
  additive mask, then dropout on the probabilities and the product
  with v.
* :func:`attn_core_qkv` (sq, b, h, 3, d), the self-attention module's
  packed projection: the flash-eligible cases (no mask, causal, key
  padding; attention dropout included, inside the kernels) go to
  :func:`~apex_tpu_torch.ops.flash_attention_e` after one (sq, b) ->
  (b, sq) relayout; the rest split and take :func:`attn_core`.

Dropout: the flash route's in-kernel dropout draws JAX's counter hash
from an int seed, so the same seed gives JAX's keep bits exactly (drawn
from ``rng``, a :class:`~apex_tpu_torch.transformer.layers.DropoutRNG`,
on the host).  The other
routes draw a Bernoulli mask from ``rng``'s device generator where JAX
calls ``jax.random.bernoulli``: a departure, since no torch generator
gives JAX's threefry bits; the masks share only their law.

``kernels=False`` runs every route through the plain versions under
autograd (the oracle configuration).
"""
from __future__ import annotations

from typing import Optional

import torch

from ...ops.flash_attention import (e_mode, flash_attention,
                                    flash_attention_e,
                                    flash_attention_e_reference,
                                    mha_reference)
from ...ops.scaled_softmax import (scaled_masked_softmax,
                                   scaled_upper_triang_masked_softmax)
from ...transformer.layers import DropoutRNG

__all__ = ["NEG_INF", "attn_core", "attn_core_qkv", "mask_softmax_dropout"]

NEG_INF = -10000.0  # the reference's masked-fill value

# id-keyed memo of the causal check (a caller passes the same mask object
# every step; spare a device read a call); the mask is kept in the value
# so its id cannot be recycled
_CAUSAL_MEMO: dict = {}


def _is_causal_mask(mask: torch.Tensor, sq: int, sk: int) -> bool:
    """True iff ``mask`` is the strict-upper-triangle boolean mask (True
    = masked), the only time mask the causal kernels may take."""
    key = (id(mask), sq, sk)
    hit = _CAUSAL_MEMO.get(key)
    if hit is not None and hit[0] is mask:
        return hit[1]
    result = tuple(mask.shape[-2:]) == (sq, sk) and bool(
        (mask.bool() == ~torch.ones(sq, sk, dtype=torch.bool,
                                    device=mask.device).tril()).all())
    if len(_CAUSAL_MEMO) >= 1024:
        _CAUSAL_MEMO.clear()
    _CAUSAL_MEMO[key] = (mask, result)
    return result


def _drop_probs(probs, dropout_prob: float, rng: Optional[DropoutRNG]):
    """JAX's ``where(keep, probs / (1 - p), 0)`` with a Bernoulli keep mask
    from ``rng``'s device generator."""
    if rng is None:
        raise ValueError("attention dropout requires rng (a DropoutRNG)")
    return torch.where(rng.keep(probs.shape, dropout_prob),
                       probs / (1.0 - dropout_prob), 0.0)


def mask_softmax_dropout(inputs: torch.Tensor,
                         pad_mask: Optional[torch.Tensor] = None,
                         mask_additive: bool = False,
                         dropout_prob: float = 0.0,
                         rng: Optional[DropoutRNG] = None,
                         is_training: bool = True,
                         heads: Optional[int] = None) -> torch.Tensor:
    """Softmax (+ mask) + dropout over (..., sq, sk) scores, in fp32, the
    probabilities in the scores' dtype.  ``pad_mask``: boolean, nonzero =
    masked (filled with -10000), broadcastable to the scores, or an
    additive float mask when ``mask_additive``.  ``heads`` is taken for
    the reference's signature only."""
    del heads
    x = inputs.float()
    if pad_mask is not None:
        if mask_additive:
            x = x + pad_mask.float()
        else:
            x = x.masked_fill(pad_mask.bool(), NEG_INF)
    probs = torch.softmax(x, dim=-1).to(inputs.dtype)
    if dropout_prob > 0.0 and is_training:
        probs = _drop_probs(probs, dropout_prob, rng)
    return probs


def _flash_route(mask, mask_additive, use_time_mask, mask_is_causal, b, sq,
                 sk):
    """``(causal, kpm)``: ``causal`` when the time mask is the strict
    upper triangle (or asserted by ``mask_is_causal``), ``kpm`` the (b,
    sk) key-padding byte mask (1 = masked out) when the mask is (b, sk)
    or the modules' (b, 1, 1, sk).  One rule for both cores."""
    if mask_is_causal is None:
        mask_is_causal = mask is not None and _is_causal_mask(mask, sq, sk)
    causal = (use_time_mask and mask is not None and not mask_additive
              and mask_is_causal)
    kpm = None
    if mask is not None and not mask_additive and not use_time_mask:
        if mask.dim() == 2 and tuple(mask.shape) == (b, sk):
            kpm = mask
        elif mask.dim() == 4 and tuple(mask.shape) == (b, 1, 1, sk):
            kpm = mask[:, 0, 0, :]
    return causal, kpm


def _attended(kpm: torch.Tensor) -> torch.Tensor:
    """The kernels' kv_mask (a key attended where > 0) from a byte mask
    (nonzero = masked out): contiguous fp32, the kernels' format."""
    return (kpm == 0).float()


def attn_core_qkv(qkv: torch.Tensor, scaling: float,
                  mask: Optional[torch.Tensor] = None,
                  mask_additive: bool = False, use_time_mask: bool = False,
                  dropout_prob: float = 0.0,
                  rng: Optional[DropoutRNG] = None,
                  is_training: bool = True, use_fast: bool = True,
                  mask_is_causal: Optional[bool] = None,
                  kernels: bool = True) -> torch.Tensor:
    """:func:`attn_core` over the packed projection ``qkv`` (sq, b, h, 3,
    d), q/k/v interleaved per head, to (sq, b, h*d).  The flash-eligible
    cases ride the E kernels with their in-kernel dropout (a seed drawn
    from ``rng``); the others split and delegate to :func:`attn_core`."""
    sq, b, h, _, d = qkv.shape
    dropping = dropout_prob > 0.0 and is_training
    causal, kpm = _flash_route(mask, mask_additive, use_time_mask,
                               mask_is_causal, b, sq, sq)
    if use_fast and (mask is None or causal or kpm is not None) \
            and e_mode(sq, h, d) != "fallback":
        qkv_e = qkv.reshape(sq, b, h * 3 * d).transpose(0, 1) \
            .reshape(b, sq, h, 3 * d)
        drop = {}
        if dropping:
            if rng is None:
                raise ValueError("attention dropout requires rng (a "
                                 "DropoutRNG)")
            drop = dict(dropout_rate=dropout_prob, dropout_seed=rng.seed())
        attn = flash_attention_e if kernels else flash_attention_e_reference
        ctx = attn(qkv_e, scale=scaling, causal=causal,
                   kv_mask=None if kpm is None else _attended(kpm), **drop)
        return ctx.transpose(0, 1)
    q, k, v = (qkv[:, :, :, i].permute(1, 2, 0, 3) for i in range(3))
    ctx = attn_core(q, k, v, scaling, mask=mask, mask_additive=mask_additive,
                    use_time_mask=use_time_mask, dropout_prob=dropout_prob,
                    rng=rng, is_training=is_training, use_fast=use_fast,
                    mask_is_causal=mask_is_causal, kernels=kernels)
    return ctx.permute(2, 0, 1, 3).reshape(sq, b, h * d)


def attn_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scaling: float, mask: Optional[torch.Tensor] = None,
              mask_additive: bool = False, use_time_mask: bool = False,
              dropout_prob: float = 0.0, rng: Optional[DropoutRNG] = None,
              is_training: bool = True, use_fast: bool = True,
              mask_is_causal: Optional[bool] = None,
              kernels: bool = True) -> torch.Tensor:
    """softmax(scaling * q k^T [masked]) v with attention dropout, over
    (b, h, s, d), routed as the JAX core routes: flash attention (its
    kv_mask lane for a key-padding mask) when no dropout runs, else the
    materialized scores through the causal or padding-mask softmax, or
    an fp32 softmax under an additive mask.  A degenerate all-padding
    row gives zeros on the flash route and the uniform mean of v on the
    others, as in JAX."""
    dropping = dropout_prob > 0.0 and is_training
    sq, sk = q.shape[-2], k.shape[-2]
    causal, kpm = _flash_route(mask, mask_additive, use_time_mask,
                               mask_is_causal, q.shape[0], sq, sk)
    if use_fast and not dropping and (mask is None or causal
                                      or kpm is not None):
        kv_mask = None if kpm is None else _attended(kpm)
        if not kernels:
            return mha_reference(q, k, v, scale=scaling, causal=causal,
                                 kv_mask=kv_mask)
        return flash_attention(q, k, v, scale=scaling, causal=causal,
                               kv_mask=kv_mask)
    scores = torch.matmul(q, k.transpose(-1, -2))
    if causal:
        probs = scaled_upper_triang_masked_softmax(scores, scaling,
                                                   kernels=kernels)
    elif mask is not None and not mask_additive:
        # boolean, 1 = masked out, to the (b, 1, sq, sk) the kernel reads
        b = scores.shape[0]
        m = mask.bool()
        while m.dim() < 4:
            m = m[:, None] if m.dim() >= 2 and m.shape[0] == b else m[None]
        probs = scaled_masked_softmax(scores, m.expand(b, 1, sq, sk),
                                      scaling, kernels=kernels)
    else:
        x = scores.float() * scaling
        if mask is not None:  # additive
            x = x + mask.float()
        probs = torch.softmax(x, dim=-1).to(scores.dtype)
    if dropping:
        probs = _drop_probs(probs, dropout_prob, rng)
    return torch.matmul(probs, v)
