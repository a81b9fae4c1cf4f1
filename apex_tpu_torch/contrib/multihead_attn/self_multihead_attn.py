"""``SelfMultiheadAttn``: the fused self-attention module.

Port of ``apex_tpu/contrib/multihead_attn/self_multihead_attn.py``: the
packed 3E in-projection (or ``separate_qkv_params``, interleaved per head
into the packed layout), optional biases, a byte key-padding mask, an
additive mask (``mask_additive``) or a time (causal) mask, attention
dropout, and ``include_norm_add`` (pre-LayerNorm, then hidden dropout and
the residual add).  ``impl="fast"`` routes the core through the flash
kernels; ``impl="default"`` through the materialized scores and the
softmax kernels.  Inputs are (time, batch, embed).  Parameters are
created in ``dtype`` (the LayerNorm's fp32), named as the flax module's
(:func:`multihead_params_from_numpy` carries them across).
``kernels=False`` runs every kernel's plain version (the oracle
configuration).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...normalization import FusedLayerNorm
from ...transformer.layers import DropoutRNG, dropout, dropout_rng
from .functional import attn_core_qkv

__all__ = ["SelfMultiheadAttn"]


def _xavier(shape, gain: float, dtype, device) -> nn.Parameter:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.xavier_uniform_(w, gain=gain)
    return nn.Parameter(w.to(dtype))


def _zeros(n: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n, dtype=dtype, device=device))


class SelfMultiheadAttn(nn.Module):
    """ref: apex/contrib/multihead_attn/self_multihead_attn.py:31."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 impl: str = "fast", separate_qkv_params: bool = False,
                 mask_additive: bool = False, *,
                 dtype: torch.dtype = torch.float32, kernels: bool = True,
                 device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        if impl not in ("fast", "default"):
            raise ValueError(f"Unsupported impl: {impl} !")
        if mask_additive and include_norm_add:
            raise ValueError("additive mask not supported with layer norm")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout, self.bias = dropout, bias
        self.include_norm_add, self.impl = include_norm_add, impl
        self.separate_qkv_params = separate_qkv_params
        self.mask_additive, self.kernels = mask_additive, kernels
        e = embed_dim
        # the packed [3E, E] weight is initialized like an [E, E] one:
        # xavier with gain sqrt(2) (ref :100-108)
        if separate_qkv_params:
            for name in ("q_weight", "k_weight", "v_weight"):
                setattr(self, name, _xavier((e, e), 1.0, dtype, device))
        else:
            self.in_proj_weight = _xavier((3 * e, e), math.sqrt(2.0), dtype,
                                          device)
        self.out_proj_weight = _xavier((e, e), 1.0, dtype, device)
        if bias:
            if separate_qkv_params:
                for name in ("q_bias", "k_bias", "v_bias"):
                    setattr(self, name, _zeros(e, dtype, device))
            else:
                self.in_proj_bias = _zeros(3 * e, dtype, device)
            self.out_proj_bias = _zeros(e, dtype, device)
        if include_norm_add:
            self.lyr_nrm = FusedLayerNorm(e, kernels=kernels, device=device)

    def _qkv_weights(self):
        """The packed weight and bias; separate parameters interleaved per
        head as the reference packs them (ref :133-141)."""
        if not self.separate_qkv_params:
            return self.in_proj_weight, \
                self.in_proj_bias if self.bias else None
        e, h = self.embed_dim, self.num_heads
        d = e // h
        w = torch.stack([t.reshape(h, d, e) for t in (
            self.q_weight, self.k_weight, self.v_weight)], 1)
        b = None
        if self.bias:
            b = torch.stack([t.reshape(h, d) for t in (
                self.q_bias, self.k_bias, self.v_bias)], 1).reshape(3 * e)
        return w.reshape(3 * e, e), b

    def forward(self, query: torch.Tensor, key=None, value=None,
                key_padding_mask: Optional[torch.Tensor] = None,
                need_weights: bool = False,
                attn_mask: Optional[torch.Tensor] = None,
                is_training: Optional[bool] = None,
                rng: Optional[DropoutRNG] = None):
        """ref :124-178.  ``query`` (time, batch, embed); ``key`` and
        ``value`` are taken for the signature only.  ``key_padding_mask``
        (batch, src_len), 1 = padding (or additive with ``mask_additive``);
        ``attn_mask`` the time mask.  ``is_training`` defaults to the
        module's mode; dropout draws from ``rng``.  Returns ``(output,
        None)``."""
        del key, value, need_weights
        if key_padding_mask is not None and attn_mask is not None:
            raise ValueError("attn_mask and key_padding_mask should not be "
                             "both defined!")
        if attn_mask is not None and self.mask_additive:
            raise ValueError("additive mask not supported for time mask")
        if is_training is None:
            is_training = self.training
        rng = dropout_rng(not is_training, (self.dropout,), rng)
        sq, b, e = query.shape
        h = self.num_heads
        d = e // h
        residual = query
        x = self.lyr_nrm(query) if self.include_norm_add else query
        w, bias = self._qkv_weights()
        qkv = x @ w.t()
        if bias is not None:
            qkv = qkv + bias
        qkv = qkv.reshape(sq, b, h, 3, d)
        mask, use_time_mask = None, False
        if key_padding_mask is not None:
            mask = key_padding_mask[:, None, None, :]
        elif attn_mask is not None:
            mask, use_time_mask = attn_mask, True
        ctx = attn_core_qkv(qkv, d ** -0.5, mask=mask,
                            mask_additive=self.mask_additive,
                            use_time_mask=use_time_mask,
                            dropout_prob=self.dropout, rng=rng,
                            is_training=is_training,
                            use_fast=self.impl == "fast",
                            kernels=self.kernels)
        out = ctx @ self.out_proj_weight.t()
        if self.bias:
            out = out + self.out_proj_bias
        if self.include_norm_add:
            # hidden dropout and the residual add (ref jit_dropout_add)
            out = residual + dropout(out, self.dropout, rng)
        return out, None
