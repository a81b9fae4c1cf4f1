"""``EncdecMultiheadAttn``: the fused encoder-decoder attention module.

Port of ``apex_tpu/contrib/multihead_attn/encdec_multihead_attn.py``: a
Q projection of the decoder's query and a packed 2E KV projection of the
encoder's output, a byte key-padding or time mask, attention dropout,
and ``include_norm_add`` (pre-LayerNorm on the query, hidden dropout and
the residual add).  A key-padding mask with ``impl="fast"`` and no
attention dropout rides the (b, h, s, d) flash kernels' kv_mask lane
(rows 6 and 8) at tq != tk.  Inputs are (time, batch, embed); parameters
as :class:`~apex_tpu_torch.contrib.multihead_attn.SelfMultiheadAttn`'s.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...normalization import FusedLayerNorm
from ...transformer.layers import DropoutRNG, dropout, dropout_rng
from .functional import attn_core
from .self_multihead_attn import _xavier, _zeros

__all__ = ["EncdecMultiheadAttn"]


class EncdecMultiheadAttn(nn.Module):
    """ref: apex/contrib/multihead_attn/encdec_multihead_attn.py:31."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 impl: str = "fast", *, dtype: torch.dtype = torch.float32,
                 kernels: bool = True, device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        if impl not in ("fast", "default"):
            raise ValueError(f"Unsupported impl: {impl} !")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout, self.bias = dropout, bias
        self.include_norm_add, self.impl = include_norm_add, impl
        self.kernels = kernels
        e = embed_dim
        self.in_proj_weight_q = _xavier((e, e), 1.0, dtype, device)
        # [2E, E] initialized like [E, E]: xavier gain sqrt(1.5) (ref :81-86)
        self.in_proj_weight_kv = _xavier((2 * e, e), math.sqrt(1.5), dtype,
                                         device)
        self.out_proj_weight = _xavier((e, e), 1.0, dtype, device)
        if bias:
            self.in_proj_bias_q = _zeros(e, dtype, device)
            self.in_proj_bias_kv = _zeros(2 * e, dtype, device)
            self.out_proj_bias = _zeros(e, dtype, device)
        if include_norm_add:
            self.lyr_nrm = FusedLayerNorm(e, kernels=kernels, device=device)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value=None,
                key_padding_mask: Optional[torch.Tensor] = None,
                need_weights: bool = False,
                attn_mask: Optional[torch.Tensor] = None,
                is_training: Optional[bool] = None,
                rng: Optional[DropoutRNG] = None):
        """ref :98-160.  ``query`` (tq, batch, embed) from the decoder,
        ``key`` (tk, batch, embed) from the encoder (``value`` must be
        None or ``key``: one fused KV projection).  Returns ``(output,
        None)``."""
        del need_weights
        if value is not None and value is not key:
            raise ValueError("encdec attention requires value is key (fused "
                             "KV projection)")
        if key_padding_mask is not None and attn_mask is not None:
            raise ValueError("attn_mask and key_padding_mask should not be "
                             "both defined!")
        if is_training is None:
            is_training = self.training
        rng = dropout_rng(not is_training, (self.dropout,), rng)
        sq, b, e = query.shape
        sk = key.shape[0]
        h = self.num_heads
        d = e // h
        residual = query
        x_q = self.lyr_nrm(query) if self.include_norm_add else query
        q = x_q @ self.in_proj_weight_q.t()
        kv = key @ self.in_proj_weight_kv.t()
        if self.bias:
            q = q + self.in_proj_bias_q
            kv = kv + self.in_proj_bias_kv
        # kv packed per head as (sk, b, h, 2, d), as the reference slices it
        kv = kv.reshape(sk, b, h, 2, d)
        q = q.reshape(sq, b, h, d).permute(1, 2, 0, 3)
        k, v = (kv[:, :, :, i].permute(1, 2, 0, 3) for i in range(2))
        mask, use_time_mask = None, False
        if key_padding_mask is not None:
            mask = key_padding_mask[:, None, None, :]
        elif attn_mask is not None:
            mask, use_time_mask = attn_mask, True
        ctx = attn_core(q, k, v, d ** -0.5, mask=mask,
                        use_time_mask=use_time_mask,
                        dropout_prob=self.dropout, rng=rng,
                        is_training=is_training,
                        use_fast=self.impl == "fast", kernels=self.kernels)
        out = ctx.permute(2, 0, 1, 3).reshape(sq, b, e) \
            @ self.out_proj_weight.t()
        if self.bias:
            out = out + self.out_proj_bias
        if self.include_norm_add:
            out = residual + dropout(out, self.dropout, rng)
        return out, None
