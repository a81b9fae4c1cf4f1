"""Transformer building blocks: MLP, self-attention, layer, stack.

Port of ``apex_tpu/transformer/layers.py:57-318`` on one rank: the
pre-LN structure (LN -> attention -> residual -> LN -> MLP -> residual,
then a final LN) with the JAX modules' casts — each LayerNorm's output
cast to the compute ``dtype`` before the block it feeds, each block's
output cast back to the residual stream's dtype before the add.

* :class:`ParallelMLP`: ``dense_h_to_4h`` -> tanh GELU (``jax.nn.gelu``'s
  default) -> ``dense_4h_to_h``.
* :class:`ParallelSelfAttention`: the fused ``query_key_value``
  projection viewed as (b, s, h, 3d) straight into
  :func:`~apex_tpu_torch.ops.flash_attention_e` — no split, no transpose
  — then ``dense``.  Only that route is ported: ``use_flash=False`` and
  an explicit ``attention_mask`` need the scaled-softmax kernels (rows
  3-5 of the kernel table) and raise ``NotImplementedError``.

Submodule and parameter names mirror the flax tree
(``layer_{i}.self_attention.query_key_value.kernel``, ...).
``kernels=False`` routes LayerNorm and attention through their plain
versions under autograd (the oracle configuration).  Attention is
causal (the GPT mask type), the MLP 4x wide, and there is no dropout
(the JAX GPT train path runs with rate 0): padding masks, other widths
and dropout are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..normalization import FusedLayerNorm
from ..ops.flash_attention import (flash_attention_e,
                                   flash_attention_e_reference)
from .tensor_parallel import ColumnParallelLinear, RowParallelLinear

__all__ = ["ParallelMLP", "ParallelSelfAttention", "ParallelTransformerLayer",
           "ParallelTransformer"]


class ParallelMLP(nn.Module):
    """h -> ffn -> h (ref: ``apex_tpu/transformer/layers.py:57-80``)."""

    def __init__(self, hidden_size: int, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        ffn = 4 * hidden_size
        self.dense_h_to_4h = ColumnParallelLinear(hidden_size, ffn,
                                                  dtype=dtype, device=device)
        self.dense_4h_to_h = RowParallelLinear(ffn, hidden_size, dtype=dtype,
                                               device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.dense_h_to_4h(x), approximate="tanh")
        return self.dense_4h_to_h(h)


class ParallelSelfAttention(nn.Module):
    """Multi-head self-attention through the E-layout flash kernels
    (ref: ``apex_tpu/transformer/layers.py:83-200``)."""

    def __init__(self, hidden_size: int, num_attention_heads: int, *,
                 use_flash: bool = True, kernels: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if hidden_size % num_attention_heads:
            raise ValueError(f"hidden {hidden_size} not divisible by heads "
                             f"{num_attention_heads}")
        if not use_flash:
            raise NotImplementedError(
                "use_flash=False needs the scaled-softmax kernels (rows 3-5 "
                "of the kernel table: _causal_fwd, _softmax_backward, "
                "_masked_fwd), which are not ported yet")
        self.num_heads = num_attention_heads
        self.head_dim = hidden_size // num_attention_heads
        self.kernels = kernels
        self.query_key_value = ColumnParallelLinear(
            hidden_size, 3 * hidden_size, dtype=dtype, device=device)
        self.dense = RowParallelLinear(hidden_size, hidden_size, dtype=dtype,
                                       device=device)

    def forward(self, x: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if attention_mask is not None:
            raise NotImplementedError(
                "an explicit attention_mask takes the materializing softmax "
                "path (rows 3-5 of the kernel table), not ported yet")
        b, s, _ = x.shape
        qkv = self.query_key_value(x).view(b, s, self.num_heads,
                                           3 * self.head_dim)
        attn = flash_attention_e if self.kernels \
            else flash_attention_e_reference
        ctx = attn(qkv, scale=self.head_dim ** -0.5, causal=True)
        return self.dense(ctx)


class ParallelTransformerLayer(nn.Module):
    """Pre-LN transformer layer (ref:
    ``apex_tpu/transformer/layers.py:203-263``)."""

    def __init__(self, hidden_size: int, num_attention_heads: int, *,
                 use_flash: bool = True, layernorm_epsilon: float = 1e-5,
                 kernels: bool = True, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.input_layernorm = FusedLayerNorm(
            hidden_size, eps=layernorm_epsilon, kernels=kernels,
            device=device)
        self.self_attention = ParallelSelfAttention(
            hidden_size, num_attention_heads, use_flash=use_flash,
            kernels=kernels, dtype=dtype, device=device)
        self.post_attention_layernorm = FusedLayerNorm(
            hidden_size, eps=layernorm_epsilon, kernels=kernels,
            device=device)
        self.mlp = ParallelMLP(hidden_size, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        attn_out = self.self_attention(
            self.input_layernorm(x).to(self.dtype), attention_mask)
        x = x + attn_out.to(x.dtype)
        out = self.mlp(self.post_attention_layernorm(x).to(self.dtype))
        return x + out.to(x.dtype)


class ParallelTransformer(nn.Module):
    """``num_layers`` layers named ``layer_{i}``, then
    ``final_layernorm`` (ref: ``apex_tpu/transformer/layers.py:266-318``;
    activation checkpointing is not ported yet)."""

    def __init__(self, num_layers: int, hidden_size: int,
                 num_attention_heads: int, *, use_flash: bool = True,
                 layernorm_epsilon: float = 1e-5, kernels: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", ParallelTransformerLayer(
                hidden_size, num_attention_heads, use_flash=use_flash,
                layernorm_epsilon=layernorm_epsilon, kernels=kernels,
                dtype=dtype, device=device))
        self.final_layernorm = FusedLayerNorm(
            hidden_size, eps=layernorm_epsilon, kernels=kernels,
            device=device)

    def forward(self, x: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, attention_mask)
        return self.final_layernorm(x).to(self.dtype)
