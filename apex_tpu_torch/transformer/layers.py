"""Transformer building blocks: MLP, self-attention, layer, stack.

Port of ``apex_tpu/transformer/layers.py:57-318`` on one rank: the
pre-LN structure (LN -> attention -> residual -> LN -> MLP -> residual,
then a final LN) with the JAX modules' casts — each LayerNorm's output
cast to the compute ``dtype`` before the block it feeds, each block's
output cast back to the residual stream's dtype before the add.

* :class:`ParallelMLP`: ``dense_h_to_4h`` -> tanh GELU (``jax.nn.gelu``'s
  default) -> ``dense_4h_to_h``.
* :class:`ParallelSelfAttention`: the fused ``query_key_value``
  projection viewed as (b, s, h, 3d), then ``dense``.  With
  ``use_flash`` (the default) the view goes straight into
  :func:`~apex_tpu_torch.ops.flash_attention_e` — no split, no
  transpose.  With ``use_flash=False`` the scores materialize, as in
  the JAX module's :148-197: q, k, v split and moved to (b, h, s, d),
  fp32 scores from the model-dtype q and k, the causal
  :class:`~apex_tpu_torch.transformer.functional.FusedScaleMaskSoftmax`
  (the scaled-softmax kernels, rows 3 and 4 of the kernel table, when
  the model dtype is fp16 or bf16), the probabilities cast to the model
  dtype and multiplied by v.  An explicit ``attention_mask`` needs the
  padding-mask kernel (row 5), not ported yet, and raises
  ``NotImplementedError``.

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
from .enums import AttnMaskType
from .functional import FusedScaleMaskSoftmax
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
    """Causal multi-head self-attention, through the E-layout flash
    kernels or, with ``use_flash=False``, the materialized scores and
    the fused softmax (ref: ``apex_tpu/transformer/layers.py:83-200``)."""

    def __init__(self, hidden_size: int, num_attention_heads: int, *,
                 use_flash: bool = True, kernels: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if hidden_size % num_attention_heads:
            raise ValueError(f"hidden {hidden_size} not divisible by heads "
                             f"{num_attention_heads}")
        self.num_heads = num_attention_heads
        self.head_dim = hidden_size // num_attention_heads
        self.use_flash = use_flash
        self.kernels = kernels
        self.dtype = dtype
        self.query_key_value = ColumnParallelLinear(
            hidden_size, 3 * hidden_size, dtype=dtype, device=device)
        self.dense = RowParallelLinear(hidden_size, hidden_size, dtype=dtype,
                                       device=device)

    def forward(self, x: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if attention_mask is not None:
            raise NotImplementedError(
                "an explicit attention_mask takes the padding-mask softmax, "
                "`_masked_fwd` (row 5 of the kernel table), not ported yet")
        b, s, _ = x.shape
        h, d = self.num_heads, self.head_dim
        qkv = self.query_key_value(x).view(b, s, h, 3 * d)
        scale = d ** -0.5
        if self.use_flash:
            attn = flash_attention_e if self.kernels \
                else flash_attention_e_reference
            return self.dense(attn(qkv, scale=scale, causal=True))
        q, k, v = (t.transpose(1, 2) for t in qkv.split(d, dim=-1))
        # fp32 scores from the model-dtype q and k: the product of two
        # fp16 or bf16 values is exact in fp32, so an fp32 GEMM (TF32
        # off) gives the JAX einsum's preferred_element_type=float32
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        softmax = FusedScaleMaskSoftmax(
            input_in_fp16=self.dtype == torch.float16,
            input_in_bf16=self.dtype == torch.bfloat16,
            attn_mask_type=AttnMaskType.causal,
            scaled_masked_softmax_fusion=True, mask_func=None,
            softmax_in_fp32=True, scale=scale, kernels=self.kernels)
        probs = softmax(scores, None)
        ctx = torch.matmul(probs.to(self.dtype), v)
        return self.dense(ctx.transpose(1, 2).reshape(b, s, h * d))


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
