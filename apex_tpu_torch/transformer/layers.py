"""Transformer building blocks: MLP, self-attention, layer, stack.

Port of ``apex_tpu/transformer/layers.py:57-318`` on one rank: the
pre-LN structure (LN -> attention -> residual -> LN -> MLP -> residual,
then a final LN) with the JAX modules' casts — each LayerNorm's output
cast to the compute ``dtype`` before the block it feeds, each block's
output cast back to the residual stream's dtype before the add.

* :class:`ParallelMLP`: ``dense_h_to_4h`` -> the activation (tanh GELU,
  ``jax.nn.gelu``'s default, unless another is given) ->
  ``dense_4h_to_h``, ``ffn_hidden_size`` wide (4h by default).
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
  dtype and multiplied by v.

Masks, as the JAX module takes them (``:100-168``): ``attn_mask_type``
causal (GPT) or padding (BERT) on the attention, the layer and the
stack; a (b, s) ``key_padding_mask`` (a key attended where it is
nonzero) rides the flash kernels' kv_mask lane (rows 10 and 12) with
``use_flash``, and on the materialized route is folded, with the
triangle for a causal model, into one (b, 1, s, s) padding mask; an
explicit (b, 1, sq, sk) ``attention_mask`` (True = masked) always takes
the materialized route, through the padding-mask softmax (row 5).
Passing both masks raises ``ValueError``.

Dropout, as the JAX modules apply it (``:97-233``), in a forward called
with ``deterministic=False`` and a :class:`DropoutRNG`: attention
dropout (``attention_dropout``) inside the E flash kernels on the flash
route, from one host-drawn seed a layer a call (JAX's
``dropout_seed_from_key``), and on the materialized route on the
probabilities, ``where(keep, probs / (1 - rate), 0)``; hidden dropout
(``hidden_dropout``) on the attention's and the MLP's outputs before
each residual add, in their dtype.  Those Bernoulli masks come from
:func:`dropout_mask` on the RNG's device generator: they cannot match
JAX's threefry bits, only their law.  The rates default to JAX's 0.1;
``deterministic=True`` (the default) runs none.

Activation checkpointing (:class:`ParallelTransformer`'s
``checkpoint_activations``, JAX's ``:266-318``) wraps each layer in
:func:`~apex_tpu_torch.transformer.tensor_parallel.random.checkpoint`
under ``checkpoint_policy``, which replays both of the
:class:`DropoutRNG`'s generators in the recompute: the checkpointed step
computes the uncheckpointed one's bits.

Submodule and parameter names mirror the flax tree
(``layer_{i}.self_attention.query_key_value.kernel``, ...), with or
without checkpointing.  ``kernels=False`` routes LayerNorm and attention
through their plain versions under autograd (the oracle configuration).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..normalization import FusedLayerNorm
from ..ops.flash_attention import (dropout_seed, flash_attention_e,
                                   flash_attention_e_reference)
from .enums import AttnMaskType
from .functional import FusedScaleMaskSoftmax
from .tensor_parallel import ColumnParallelLinear, RowParallelLinear
from .tensor_parallel.random import (check_policy, checkpoint,
                                     ffn_wide_recompute)

__all__ = ["ParallelMLP", "ParallelSelfAttention", "ParallelTransformerLayer",
           "ParallelTransformer", "DropoutRNG", "dropout_mask", "dropout",
           "dropout_rng"]


def dropout_mask(shape, rate: float, generator: torch.Generator
                 ) -> torch.Tensor:
    """The Bernoulli keep mask of the hidden, embedding and materialized
    attention dropout: bool ``shape``, True with probability 1 - ``rate``,
    drawn on the ``generator``'s device."""
    return torch.rand(shape, generator=generator,
                      device=generator.device) >= rate


class DropoutRNG:
    """The random state of dropout in a train step (JAX's ``"dropout"``
    rng stream): a CPU generator for the E kernels' seeds, one a layer a
    call drawn on the host (:func:`~apex_tpu_torch.ops.dropout_seed`), and
    a generator on ``device`` for the Bernoulli masks
    (:func:`dropout_mask`).  Both seeded from ``seed``."""

    def __init__(self, seed: int, device=None):
        self.seeds = torch.Generator().manual_seed(int(seed))
        self.masks = torch.Generator(device=device or "cpu")
        self.masks.manual_seed(int(seed))

    def seed(self) -> int:
        return dropout_seed(self.seeds)

    def keep(self, shape, rate: float) -> torch.Tensor:
        return dropout_mask(shape, rate, self.masks)


def dropout(x: torch.Tensor, rate: float, rng: Optional[DropoutRNG]
            ) -> torch.Tensor:
    """JAX's ``where(keep, x / (1 - rate), 0)`` in x's dtype (``1 - rate``
    rounded to that dtype first, as a weakly typed JAX scalar is);
    ``rng`` None or rate 0: x itself."""
    if rng is None or rate == 0.0:
        return x
    c = float(torch.tensor(1.0 - rate, dtype=x.dtype))
    return torch.where(rng.keep(x.shape, rate), x / c, 0.0)


def dropout_rng(deterministic: bool, rates, rng) -> Optional[DropoutRNG]:
    """The RNG a forward with dropout ``rates`` draws from, or None when
    it runs no dropout; raises when dropout is on and no RNG was given."""
    if deterministic or not any(r > 0.0 for r in rates):
        return None
    if rng is None:
        raise ValueError("a forward with deterministic=False and a dropout "
                         "rate > 0 needs rng (a DropoutRNG)")
    return rng


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU, ``jax.nn.gelu``'s default form."""
    return F.gelu(x, approximate="tanh")


class ParallelMLP(nn.Module):
    """h -> ffn -> h (ref: ``apex_tpu/transformer/layers.py:57-80``):
    ``ffn_hidden_size`` wide (None: 4h), ``activation`` between (tanh
    GELU by default).  Inside a layer checkpointed under
    ``all_but_ffn_wide`` the body is checkpointed whole, so its two
    ffn-wide intermediates are recomputed, not kept."""

    def __init__(self, hidden_size: int,
                 ffn_hidden_size: Optional[int] = None,
                 activation: Callable = gelu_tanh, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        ffn = ffn_hidden_size or 4 * hidden_size
        self.activation = activation
        self.dense_h_to_4h = ColumnParallelLinear(hidden_size, ffn,
                                                  dtype=dtype, device=device)
        self.dense_4h_to_h = RowParallelLinear(ffn, hidden_size, dtype=dtype,
                                               device=device)

    def _body(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense_4h_to_h(self.activation(self.dense_h_to_4h(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if ffn_wide_recompute() and torch.is_grad_enabled():
            # the input the one tensor kept; the body draws no randomness
            return torch.utils.checkpoint.checkpoint(self._body, x,
                                                     use_reentrant=False)
        return self._body(x)


class ParallelSelfAttention(nn.Module):
    """Multi-head self-attention, through the E-layout flash kernels or,
    with ``use_flash=False`` or an explicit ``attention_mask``, the
    materialized scores and the fused softmax (ref:
    ``apex_tpu/transformer/layers.py:83-200``)."""

    def __init__(self, hidden_size: int, num_attention_heads: int, *,
                 attn_mask_type: AttnMaskType = AttnMaskType.causal,
                 attention_dropout: float = 0.1,
                 use_flash: bool = True, kernels: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if hidden_size % num_attention_heads:
            raise ValueError(f"hidden {hidden_size} not divisible by heads "
                             f"{num_attention_heads}")
        self.num_heads = num_attention_heads
        self.head_dim = hidden_size // num_attention_heads
        self.attn_mask_type = attn_mask_type
        self.attention_dropout = attention_dropout
        self.use_flash = use_flash
        self.kernels = kernels
        self.dtype = dtype
        self.query_key_value = ColumnParallelLinear(
            hidden_size, 3 * hidden_size, dtype=dtype, device=device)
        self.dense = RowParallelLinear(hidden_size, hidden_size, dtype=dtype,
                                       device=device)

    def forward(self, x: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        if key_padding_mask is not None and attention_mask is not None:
            raise ValueError(
                "pass either attention_mask or key_padding_mask, not both "
                "(fold padding into the attention_mask yourself)")
        rng = dropout_rng(deterministic, (self.attention_dropout,), rng)
        b, s, _ = x.shape
        h, d = self.num_heads, self.head_dim
        qkv = self.query_key_value(x).view(b, s, h, 3 * d)
        scale = d ** -0.5
        causal = self.attn_mask_type == AttnMaskType.causal
        if self.use_flash and attention_mask is None:
            attn = flash_attention_e if self.kernels \
                else flash_attention_e_reference
            drop = {} if rng is None else dict(
                dropout_rate=self.attention_dropout, dropout_seed=rng.seed())
            return self.dense(attn(qkv, scale=scale, causal=causal,
                                   kv_mask=key_padding_mask, **drop))
        mask_type = self.attn_mask_type
        if key_padding_mask is not None:
            # the padding keys (and a causal model's triangle, which the
            # causal softmax would not read from a mask) as one padding
            # mask, True = masked
            sk = key_padding_mask.shape[-1]
            kmask = ~key_padding_mask.bool()[:, None, None, :]
            if causal:
                kmask = kmask | ~torch.ones(s, sk, dtype=torch.bool,
                                            device=x.device).tril()
            attention_mask = kmask.expand(b, 1, s, sk)
            mask_type = AttnMaskType.padding
        q, k, v = (t.transpose(1, 2) for t in qkv.split(d, dim=-1))
        # fp32 scores from the model-dtype q and k: the product of two
        # fp16 or bf16 values is exact in fp32, so an fp32 GEMM (TF32
        # off) gives the JAX einsum's preferred_element_type=float32
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        softmax = FusedScaleMaskSoftmax(
            input_in_fp16=self.dtype == torch.float16,
            input_in_bf16=self.dtype == torch.bfloat16,
            attn_mask_type=mask_type,
            scaled_masked_softmax_fusion=True, mask_func=None,
            softmax_in_fp32=True, scale=scale, kernels=self.kernels)
        probs = dropout(softmax(scores, attention_mask),
                        self.attention_dropout, rng)
        ctx = torch.matmul(probs.to(self.dtype), v)
        return self.dense(ctx.transpose(1, 2).reshape(b, s, h * d))


class ParallelTransformerLayer(nn.Module):
    """Pre-LN transformer layer (ref:
    ``apex_tpu/transformer/layers.py:203-263``)."""

    def __init__(self, hidden_size: int, num_attention_heads: int, *,
                 ffn_hidden_size: Optional[int] = None,
                 attn_mask_type: AttnMaskType = AttnMaskType.causal,
                 attention_dropout: float = 0.1, hidden_dropout: float = 0.1,
                 use_flash: bool = True, layernorm_epsilon: float = 1e-5,
                 kernels: bool = True, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.hidden_dropout = hidden_dropout
        self.input_layernorm = FusedLayerNorm(
            hidden_size, eps=layernorm_epsilon, kernels=kernels,
            device=device)
        self.self_attention = ParallelSelfAttention(
            hidden_size, num_attention_heads, attn_mask_type=attn_mask_type,
            attention_dropout=attention_dropout, use_flash=use_flash,
            kernels=kernels, dtype=dtype, device=device)
        self.post_attention_layernorm = FusedLayerNorm(
            hidden_size, eps=layernorm_epsilon, kernels=kernels,
            device=device)
        self.mlp = ParallelMLP(hidden_size, ffn_hidden_size, dtype=dtype,
                               device=device)

    def forward(self, x: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        rng = dropout_rng(deterministic, (self.self_attention.attention_dropout,
                                      self.hidden_dropout), rng)
        attn_out = self.self_attention(
            self.input_layernorm(x).to(self.dtype), attention_mask,
            key_padding_mask, rng is None, rng)
        x = x + dropout(attn_out, self.hidden_dropout, rng).to(x.dtype)
        out = self.mlp(self.post_attention_layernorm(x).to(self.dtype))
        return x + dropout(out, self.hidden_dropout, rng).to(x.dtype)


class ParallelTransformer(nn.Module):
    """``num_layers`` layers named ``layer_{i}``, then
    ``final_layernorm`` (ref: ``apex_tpu/transformer/layers.py:266-318``).
    ``checkpoint_activations`` runs each layer under
    :func:`~apex_tpu_torch.transformer.tensor_parallel.random.checkpoint`
    with ``checkpoint_policy`` (a key of ``CHECKPOINT_POLICIES``; an
    unknown one raises ``ValueError``) while gradients are recorded."""

    def __init__(self, num_layers: int, hidden_size: int,
                 num_attention_heads: int, *,
                 ffn_hidden_size: Optional[int] = None,
                 attn_mask_type: AttnMaskType = AttnMaskType.causal,
                 attention_dropout: float = 0.1, hidden_dropout: float = 0.1,
                 use_flash: bool = True,
                 checkpoint_activations: bool = False,
                 checkpoint_policy: str = "full",
                 layernorm_epsilon: float = 1e-5,
                 kernels: bool = True, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.num_layers = num_layers
        self.checkpoint_activations = checkpoint_activations
        self.checkpoint_policy = check_policy(checkpoint_policy)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", ParallelTransformerLayer(
                hidden_size, num_attention_heads,
                ffn_hidden_size=ffn_hidden_size,
                attn_mask_type=attn_mask_type,
                attention_dropout=attention_dropout,
                hidden_dropout=hidden_dropout, use_flash=use_flash,
                layernorm_epsilon=layernorm_epsilon, kernels=kernels,
                dtype=dtype, device=device))
        self.final_layernorm = FusedLayerNorm(
            hidden_size, eps=layernorm_epsilon, kernels=kernels,
            device=device)

    def forward(self, x: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        ckpt = self.checkpoint_activations and torch.is_grad_enabled()
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            args = (x, attention_mask, key_padding_mask, deterministic, rng)
            x = checkpoint(layer, *args, policy=self.checkpoint_policy) \
                if ckpt else layer(*args)
        return self.final_layernorm(x).to(self.dtype)
