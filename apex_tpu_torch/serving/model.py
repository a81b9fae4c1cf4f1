"""GPT forward for serving: prefill + paged decode, in PyTorch.

Port of ``apex_tpu/serving/model.py`` (single device, dense float
weights).  The math mirrors the JAX serving forward operation for
operation: fp32-statistics LayerNorm (mixed fp32 gamma/beta over
compute-dtype activations), ``x @ kernel + bias`` in the compute dtype
with the Flax (in, out) kernel layout kept as it is, attention with an
fp32 softmax, tanh-approximate GELU (``jax.nn.gelu``'s default), and a
tied LM head (``wte.T``).

* :func:`gpt_prefill_step` runs one right-padded prompt through the
  flash-attention kernel (causal: padded keys sit in every real query's
  future) while writing each layer's k/v into the request's pages.
* :func:`gpt_decode_step` advances every batch row one token through
  the paged flash-decode kernel; each layer writes the token's k/v
  before that layer's attention, so the token attends to itself.
* :func:`gpt_sequence_logits` is the teacher-forced whole-sequence
  oracle: same math, no cache.

The fused QKV projection's columns are per head, (h, [q|k|v], d): both
steps reshape to (.., h, 3d) and split the last axis, as the JAX steps
do.  Cache writes are in place (see :mod:`.kv_cache`); the steps return
the cache for symmetry with the JAX signatures.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention, mha_reference
from ..ops.flash_decode import flash_decode, paged_attention_reference
from ..ops.layer_norm import layer_norm, layer_norm_reference
from .kv_cache import (KVCacheConfig, PagedKVCache, write_prefill_kv,
                       write_token_kv)

__all__ = ["LayerWeights", "GPTServingWeights", "ServingModelConfig",
           "gpt_prefill_step", "gpt_decode_step", "gpt_sequence_logits"]


class LayerWeights(NamedTuple):
    """One transformer layer's parameters."""

    ln1_w: torch.Tensor       # (H,) fp32
    ln1_b: torch.Tensor
    qkv_k: torch.Tensor       # (H, 3H), columns (h, [q|k|v], d)
    qkv_b: torch.Tensor
    dense_k: torch.Tensor     # (H, H)
    dense_b: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    fc1_k: torch.Tensor       # (H, F)
    fc1_b: torch.Tensor
    fc2_k: torch.Tensor       # (F, H)
    fc2_b: torch.Tensor


class GPTServingWeights(NamedTuple):
    """The whole model as plain tensors."""

    wte: torch.Tensor         # (V, H) — tied LM head
    wpe: torch.Tensor         # (S, H)
    layers: Tuple[LayerWeights, ...]
    lnf_w: torch.Tensor
    lnf_b: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ServingModelConfig:
    """Static model geometry + which kernels the forward runs."""

    vocab_size: int
    hidden_size: int
    num_heads: int
    num_layers: int
    max_seq: int
    dtype: torch.dtype = torch.float32
    layernorm_eps: float = 1e-5
    # True: LayerNorm, prefill attention and decode attention go through
    # the kernel wrappers; False: through their plain versions (the
    # oracle configuration, :meth:`plain`)
    kernels: bool = True

    def __post_init__(self):
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden {self.hidden_size} not divisible by "
                             f"heads {self.num_heads}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def ffn_size(self) -> int:
        return 4 * self.hidden_size

    def plain(self) -> "ServingModelConfig":
        """The same model through the plain versions of every kernel —
        the oracle configuration."""
        return dataclasses.replace(self, kernels=False)


def _ln(x, w, b, cfg: ServingModelConfig):
    fn = layer_norm if cfg.kernels else layer_norm_reference
    return fn(x, w, b, cfg.layernorm_eps).to(cfg.dtype)


def _linear(x, kernel, bias, dtype):
    """Compute-dtype matmul, then the bias added in the compute dtype
    (a separate add, as the JAX ``_linear`` rounds it)."""
    return torch.matmul(x.to(dtype), kernel.to(dtype)) + bias.to(dtype)


def _layer_tail(x, lw: LayerWeights, attn_out, cfg: ServingModelConfig):
    """residual + LN + MLP + residual — shared by prefill and decode."""
    x = x + attn_out.to(x.dtype)
    m_in = _ln(x, lw.ln2_w, lw.ln2_b, cfg)
    h1 = F.gelu(_linear(m_in, lw.fc1_k, lw.fc1_b, cfg.dtype),
                approximate="tanh")
    return x + _linear(h1, lw.fc2_k, lw.fc2_b, cfg.dtype).to(x.dtype)


def _lm_head(x, weights: GPTServingWeights, cfg: ServingModelConfig):
    """Final LN + tied-embedding projection."""
    hf = _ln(x, weights.lnf_w, weights.lnf_b, cfg)
    return torch.matmul(hf, weights.wte.to(cfg.dtype).t())


def _embed(weights: GPTServingWeights, tokens, positions, cfg):
    return weights.wte.to(cfg.dtype)[tokens] \
        + weights.wpe.to(cfg.dtype)[positions]


def _attention(cfg: ServingModelConfig):
    return flash_attention if cfg.kernels else mha_reference


def gpt_prefill_step(weights: GPTServingWeights, cfg: ServingModelConfig,
                     cache_cfg: KVCacheConfig, cache: PagedKVCache,
                     tokens: torch.Tensor, length: int,
                     blocks: torch.Tensor, *, return_logits: bool = False):
    """Run one prompt through the model, writing every layer's k/v into
    the request's pages; returns ``(cache, next_token)`` (plus the
    (V,) logits at ``length - 1`` with ``return_logits``).

    ``tokens`` (s_pad,) int64, right-padded to the prompt bucket
    (``s_pad = len(blocks) * block_size``); ``length`` the true prompt
    length; ``blocks`` (n_pages,) with dump-page padding past the owned
    tail.  Only the row at ``length - 1`` goes through the LM head: its
    argmax is the first generated token."""
    s_pad = tokens.shape[0]
    h, d = cache_cfg.num_heads, cache_cfg.head_dim
    scale = d ** -0.5
    pos = torch.arange(s_pad, device=tokens.device)
    x = _embed(weights, tokens[None, :], pos[None, :], cfg)   # (1, s, H)
    attn = _attention(cfg)
    for i, lw in enumerate(weights.layers):
        a_in = _ln(x, lw.ln1_w, lw.ln1_b, cfg)
        qkv = _linear(a_in, lw.qkv_k, lw.qkv_b, cfg.dtype)
        q, k, v = qkv.reshape(1, s_pad, h, 3 * d).split(d, dim=-1)
        write_prefill_kv(cache, cache_cfg, i, k[0], v[0], blocks)
        ctx = attn(q.transpose(1, 2), k.transpose(1, 2),
                   v.transpose(1, 2), scale=scale, causal=True)
        ctx = ctx.transpose(1, 2).reshape(1, s_pad, h * d)
        x = _layer_tail(x, lw, _linear(ctx, lw.dense_k, lw.dense_b,
                                       cfg.dtype), cfg)
    logits = _lm_head(x[:, length - 1], weights, cfg)[0]       # (V,)
    next_token = torch.argmax(logits, dim=-1)
    if return_logits:
        return cache, next_token, logits
    return cache, next_token


def gpt_decode_step(weights: GPTServingWeights, cfg: ServingModelConfig,
                    cache_cfg: KVCacheConfig, cache: PagedKVCache,
                    tokens: torch.Tensor, positions: torch.Tensor,
                    block_tables: torch.Tensor, seq_lens: torch.Tensor,
                    write_blocks: torch.Tensor, write_offsets: torch.Tensor,
                    *, return_logits: bool = False):
    """Advance every batch row one token against the paged cache;
    returns ``(cache, next_tokens)`` (plus the (b, V) logits with
    ``return_logits``).

    Row ``b``: ``tokens[b]`` sits at ``positions[b]``; its k/v goes to
    ``(write_blocks[b], write_offsets[b])`` layer by layer before that
    layer's attention; ``seq_lens[b] = positions[b] + 1`` bounds the
    attended span.  Inactive bucket rows carry ``seq_lens = 0`` and
    write to the dump page; their (discarded) outputs are
    deterministic.  ``block_tables``/``seq_lens`` are int32."""
    h, d = cache_cfg.num_heads, cache_cfg.head_dim
    b = tokens.shape[0]
    scale = d ** -0.5
    x = _embed(weights, tokens, positions, cfg)                # (b, H)
    for i, lw in enumerate(weights.layers):
        a_in = _ln(x, lw.ln1_w, lw.ln1_b, cfg)
        qkv = _linear(a_in, lw.qkv_k, lw.qkv_b, cfg.dtype)
        q, k, v = qkv.reshape(b, h, 3 * d).split(d, dim=-1)     # (b, h, d)
        write_token_kv(cache, cache_cfg, i, k, v, write_blocks,
                       write_offsets)
        kc, vc = cache.layer(i)
        decode = flash_decode if cfg.kernels else paged_attention_reference
        ctx = decode(q, kc, vc, block_tables, seq_lens, scale=scale)
        x = _layer_tail(x, lw, _linear(ctx.reshape(b, h * d), lw.dense_k,
                                       lw.dense_b, cfg.dtype), cfg)
    logits = _lm_head(x, weights, cfg)                         # (b, V)
    next_tokens = torch.argmax(logits, dim=-1)
    if return_logits:
        return cache, next_tokens, logits
    return cache, next_tokens


def gpt_sequence_logits(weights: GPTServingWeights, cfg: ServingModelConfig,
                        tokens: torch.Tensor) -> torch.Tensor:
    """Whole-sequence teacher-forced logits ``(b, s, V)`` — no KV cache,
    no paging: the oracle the served token streams are checked
    against."""
    b, s = tokens.shape
    h, d = cfg.num_heads, cfg.head_dim
    scale = d ** -0.5
    pos = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    x = _embed(weights, tokens, pos, cfg)
    attn = _attention(cfg)
    for lw in weights.layers:
        a_in = _ln(x, lw.ln1_w, lw.ln1_b, cfg)
        qkv = _linear(a_in, lw.qkv_k, lw.qkv_b, cfg.dtype)
        q, k, v = qkv.reshape(b, s, h, 3 * d).split(d, dim=-1)
        ctx = attn(q.transpose(1, 2), k.transpose(1, 2),
                   v.transpose(1, 2), scale=scale, causal=True)
        ctx = ctx.transpose(1, 2).reshape(b, s, h * d)
        x = _layer_tail(x, lw, _linear(ctx, lw.dense_k, lw.dense_b,
                                       cfg.dtype), cfg)
    return _lm_head(x, weights, cfg)
