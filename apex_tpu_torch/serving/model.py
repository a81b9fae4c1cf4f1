"""GPT forward for serving: prefill + paged decode, in PyTorch.

Port of ``apex_tpu/serving/model.py`` (single device; dense float or
Q8 int8 weights, a float or int8 KV cache).  The math mirrors the JAX
serving forward operation for operation: fp32-statistics LayerNorm
(mixed fp32 gamma/beta over compute-dtype activations), ``x @ kernel +
bias`` in the compute dtype with the Flax (in, out) kernel layout kept
as it is, attention with an fp32 softmax, tanh-approximate GELU
(``jax.nn.gelu``'s default), and a tied LM head (``wte.T``).  A Q8
layer (:class:`~apex_tpu_torch.ops.quant_matmul.QuantLayerWeights`)
carries a ``*_s`` scale beside each int8 kernel, and its linears run
:func:`~apex_tpu_torch.ops.quant_matmul.quant_matmul` (fp32 accumulation,
the scale after, cast to the compute dtype) before the bias is added in
the compute dtype; the steps pick that path by ``getattr(lw, "qkv_s",
None)`` as JAX's do.  An int8 cache hands its scales to the paged
kernels.

* :func:`gpt_prefill_step` runs one right-padded prompt through the
  flash-attention kernel (causal: padded keys sit in every real query's
  future) while writing each layer's k/v into the request's pages.
* :func:`gpt_decode_step` advances every batch row one token through
  the paged flash-decode kernel; each layer writes the token's k/v
  before that layer's attention, so the token attends to itself.
* :func:`gpt_extend_step` advances every batch row by a chunk of ``t``
  tokens through the multi-token paged kernel: speculative
  verification, chunked prefill and the warm-prefix tail prefill.
* :func:`gpt_sequence_logits` is the teacher-forced whole-sequence
  oracle: same math, no cache.
* :func:`copy_cache_block` is the copy-on-write of one page.

A layer may be a Switch top-1 mixture of experts instead
(:class:`MoELayerWeights`: a fp32 router and bias-free expert stacks in
place of fc1/fc2): ``_layer_tail`` takes it by ``getattr(lw, "router",
None)``, as JAX's does, so prefill, decode, extend and the oracle all
route it, through row 18's kernel (:func:`~apex_tpu_torch.ops.moe_routing.
moe_route_dispatch`) or, under ``cfg.plain()``, its plain version.  Every
row the step hands in is routed: the decode bucket's padding rows and the
prompt's right padding claim capacity as they do in JAX.

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
from ..ops.flash_decode import (flash_decode, flash_decode_multi,
                                paged_attention_multi_reference,
                                paged_attention_reference)
from ..ops.layer_norm import layer_norm, layer_norm_reference
from ..ops.quant_matmul import quant_matmul, quant_matmul_reference
from ..transformer.expert_parallel import (moe_dispatch_combine_fused,
                                           router_logits)
from .kv_cache import (KVCacheConfig, PagedKVCache, write_prefill_kv,
                       write_token_kv)

__all__ = ["LayerWeights", "MoELayerWeights", "GPTServingWeights",
           "ServingModelConfig",
           "gpt_prefill_step", "gpt_decode_step", "gpt_extend_step",
           "gpt_sequence_logits", "copy_cache_block"]


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


class MoELayerWeights(NamedTuple):
    """A layer whose MLP is a Switch top-1 MoE: the attention and
    LayerNorm fields of :class:`LayerWeights`, then a router and bias-free
    expert stacks in place of fc1/fc2."""

    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    qkv_k: torch.Tensor
    qkv_b: torch.Tensor
    dense_k: torch.Tensor
    dense_b: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    router: torch.Tensor      # (H, E) fp32: routing is precision-sensitive
    wi: torch.Tensor          # (E, H, F)
    wo: torch.Tensor          # (E, F, H)


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
    # MoE layers (``MoELayerWeights``; ignored for dense weights): the
    # expert count the weights must carry, and the capacity factor that
    # sizes the (E, capacity, H) dispatch buffer of each routed step
    num_experts: int = 0
    moe_capacity_factor: float = 1.25

    def __post_init__(self):
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden {self.hidden_size} not divisible by "
                             f"heads {self.num_heads}")
        if self.num_experts < 0:
            raise ValueError(f"num_experts {self.num_experts} must be >= 0")

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


def _matmul(x, kernel, cfg: ServingModelConfig, scale):
    """The one matmul every linear shares: ``scale`` None is a dense
    compute-dtype matmul; the per-column fp32 scales of an int8 kernel
    take :func:`quant_matmul` (its plain version under ``cfg.plain()``),
    which never builds the dequantized weight."""
    if scale is not None:
        qmm = quant_matmul if cfg.kernels else quant_matmul_reference
        return qmm(x, kernel, scale, out_dtype=cfg.dtype)
    return torch.matmul(x.to(cfg.dtype), kernel.to(cfg.dtype))


def _linear(x, kernel, bias, cfg: ServingModelConfig, scale=None):
    """The matmul, then the bias added in the compute dtype (a separate
    add, as the JAX ``_linear`` rounds it)."""
    return _matmul(x, kernel, cfg, scale) + bias.to(cfg.dtype)


def _expert_bmm_fp32(a, b):
    """``a @ b`` batched over experts with an fp32 result from
    compute-dtype operands (JAX's ``preferred_element_type=fp32``): the
    gelu's input is never rounded to bf16.  cuBLAS writes fp32 directly;
    the CPU (no such kernel) multiplies the same values in fp32."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _moe_mlp(m_in, lw: MoELayerWeights, cfg: ServingModelConfig):
    """The Switch top-1 MoE FFN (JAX ``_moe_mlp`` with ``ep_axis`` None):
    fp32 router logits, the fused routing front over every row handed in,
    the bias-free expert GEMMs batched over the (E, capacity, H) buffer
    (fp32 through the gelu, the second cast to the compute dtype), the
    gate-weighted combine."""
    hdim = m_in.shape[-1]
    x2d = m_in.reshape(-1, hdim)
    dt = cfg.dtype
    logits = router_logits(x2d, lw.router)

    def expert_fn(d):
        h1 = F.gelu(_expert_bmm_fp32(d.to(dt), lw.wi.to(dt)),
                    approximate="tanh")
        return torch.bmm(h1.to(dt), lw.wo.to(dt))

    y, _ = moe_dispatch_combine_fused(
        x2d.to(dt), logits, expert_fn, lw.router.shape[-1],
        capacity_factor=cfg.moe_capacity_factor, axis_name=None,
        plain=not cfg.kernels)
    return y.reshape(m_in.shape)


def _layer_tail(x, lw: LayerWeights, attn_out, cfg: ServingModelConfig):
    """residual + LN + MLP + residual — shared by prefill and decode; an
    :class:`MoELayerWeights` layer routes through the MoE FFN."""
    x = x + attn_out.to(x.dtype)
    m_in = _ln(x, lw.ln2_w, lw.ln2_b, cfg)
    if getattr(lw, "router", None) is not None:
        return x + _moe_mlp(m_in, lw, cfg).to(x.dtype)
    h1 = F.gelu(_linear(m_in, lw.fc1_k, lw.fc1_b, cfg,
                        getattr(lw, "fc1_s", None)), approximate="tanh")
    return x + _linear(h1, lw.fc2_k, lw.fc2_b, cfg,
                       getattr(lw, "fc2_s", None)).to(x.dtype)


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
        qkv = _linear(a_in, lw.qkv_k, lw.qkv_b, cfg,
                      getattr(lw, "qkv_s", None))
        q, k, v = qkv.reshape(1, s_pad, h, 3 * d).split(d, dim=-1)
        write_prefill_kv(cache, cache_cfg, i, k[0], v[0], blocks)
        ctx = attn(q.transpose(1, 2), k.transpose(1, 2),
                   v.transpose(1, 2), scale=scale, causal=True)
        ctx = ctx.transpose(1, 2).reshape(1, s_pad, h * d)
        x = _layer_tail(x, lw, _linear(ctx, lw.dense_k, lw.dense_b, cfg,
                                       getattr(lw, "dense_s", None)), cfg)
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
        qkv = _linear(a_in, lw.qkv_k, lw.qkv_b, cfg,
                      getattr(lw, "qkv_s", None))
        q, k, v = qkv.reshape(b, h, 3 * d).split(d, dim=-1)     # (b, h, d)
        write_token_kv(cache, cache_cfg, i, k, v, write_blocks,
                       write_offsets)
        kc, vc, ks, vs = cache.layer(i)
        decode = flash_decode if cfg.kernels else paged_attention_reference
        ctx = decode(q, kc, vc, block_tables, seq_lens, scale=scale,
                     k_scale=ks, v_scale=vs)
        x = _layer_tail(x, lw, _linear(ctx.reshape(b, h * d), lw.dense_k,
                                       lw.dense_b, cfg,
                                       getattr(lw, "dense_s", None)), cfg)
    logits = _lm_head(x, weights, cfg)                         # (b, V)
    next_tokens = torch.argmax(logits, dim=-1)
    if return_logits:
        return cache, next_tokens, logits
    return cache, next_tokens


def gpt_extend_step(weights: GPTServingWeights, cfg: ServingModelConfig,
                    cache_cfg: KVCacheConfig, cache: PagedKVCache,
                    tokens: torch.Tensor, block_tables: torch.Tensor,
                    seq_lens: torch.Tensor, write_blocks: torch.Tensor,
                    write_offsets: torch.Tensor, *,
                    return_logits: bool = False):
    """Advance every batch row by a chunk of ``t`` tokens against the
    paged cache — the one step behind speculative verification, chunked
    prefill and the warm-prefix tail prefill; returns ``(cache,
    next_tokens)`` with one argmax per chunk slot, (b, t) (plus the
    (b, t, V) logits with ``return_logits``).

    ``tokens`` (b, t) int64: row ``b``'s chunk sits at positions
    ``seq_lens[b] - t .. seq_lens[b] - 1`` (``seq_lens`` counts every
    written token including the chunk).  Token ``j``'s k/v goes to
    ``(write_blocks[b, j], write_offsets[b, j])`` layer by layer before
    that layer's attention, so the chunk attends to itself through the
    cache.  A chunk shorter than ``t`` is front-padded: padding slots sit
    at negative positions (their embedding lookup clamped to position
    0), write to the dump page, and give a discarded token.
    ``next_tokens[b, j]`` is the greedy choice after position
    ``seq_lens[b] - t + j``."""
    h, d = cache_cfg.num_heads, cache_cfg.head_dim
    b, t = tokens.shape
    scale = d ** -0.5
    pos = seq_lens.to(tokens.device).long()[:, None] - t \
        + torch.arange(t, device=tokens.device)[None, :]         # (b, t)
    x = _embed(weights, tokens, pos.clamp(min=0), cfg)          # (b, t, H)
    wb = write_blocks.reshape(b * t)
    wo = write_offsets.reshape(b * t)
    attend = flash_decode_multi if cfg.kernels \
        else paged_attention_multi_reference
    for i, lw in enumerate(weights.layers):
        a_in = _ln(x, lw.ln1_w, lw.ln1_b, cfg)
        qkv = _linear(a_in, lw.qkv_k, lw.qkv_b, cfg,
                      getattr(lw, "qkv_s", None))
        q, k, v = qkv.reshape(b, t, h, 3 * d).split(d, dim=-1)  # (b,t,h,d)
        write_token_kv(cache, cache_cfg, i, k.reshape(b * t, h, d),
                       v.reshape(b * t, h, d), wb, wo)
        kc, vc, ks, vs = cache.layer(i)
        ctx = attend(q, kc, vc, block_tables, seq_lens, scale=scale,
                     k_scale=ks, v_scale=vs)
        x = _layer_tail(x, lw, _linear(ctx.reshape(b, t, h * d),
                                       lw.dense_k, lw.dense_b, cfg,
                                       getattr(lw, "dense_s", None)), cfg)
    logits = _lm_head(x, weights, cfg)                        # (b, t, V)
    next_tokens = torch.argmax(logits, dim=-1)
    if return_logits:
        return cache, next_tokens, logits
    return cache, next_tokens


def copy_cache_block(cache: PagedKVCache, src: int, dst: int) -> None:
    """Copy-on-write on the device: block ``src``'s k and v (and an int8
    cache's scale rows), every layer, into block ``dst``, in place."""
    cache.k[:, dst] = cache.k[:, src]
    cache.v[:, dst] = cache.v[:, src]
    if cache.k_scale is not None:
        cache.k_scale[:, dst] = cache.k_scale[:, src]
        cache.v_scale[:, dst] = cache.v_scale[:, src]


def gpt_sequence_logits(weights: GPTServingWeights, cfg: ServingModelConfig,
                        tokens: torch.Tensor) -> torch.Tensor:
    """Whole-sequence teacher-forced logits ``(b, s, V)`` — no KV cache,
    no paging: the oracle the served token streams are checked against.
    Q8 weights run their quantized matmuls here too; an int8 cache is
    not modelled (nothing is cached)."""
    b, s = tokens.shape
    h, d = cfg.num_heads, cfg.head_dim
    scale = d ** -0.5
    pos = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    x = _embed(weights, tokens, pos, cfg)
    attn = _attention(cfg)
    for lw in weights.layers:
        a_in = _ln(x, lw.ln1_w, lw.ln1_b, cfg)
        qkv = _linear(a_in, lw.qkv_k, lw.qkv_b, cfg,
                      getattr(lw, "qkv_s", None))
        q, k, v = qkv.reshape(b, s, h, 3 * d).split(d, dim=-1)
        ctx = attn(q.transpose(1, 2), k.transpose(1, 2),
                   v.transpose(1, 2), scale=scale, causal=True)
        ctx = ctx.transpose(1, 2).reshape(b, s, h * d)
        x = _layer_tail(x, lw, _linear(ctx, lw.dense_k, lw.dense_b, cfg,
                                       getattr(lw, "dense_s", None)), cfg)
    return _lm_head(x, weights, cfg)
