"""Paged flash-decode: the CUDA kernel and its plain version.

Port of ``apex_tpu/ops/flash_decode.py``'s ``flash_decode``
(``_decode_paged`` / ``_decode_kernel``) with a float KV cache: one
query row per sequence against a block-paged cache.

Layouts (``bs`` = tokens per cache block):

* q            (b, h, d)          one query token per sequence
* k/v cache    (nb, h, bs, d)     block-major, heads unpacked
* block_tables (b, max_pages)     int32 cache-block id per page
* seq_lens     (b,)               int32; attend over positions < seq_len,
  0 marks an inactive row (output exactly 0)

The JAX cache stores d=64 head pairs packed as (nb, h/2, bs, 2d), a TPU
lane trick; the port stores heads unpacked and matches the numerics.
The int8-KV branch of the JAX kernel is not ported yet.

On a CUDA tensor :func:`flash_decode` launches ``csrc/flash_decode.cu``
or raises; on a CPU tensor it runs :func:`paged_attention_reference`.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from ._counts import bump

__all__ = ["flash_decode", "paged_attention_reference"]

_TAKES = (torch.float32, torch.bfloat16, torch.float16)
_HEAD_DIMS = (64, 128)
_MAX_BLOCK = 256


def paged_attention_reference(q, k_cache, v_cache, block_tables, seq_lens,
                              scale: Optional[float] = None):
    """Dense twin of :func:`flash_decode` (the jnp
    ``paged_attention_reference``): gather every row's pages into a
    contiguous (b, h, pages*bs, d) k/v, mask by global position, fp32
    softmax; rows with seq_len 0 are exactly 0."""
    b, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    nb, _, bs, _ = k_cache.shape
    mp = block_tables.shape[1]
    bt = block_tables.long()
    k = k_cache[bt].permute(0, 2, 1, 3, 4).reshape(b, h, mp * bs, d)
    v = v_cache[bt].permute(0, 2, 1, 3, 4).reshape(b, h, mp * bs, d)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k.float()) * scale
    pos = torch.arange(mp * bs, device=q.device)[None, None, :]
    mask = pos < seq_lens.to(q.device).long()[:, None, None]
    s = s.masked_fill(~mask, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhk,bhkd->bhd", p / safe, v.float())
    o = torch.where(l == 0.0, torch.zeros_like(o), o)
    return o.to(q.dtype)


def _launch(q, k_cache, v_cache, block_tables, seq_lens, scale):
    b, h, d = q.shape
    nb, hk, bs, dk = k_cache.shape
    if q.dtype not in _TAKES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"flash_decode kernel takes q and a float cache "
                        f"of one dtype in {_TAKES}, got {q.dtype}/"
                        f"{k_cache.dtype}/{v_cache.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_decode kernel takes head dim in "
                         f"{_HEAD_DIMS}, got {d}")
    if bs > _MAX_BLOCK:
        raise ValueError(f"flash_decode kernel takes block size <= "
                         f"{_MAX_BLOCK}, got {bs}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("flash_decode kernel needs contiguous caches")
    if q.stride(-1) != 1:
        raise ValueError("flash_decode kernel needs a unit stride on q's "
                         "last dim")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("block_tables and seq_lens must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or seq_lens.shape != (b,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"seq_lens {tuple(seq_lens.shape)} do not match "
                         f"batch {b}")
    if not block_tables.is_contiguous() or not seq_lens.is_contiguous():
        raise ValueError("block_tables and seq_lens must be contiguous")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("block_tables", block_tables),
                    ("seq_lens", seq_lens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    if block_tables.shape[1] == 0:
        return out.zero_()
    lib = _build.library("flash_decode")
    with torch.cuda.device(q.device):
        rc = lib.apex_flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            b, h, d, bs, block_tables.shape[1], q.stride(0), q.stride(1),
            float(scale), _build.dtype_code(q.dtype),
            _build.stream_ptr(q.device))
    _build.check("flash_decode", rc, "flash_decode kernel")
    bump("flash_decode")
    return out


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, block_tables: torch.Tensor,
                 seq_lens: torch.Tensor, *,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Single-query attention over a block-paged float KV cache;
    returns (b, h, d) in q's dtype.  Block ids in ``block_tables``
    must name blocks of the cache; pages past a row's seq_len are
    never read."""
    b, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    if k_cache.shape != v_cache.shape:
        raise ValueError(f"k/v cache shapes differ: "
                         f"{tuple(k_cache.shape)} vs "
                         f"{tuple(v_cache.shape)}")
    if k_cache.dim() != 4 or k_cache.shape[1] != h \
            or k_cache.shape[3] != d:
        raise ValueError(f"cache {tuple(k_cache.shape)} is not "
                         f"(nb, {h}, bs, {d}) for q {tuple(q.shape)} — "
                         f"the port stores heads unpacked")
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_cache, v_cache,
                                         block_tables, seq_lens,
                                         scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k_cache, v_cache, block_tables, seq_lens, scale)
