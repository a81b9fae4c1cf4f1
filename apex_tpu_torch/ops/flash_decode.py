"""Paged flash-decode: the CUDA kernels and their plain versions.

Port of ``apex_tpu/ops/flash_decode.py``'s ``flash_decode``
(``_decode_paged`` / ``_decode_kernel``) and ``flash_decode_multi``
(``_decode_paged_multi`` / ``_decode_multi_kernel``), with a float or
an int8 KV cache: one query row, or a chunk of ``t`` contiguous query
rows, per sequence against a block-paged cache.

Layouts (``bs`` = tokens per cache block):

* q            (b, h, d)          one query token per sequence, or
  (b, t, h, d) for the multi-token path
* k/v cache    (nb, h, bs, d)     block-major, heads unpacked
* block_tables (b, max_pages)     int32 cache-block id per page
* seq_lens     (b,)               int32; attend over positions < seq_len,
  0 marks an inactive row (output exactly 0).  On the multi-token path
  seq_len counts the chunk: row ``r`` sits at ``seq_len - t + r`` and
  attends positions ``<=`` that; a row at a negative position (front
  padding) emits exactly 0.

* k_scale/v_scale (nb, h, bs)     fp32, one scale per cached row and
  head: given (both or neither) with an int8 cache, whose elements read
  as ``code * scale`` (:func:`dequantize_kv`)

The JAX cache stores d=64 head pairs packed as (nb, h/2, bs, 2d), a TPU
lane trick; the port stores heads unpacked and matches the numerics.
The scales keep the global head order in both layouts.

On a CUDA tensor :func:`flash_decode` / :func:`flash_decode_multi`
launch ``csrc/flash_decode.cu`` or raise; on a CPU tensor they run
:func:`paged_attention_reference` / :func:`paged_attention_multi_reference`.
The int8 branches count their launches as ``flash_decode_int8`` and
``flash_decode_multi_int8``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from .. import _build
from ._counts import bump

__all__ = ["flash_decode", "paged_attention_reference",
           "flash_decode_multi", "paged_attention_multi_reference",
           "dequantize_kv"]

_TAKES = (torch.float32, torch.bfloat16, torch.float16)
_HEAD_DIMS = (64, 128)
_MAX_BLOCK = 256


def dequantize_kv(cache: torch.Tensor,
                  scale: Optional[torch.Tensor]) -> torch.Tensor:
    """int8 (nb, h, bs, d) cache and its (nb, h, bs) per-row scales ->
    fp32 ``code * scale``; a float cache (``scale`` None) passes
    through."""
    if scale is None:
        return cache
    return cache.float() * scale.float()[..., None]


def paged_attention_reference(q, k_cache, v_cache, block_tables, seq_lens,
                              scale: Optional[float] = None, k_scale=None,
                              v_scale=None):
    """Dense twin of :func:`flash_decode` (the jnp
    ``paged_attention_reference``): the multi-token twin at ``t = 1``,
    whose one row attends positions ``< seq_len``; rows with seq_len 0
    are exactly 0."""
    return paged_attention_multi_reference(q[:, None], k_cache, v_cache,
                                           block_tables, seq_lens,
                                           scale=scale, k_scale=k_scale,
                                           v_scale=v_scale)[:, 0]


def paged_attention_multi_reference(q, k_cache, v_cache, block_tables,
                                    seq_lens, scale: Optional[float] = None,
                                    k_scale=None, v_scale=None):
    """Dense twin of :func:`flash_decode_multi` (the jnp
    ``paged_attention_multi_reference``): dequantize an int8 cache, gather
    every row's pages, mask query row ``r`` of sequence ``b`` to
    positions ``<= seq_lens[b] - t + r``, fp32 softmax; a row with no
    position to attend is exactly 0."""
    b, t, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    k_cache = dequantize_kv(k_cache, k_scale)
    v_cache = dequantize_kv(v_cache, v_scale)
    nb, _, bs, _ = k_cache.shape
    mp = block_tables.shape[1]
    bt = block_tables.long()
    k = k_cache[bt].permute(0, 2, 1, 3, 4).reshape(b, h, mp * bs, d)
    v = v_cache[bt].permute(0, 2, 1, 3, 4).reshape(b, h, mp * bs, d)
    s = torch.einsum("bthd,bhkd->bthk", q.float(), k.float()) * scale
    pos = torch.arange(mp * bs, device=q.device)[None, None, None, :]
    qpos = (seq_lens.to(q.device).long()[:, None] - t
            + torch.arange(t, device=q.device)[None, :])       # (b, t)
    mask = pos <= qpos[:, :, None, None]
    s = s.masked_fill(~mask, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bthk,bhkd->bthd", p / safe, v.float())
    o = torch.where(l == 0.0, torch.zeros_like(o), o)
    return o.to(q.dtype)


def _check_launch(what, q, k_cache, v_cache, k_scale, v_scale,
                  block_tables, seq_lens):
    """What both kernels take: q in a float dtype and a cache of q's
    dtype, bf16 under fp32 q, or int8 with its scales; head dim 64 or
    128, bs <= 256, contiguous caches, scales and int32 tables on q's
    device."""
    b, d = q.shape[0], q.shape[-1]
    bs = k_cache.shape[2]
    cdt = k_cache.dtype
    ok = cdt == q.dtype or cdt == torch.int8 or \
        (cdt == torch.bfloat16 and q.dtype == torch.float32)
    if q.dtype not in _TAKES or v_cache.dtype != cdt or not ok:
        raise TypeError(f"{what} kernel takes q in {_TAKES} and a cache "
                        f"of q's dtype, bf16 under fp32 q, or int8, got "
                        f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if k_scale is not None and not (k_scale.dtype == v_scale.dtype
                                    == torch.float32
                                    and k_scale.is_contiguous()
                                    and v_scale.is_contiguous()):
        raise TypeError(f"{what} kernel takes contiguous fp32 scales")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head dim in "
                         f"{_HEAD_DIMS}, got {d}")
    if bs > _MAX_BLOCK:
        raise ValueError(f"{what} kernel takes block size <= "
                         f"{_MAX_BLOCK}, got {bs}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{what} kernel needs contiguous caches")
    if q.stride(-1) != 1:
        raise ValueError(f"{what} kernel needs a unit stride on q's "
                         f"last dim")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("block_tables and seq_lens must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or seq_lens.shape != (b,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"seq_lens {tuple(seq_lens.shape)} do not match "
                         f"batch {b}")
    if not block_tables.is_contiguous() or not seq_lens.is_contiguous():
        raise ValueError("block_tables and seq_lens must be contiguous")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("k_scale", k_scale), ("v_scale", v_scale),
                    ("block_tables", block_tables),
                    ("seq_lens", seq_lens)):
        if x is not None and x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _aligned16(cache):
    """The cache itself, or a copy where a view's data starts off 16
    bytes (the kernel reads rows 16 bytes at a time)."""
    return cache if cache.data_ptr() % 16 == 0 else cache.clone()


@functools.lru_cache(maxsize=256)
def _decode_splits(b: int, h: int, bs: int, mp: int) -> int:
    """Row 14's number of position splits (the C side's rule), asked
    once a shape: the serve's decode repeats a few shapes every tick."""
    return _build.library("flash_decode").apex_flash_decode_splits(
        b, h, bs, mp)


@functools.lru_cache(maxsize=256)
def _multi_splits(b: int, t: int, h: int, bs: int, mp: int) -> int:
    """Row 15's number of position splits (the C side's rule), asked once
    a shape: the fast path repeats a few shapes every step."""
    return _build.library("flash_decode").apex_flash_decode_multi_plan(
        b, t, h, bs, mp)


def _scratch(rows: int, d: int, device):
    """One fp32 scratch for ``rows`` split rows: each split's accumulator
    (part_o) and (max, sum) (part_ml, after every part_o), as two
    pointers."""
    part = torch.empty(rows * (d + 2), dtype=torch.float32, device=device)
    part_o = part.data_ptr()
    return part, part_o, part_o + rows * d * part.element_size()


def _launch(q, k_cache, v_cache, k_scale, v_scale, block_tables, seq_lens,
            scale):
    _check_launch("flash_decode", q, k_cache, v_cache, k_scale, v_scale,
                  block_tables, seq_lens)
    b, h, d = q.shape
    bs = k_cache.shape[2]
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    if block_tables.shape[1] == 0:
        return out.zero_()
    lib = _build.library("flash_decode")
    mp = block_tables.shape[1]
    k_cache, v_cache = _aligned16(k_cache), _aligned16(v_cache)
    # a row's splits meet in one fp32 scratch: each split leaves its
    # accumulator (part_o) and (max, sum) (part_ml, after every part_o);
    # one split writes out directly
    splits = _decode_splits(b, h, bs, mp)
    part_o = part_ml = None
    if splits > 1:
        part, part_o, part_ml = _scratch(b * h * splits, d, q.device)
    with torch.cuda.device(q.device):
        rc = lib.apex_flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
            seq_lens.data_ptr(), part_o, part_ml,
            out.data_ptr(), b, h, d, bs, mp, q.stride(0), q.stride(1),
            float(scale), _build.dtype_code(q.dtype),
            _build.dtype_code(k_cache.dtype), _build.stream_ptr(q.device))
    name = "flash_decode_int8" if k_scale is not None else "flash_decode"
    _build.check("flash_decode", rc, f"{name} kernel")
    bump(name)
    return out


def _launch_multi(q, k_cache, v_cache, k_scale, v_scale, block_tables,
                  seq_lens, scale):
    _check_launch("flash_decode_multi", q, k_cache, v_cache, k_scale,
                  v_scale, block_tables, seq_lens)
    b, t, h, d = q.shape
    bs = k_cache.shape[2]
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or t == 0:
        return out
    if block_tables.shape[1] == 0:
        return out.zero_()
    lib = _build.library("flash_decode")
    mp = block_tables.shape[1]
    k_cache, v_cache = _aligned16(k_cache), _aligned16(v_cache)
    # a row's splits meet in one fp32 scratch, as row 14's; one split
    # writes out directly
    splits = _multi_splits(b, t, h, bs, mp)
    part_o = part_ml = None
    if splits > 1:
        part, part_o, part_ml = _scratch(b * t * h * splits, d, q.device)
    with torch.cuda.device(q.device):
        rc = lib.apex_flash_decode_multi(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
            seq_lens.data_ptr(), part_o, part_ml,
            out.data_ptr(), b, t, h, d, bs, mp, q.stride(0), q.stride(1),
            q.stride(2), float(scale), _build.dtype_code(q.dtype),
            _build.dtype_code(k_cache.dtype), _build.stream_ptr(q.device))
    name = "flash_decode_multi_int8" if k_scale is not None \
        else "flash_decode_multi"
    _build.check("flash_decode", rc, f"{name} kernel")
    bump(name)
    return out


def _check_cache(q, k_cache, v_cache, k_scale, v_scale):
    h, d = q.shape[-2:]
    if k_cache.shape != v_cache.shape:
        raise ValueError(f"k/v cache shapes differ: "
                         f"{tuple(k_cache.shape)} vs "
                         f"{tuple(v_cache.shape)}")
    if k_cache.dim() != 4 or k_cache.shape[1] != h \
            or k_cache.shape[3] != d:
        raise ValueError(f"cache {tuple(k_cache.shape)} is not "
                         f"(nb, {h}, bs, {d}) for q {tuple(q.shape)} — "
                         f"the port stores heads unpacked")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if (k_scale is not None) != (k_cache.dtype == torch.int8):
        raise TypeError(f"k_scale/v_scale go with an int8 cache and only "
                        f"with one; the cache is {k_cache.dtype}")
    nb, _, bs, _ = k_cache.shape
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if sc is not None and tuple(sc.shape) != (nb, h, bs):
            raise ValueError(f"{name} shape {tuple(sc.shape)} != expected "
                             f"{(nb, h, bs)} (global head order)")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash decode runs on cuda or cpu, not "
                         f"{q.device}")


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, block_tables: torch.Tensor,
                 seq_lens: torch.Tensor, *,
                 scale: Optional[float] = None,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-query attention over a block-paged KV cache; returns
    (b, h, d) in q's dtype.  ``k_scale``/``v_scale`` (nb, h, bs) fp32
    arm the int8 cache.  Block ids in ``block_tables`` must name blocks
    of the cache; pages past a row's seq_len are never read."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    _check_cache(q, k_cache, v_cache, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_cache, v_cache,
                                         block_tables, seq_lens,
                                         scale=scale, k_scale=k_scale,
                                         v_scale=v_scale)
    return _launch(q, k_cache, v_cache, k_scale, v_scale, block_tables,
                   seq_lens, scale)


def flash_decode_multi(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, block_tables: torch.Tensor,
                       seq_lens: torch.Tensor, *,
                       scale: Optional[float] = None,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Multi-token paged attention: ``t`` contiguous query rows per
    sequence, ``q`` (b, t, h, d), each row causal at its own position
    (``seq_lens[b] - t + r``); returns (b, t, h, d) in q's dtype.  The
    chunk's own k/v must already be in the cache (the serving step
    writes it first).  The int8 cache as :func:`flash_decode`'s.  At
    ``t == 1`` this computes :func:`flash_decode`.  Inference only."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} is not (b, t, h, d)")
    _check_cache(q, k_cache, v_cache, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_multi_reference(q, k_cache, v_cache,
                                               block_tables, seq_lens,
                                               scale=scale, k_scale=k_scale,
                                               v_scale=v_scale)
    return _launch_multi(q, k_cache, v_cache, k_scale, v_scale,
                         block_tables, seq_lens, scale)
