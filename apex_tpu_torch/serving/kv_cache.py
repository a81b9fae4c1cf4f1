"""Block-paged KV cache: device tensors + host block-pool bookkeeping.

Port of ``apex_tpu/serving/kv_cache.py`` without prefix sharing,
copy-on-write or int8 KV (later slices).  The pool is ``num_blocks``
blocks of ``block_size`` tokens shared by every in-flight request; a
request owns an ordered list of block ids (its block table), growing
past a block edge takes one block from the free list, finishing returns
them.  Nothing is ever moved or compacted.

* :class:`PagedKVCache` — the device state, k/v of shape
  ``(L, nb, h, bs, d)``.  The JAX cache is an immutable pytree donated
  through every step; here the step functions write into these tensors
  **in place** (index writes), so the cache is never copied.  Heads are
  stored unpacked: the JAX layout packs d=64 head pairs as (h/2, 2d), a
  TPU lane trick the port matches in numerics, not in layout.
* :class:`KVCacheManager` — the host bookkeeping: free list, per-request
  tables and lengths.  Pure Python.

Block 0 is the reserved **dump page**: never handed to a request,
block-table padding points at it, and inactive batch rows write their
k/v there, so a bucketed step needs no write masking.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from .. import resolve_device

__all__ = ["KVCacheConfig", "PagedKVCache", "KVCacheManager",
           "CachePoolExhausted", "init_cache", "write_token_kv",
           "write_prefill_kv", "DUMP_BLOCK"]

DUMP_BLOCK = 0


class CachePoolExhausted(RuntimeError):
    """The block pool cannot cover a requested allocation."""


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Static shape/dtype plan for one paged cache."""

    num_layers: int
    num_heads: int
    head_dim: int
    num_blocks: int          # INCLUDING the reserved dump block
    block_size: int
    dtype: torch.dtype = torch.float32   # k/v storage = the model's dtype

    def __post_init__(self):
        if self.num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is the "
                             "reserved dump page)")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")

    @property
    def kv_shape(self):
        """(L, nb, h, bs, d) — heads unpacked."""
        return (self.num_layers, self.num_blocks, self.num_heads,
                self.block_size, self.head_dim)

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1

    def blocks_for(self, length: int) -> int:
        return -(-max(int(length), 1) // self.block_size)


class PagedKVCache(NamedTuple):
    """Device half of the cache."""

    k: torch.Tensor                    # (L, nb, h, bs, d)
    v: torch.Tensor

    def layer(self, i: int):
        """(k, v) views of layer ``i``, each (nb, h, bs, d)."""
        return self.k[i], self.v[i]


def init_cache(config: KVCacheConfig, device=None) -> PagedKVCache:
    """All-zero cache on ``device`` (cuda unless the CPU is asked for);
    zeros keep even an unmasked read of a never-written row finite."""
    dev = resolve_device(device)
    k = torch.zeros(config.kv_shape, dtype=config.dtype,
                    device=dev)
    return PagedKVCache(k, torch.zeros_like(k))


def write_token_kv(cache: PagedKVCache, config: KVCacheConfig, layer: int,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   blocks: torch.Tensor, offsets: torch.Tensor) -> None:
    """Write ONE token's k/v per batch row into layer ``layer``'s page
    slots, in place.  ``k_new``/``v_new`` (b, h, d); ``blocks`` /
    ``offsets`` (b,) address each row's page and in-page slot
    (inactive rows point at the dump block, where duplicate writes race
    harmlessly)."""
    b, h, _ = k_new.shape
    heads = torch.arange(h, device=k_new.device)[None, :]
    idx = (blocks.long()[:, None], heads, offsets.long()[:, None])
    kl, vl = cache.layer(layer)
    kl[idx] = k_new.to(config.dtype)
    vl[idx] = v_new.to(config.dtype)


def write_prefill_kv(cache: PagedKVCache, config: KVCacheConfig,
                     layer: int, k_all: torch.Tensor, v_all: torch.Tensor,
                     blocks: torch.Tensor) -> None:
    """Write a prefilled prompt's whole k/v for one layer into its
    pages, in place.  ``k_all``/``v_all`` (s_pad, h, d) with ``s_pad =
    len(blocks) * block_size``; pages past the owned tail point at the
    dump block."""
    s_pad, h, d = k_all.shape
    bs = config.block_size
    n_pages = s_pad // bs
    blocks = blocks.long()
    kl, vl = cache.layer(layer)
    kl[blocks] = k_all.reshape(n_pages, bs, h, d).transpose(1, 2) \
        .to(config.dtype)
    vl[blocks] = v_all.reshape(n_pages, bs, h, d).transpose(1, 2) \
        .to(config.dtype)


class KVCacheManager:
    """Host-side block pool + per-request block tables.

    Free blocks form a LIFO stack, so an evict-then-readmit cycle hands
    the same ids back and the first blocks handed out are 1, 2, 3, ...
    All methods are O(pages touched)."""

    def __init__(self, config: KVCacheConfig):
        self.config = config
        self._free: List[int] = list(range(config.num_blocks - 1, 0, -1))
        self._tables: Dict[object, List[int]] = {}
        self._lens: Dict[object, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def can_admit(self, prompt_len: int, max_new_tokens: int, *,
                  reserved_blocks: int = 0) -> bool:
        """Reservation admission: the request's whole worst case
        (prompt + max_new_tokens) must fit the pool now, net of
        ``reserved_blocks`` already owed to in-flight requests — so a
        later :meth:`append` can never exhaust the pool mid-decode."""
        need = self.config.blocks_for(prompt_len + max_new_tokens)
        return need <= len(self._free) - reserved_blocks

    def alloc(self, rid, length: int) -> List[int]:
        """Claim blocks covering ``length`` tokens for a new request."""
        if rid in self._tables:
            raise ValueError(f"request {rid!r} already has blocks")
        if length < 1:
            raise ValueError("length must be >= 1")
        need = self.config.blocks_for(length)
        if need > len(self._free):
            raise CachePoolExhausted(
                f"request {rid!r} needs {need} block(s) for length "
                f"{length}, pool has {len(self._free)} free of "
                f"{self.config.usable_blocks}")
        blocks = [self._free.pop() for _ in range(need)]
        self._tables[rid] = blocks
        self._lens[rid] = int(length)
        return list(blocks)

    def append(self, rid):
        """Grow ``rid`` by one token, taking a fresh block when the
        token starts a new page.  Returns ``(block_id, offset)``, the
        slot the new token's k/v goes to (its position is the
        pre-append length)."""
        blocks = self._tables[rid]
        pos = self._lens[rid]
        page, off = divmod(pos, self.config.block_size)
        if page == len(blocks):
            if not self._free:
                raise CachePoolExhausted(
                    f"request {rid!r} crossed a block edge at length "
                    f"{pos + 1} with the pool empty — admission control "
                    f"must keep headroom (can_admit)")
            blocks.append(self._free.pop())
        self._lens[rid] = pos + 1
        return blocks[page], off

    def free(self, rid) -> List[int]:
        """Return ``rid``'s blocks to the pool (reverse order, so a
        readmit walks them back out first-block-first)."""
        blocks = self._tables.pop(rid)
        del self._lens[rid]
        self._free.extend(reversed(blocks))
        return blocks

    def seq_len(self, rid) -> int:
        return self._lens[rid]

    def num_pages(self, rid) -> int:
        return len(self._tables[rid])

    def block_table(self, rid, max_pages: int) -> np.ndarray:
        """(max_pages,) int32, padded with the dump block."""
        blocks = self._tables[rid]
        if len(blocks) > max_pages:
            raise ValueError(
                f"request {rid!r} owns {len(blocks)} pages > bucket "
                f"max_pages {max_pages} — the ladder pick is wrong")
        bt = np.full(max_pages, DUMP_BLOCK, np.int32)
        bt[:len(blocks)] = blocks
        return bt
