"""Block-paged KV cache: device tensors + host block-pool bookkeeping.

Port of ``apex_tpu/serving/kv_cache.py`` with copy-on-write prompt-prefix
sharing and the three storage dtypes (the fleet's prefix export/import
is a later slice).  The pool is ``num_blocks`` blocks of ``block_size``
tokens shared by every in-flight request; a request owns an ordered
list of block ids (its block table), growing past a block edge takes one
block from the free list, finishing returns them, and a speculative
rollback (:meth:`KVCacheManager.truncate`) returns the pages past the
new end.  Nothing is ever moved or compacted.

* :class:`PagedKVCache` — the device state, k/v of shape
  ``(L, nb, h, bs, d)`` and, for an int8 cache, per-row fp32 scales
  ``(L, nb, h, bs)`` (global head order, as JAX keeps them).  The JAX
  cache is an immutable pytree donated through every step; here the step
  functions write into these tensors **in place** (index writes), so the
  cache is never copied.  Heads are stored unpacked: the JAX layout packs
  d=64 head pairs as (h/2, 2d), a TPU lane trick the port matches in
  numerics, not in layout.
* :class:`KVCacheManager` — the host bookkeeping: free list, per-request
  tables and lengths, and with ``prefix_sharing`` the content-hashed
  index of prompt pages, their refcounts and the idle LRU.  Pure
  Python.

Block 0 is the reserved **dump page**: never handed to a request,
block-table padding points at it, and inactive batch rows write their
k/v there, so a bucketed step needs no write masking.

Storage dtype (``kv_dtype``; the JAX flag ``APEX_TPU_SERVE_KV_DTYPE``):
``model`` stores k/v in the model's dtype, ``bf16`` in bfloat16, and
``int8`` stores each cached row (token, head) as symmetric int8 codes
against its own fp32 scale (:func:`quantize_kv_rows`), so an append
never requantizes history; the paged kernels dequantize as they read.
Quantizing is plain PyTorch, as it is plain jnp in JAX.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device

__all__ = ["KVCacheConfig", "PagedKVCache", "KVCacheManager",
           "PrefixMatch", "CachePoolExhausted", "init_cache",
           "write_token_kv", "write_prefill_kv", "quantize_kv_rows",
           "prefix_chain_keys", "DUMP_BLOCK", "KV_DTYPES"]

DUMP_BLOCK = 0

KV_DTYPES = ("model", "bf16", "int8")


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
    dtype: torch.dtype = torch.float32   # the model's dtype
    kv_dtype: str = "model"              # 'model' | 'bf16' | 'int8'

    def __post_init__(self):
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {self.kv_dtype!r} not in "
                             f"{KV_DTYPES}")
        if self.num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is the "
                             "reserved dump page)")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")

    @property
    def storage_dtype(self) -> torch.dtype:
        if self.kv_dtype == "int8":
            return torch.int8
        if self.kv_dtype == "bf16":
            return torch.bfloat16
        return self.dtype

    @property
    def quantized(self) -> bool:
        return self.kv_dtype == "int8"

    @property
    def kv_shape(self):
        """(L, nb, h, bs, d) — heads unpacked."""
        return (self.num_layers, self.num_blocks, self.num_heads,
                self.block_size, self.head_dim)

    @property
    def scale_shape(self):
        """(L, nb, h, bs) — one scale per cached row and head."""
        return (self.num_layers, self.num_blocks, self.num_heads,
                self.block_size)

    def cache_nbytes(self) -> int:
        """Device bytes of k, v and (int8) their scales."""
        n = 2 * int(np.prod(self.kv_shape)) * \
            torch.empty((), dtype=self.storage_dtype).element_size()
        if self.quantized:
            n += 2 * int(np.prod(self.scale_shape)) * 4
        return n

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1

    def blocks_for(self, length: int) -> int:
        return -(-max(int(length), 1) // self.block_size)


class PagedKVCache(NamedTuple):
    """Device half of the cache."""

    k: torch.Tensor                        # (L, nb, h, bs, d)
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # (L, nb, h, bs) fp32 | None
    v_scale: Optional[torch.Tensor] = None

    def layer(self, i: int):
        """(k, v, k_scale, v_scale) views of layer ``i``: k/v (nb, h,
        bs, d), the scales (nb, h, bs) or None for a float cache."""
        return (self.k[i], self.v[i],
                None if self.k_scale is None else self.k_scale[i],
                None if self.v_scale is None else self.v_scale[i])


def init_cache(config: KVCacheConfig, device=None) -> PagedKVCache:
    """All-zero cache on ``device`` (cuda unless the CPU is asked for);
    zeros keep even an unmasked read of a never-written row finite.  An
    int8 cache gets two distinct scale buffers."""
    dev = resolve_device(device)
    k = torch.zeros(config.kv_shape, dtype=config.storage_dtype,
                    device=dev)
    if config.quantized:
        ks = torch.zeros(config.scale_shape, dtype=torch.float32,
                         device=dev)
        return PagedKVCache(k, torch.zeros_like(k), ks,
                            torch.zeros_like(ks))
    return PagedKVCache(k, torch.zeros_like(k))


def quantize_kv_rows(x: torch.Tensor):
    """Per-row symmetric int8: ``x`` (..., d) -> (int8 codes, (...,)
    fp32 scales), each row against its own amax: ``scale = max(amax,
    1e-8) / 127``, codes ``clip(round(x / scale), -127, 127)``, rounding
    half to even as ``jnp.round``."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp(min=1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def _to_storage(x: torch.Tensor, config: KVCacheConfig):
    """New (..., h, d) rows -> (storage values, (..., h) scales or
    None) per the cache's dtype."""
    if config.quantized:
        return quantize_kv_rows(x)
    return x.to(config.storage_dtype), None


def write_token_kv(cache: PagedKVCache, config: KVCacheConfig, layer: int,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   blocks: torch.Tensor, offsets: torch.Tensor) -> None:
    """Write ONE token's k/v per batch row into layer ``layer``'s page
    slots, in place, quantizing each row for an int8 cache.
    ``k_new``/``v_new`` (b, h, d); ``blocks`` / ``offsets`` (b,) address
    each row's page and in-page slot (inactive rows point at the dump
    block, where duplicate writes race harmlessly)."""
    b, h, _ = k_new.shape
    heads = torch.arange(h, device=k_new.device)[None, :]
    idx = (blocks.long()[:, None], heads, offsets.long()[:, None])
    kl, vl, ksl, vsl = cache.layer(layer)
    if not config.quantized:
        kl[idx] = k_new.to(config.storage_dtype)
        vl[idx] = v_new.to(config.storage_dtype)
        return
    # k and v quantized in one pass (half the launches a layer)
    q, sc = quantize_kv_rows(torch.stack((k_new, v_new)))
    kl[idx], vl[idx] = q[0], q[1]
    ksl[idx], vsl[idx] = sc[0], sc[1]


def write_prefill_kv(cache: PagedKVCache, config: KVCacheConfig,
                     layer: int, k_all: torch.Tensor, v_all: torch.Tensor,
                     blocks: torch.Tensor) -> None:
    """Write a prefilled prompt's whole k/v for one layer into its
    pages, in place, quantizing each row for an int8 cache.
    ``k_all``/``v_all`` (s_pad, h, d) with ``s_pad = len(blocks) *
    block_size``; pages past the owned tail point at the dump block."""
    s_pad, h, d = k_all.shape
    bs = config.block_size
    n_pages = s_pad // bs
    blocks = blocks.long()
    kl, vl, ksl, vsl = cache.layer(layer)
    for dst, sdst, x in ((kl, ksl, k_all), (vl, vsl, v_all)):
        q, sc = _to_storage(x, config)
        # (P*bs, h, d) -> (P, h, bs, d); scales (P*bs, h) -> (P, h, bs)
        dst[blocks] = q.reshape(n_pages, bs, h, d).transpose(1, 2)
        if sc is not None:
            sdst[blocks] = sc.reshape(n_pages, bs, h).transpose(1, 2)


def prefix_chain_keys(prompt: Sequence[int], block_size: int):
    """(full-block chain keys, partial-tail key or None) for a prompt.
    Key ``i`` commits to tokens ``[0, (i+1)*bs)`` — a chain, so matching
    key ``i`` implies matching every earlier block too.  The JAX
    package's hashing convention byte for byte (blake2b over int64
    tokens), so a key names the same content in both packages."""
    bs = int(block_size)
    h = hashlib.blake2b(b"apex-prefix", digest_size=16)
    keys: List[bytes] = []
    full = len(prompt) // bs
    for i in range(full):
        h.update(np.asarray(prompt[i * bs:(i + 1) * bs],
                            np.int64).tobytes())
        keys.append(h.digest())
    pkey = None
    tail = prompt[full * bs:]
    if len(tail):
        hp = h.copy()
        hp.update(b"partial")
        hp.update(np.asarray(tail, np.int64).tobytes())
        pkey = hp.digest()
    return keys, pkey


class PrefixMatch(NamedTuple):
    """What :meth:`KVCacheManager.match_prefix` found for a prompt.

    ``blocks`` are the shared page ids to map (in page order),
    ``tokens`` the prompt positions their cached k/v covers (the
    prefill-skipped span — always ``<= len(prompt) - 1``, so at least
    one tail token runs through the model to produce the first
    generated token), ``cow`` whether the LAST mapped block must be
    copied-on-write before the tail prefill (the full-prompt warm-hit
    case: the tail's write lands inside it)."""

    blocks: Tuple[int, ...]
    tokens: int
    cow: bool

    @property
    def warm(self) -> bool:
        return bool(self.blocks)


_NO_MATCH = PrefixMatch(blocks=(), tokens=0, cow=False)


class KVCacheManager:
    """Host-side block pool + per-request block tables, with optional
    copy-on-write prompt-prefix sharing.

    Free blocks form a LIFO stack, so an evict-then-readmit cycle hands
    the same ids back and the first blocks handed out are 1, 2, 3, ...
    All methods are O(pages touched).

    **Prefix sharing** (``prefix_sharing=True``): full prompt blocks
    are chain-content-hashed into an index (:func:`prefix_chain_keys`),
    plus one entry for the prompt's final partial block.  A shared
    block carries a refcount (the request tables mapping it) and is
    read-only while mapped: a write into it goes through
    :meth:`cow_for_append` / :meth:`make_private`, which swap in a fresh
    private block and hand the caller the (src, dst) pair to copy on
    the device.  A block reaching zero refs parks in an idle LRU (still
    indexed, off the free list), so a later identical prompt still hits
    warm; idle blocks are reclaimed only when the free list is empty.
    ``can_admit`` counts idle blocks as available and a warm request's
    need as its unshared tail."""

    def __init__(self, config: KVCacheConfig, *,
                 prefix_sharing: bool = False):
        self.config = config
        self._free: List[int] = list(range(config.num_blocks - 1, 0, -1))
        self._tables: Dict[object, List[int]] = {}
        self._lens: Dict[object, int] = {}
        self.prefix_sharing = bool(prefix_sharing)
        self._index: Dict[bytes, int] = {}       # chain key -> block
        self._block_key: Dict[int, bytes] = {}   # block -> chain key
        self._refs: Dict[int, int] = {}          # live mappings
        self._idle: "OrderedDict[int, None]" = OrderedDict()
        self._shared_of: Dict[object, set] = {}
        # lifetime counts (the ServeSummary feed)
        self.prefix_hits = 0
        self.cow_copies = 0
        self.shared_blocks_hw = 0

    # --- capacity -----------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def idle_blocks(self) -> int:
        """Shared blocks no live request maps (cached, reclaimable)."""
        return len(self._idle)

    @property
    def available_blocks(self) -> int:
        """What an allocation can draw on: the free list plus idle
        shared blocks (reclaimed LRU-first on demand)."""
        return len(self._free) + len(self._idle)

    @property
    def shared_blocks(self) -> int:
        return len(self._block_key)

    @property
    def used_blocks(self) -> int:
        return self.config.usable_blocks - len(self._free)

    def can_admit(self, prompt_len: int, max_new_tokens: int, *,
                  reserved_blocks: int = 0,
                  prefix: Optional[PrefixMatch] = None) -> bool:
        """Reservation admission: the request's whole worst case
        (prompt + max_new_tokens) must fit the pool now, net of
        ``reserved_blocks`` already owed to in-flight requests — so a
        later :meth:`append` can never exhaust the pool mid-decode.  A
        warm ``prefix`` bills only the unshared tail (plus one block
        when ``prefix.cow`` will copy the last mapped page); matched
        blocks parked idle are not counted as available."""
        blocks = prefix.blocks if prefix is not None else ()
        cow = prefix.cow if prefix is not None else False
        idle_matched = sum(1 for b in blocks if b in self._idle)
        need = self.config.blocks_for(prompt_len + max_new_tokens) \
            - len(blocks) + (1 if cow else 0)
        return need <= self.available_blocks - idle_matched \
            - reserved_blocks

    # --- prefix index -------------------------------------------------

    def match_prefix(self, prompt: Sequence[int]) -> PrefixMatch:
        """Longest warm prefix of ``prompt`` in the shared index.  Never
        covers the final token (the tail prefill must emit the first
        generated token); a match reaching the whole prompt maps every
        page and flags the last one for copy-on-write instead."""
        if not self.prefix_sharing or len(prompt) < 2:
            return _NO_MATCH
        keys, pkey = prefix_chain_keys(prompt, self.config.block_size)
        blocks: List[int] = []
        for key in keys:
            blk = self._index.get(key)
            if blk is None:
                break
            blocks.append(blk)
        tokens = len(blocks) * self.config.block_size
        cow = False
        if len(blocks) == len(keys) and pkey is not None:
            blk = self._index.get(pkey)
            if blk is not None:
                blocks.append(blk)
                tokens = len(prompt)
        if not blocks:
            return _NO_MATCH
        if tokens >= len(prompt):
            # full-prompt hit: the tail is the final token, whose page
            # is the last mapped block — copy-on-write before writing
            tokens = len(prompt) - 1
            cow = True
        return PrefixMatch(blocks=tuple(blocks), tokens=tokens, cow=cow)

    def register_prefix(self, rid, prompt: Sequence[int]) -> int:
        """Index ``rid``'s freshly prefilled prompt pages as shared:
        every full block plus the final partial block, keyed by the
        content chain.  Pages already mapped from the index stay as
        they are; content another block already owns is not registered
        again (the first writer wins).  Returns the number of newly
        registered blocks.  Call only after the prompt's k/v is fully
        written."""
        if not self.prefix_sharing:
            return 0
        keys, pkey = prefix_chain_keys(prompt, self.config.block_size)
        table = self._tables[rid]
        shared = self._shared_of.setdefault(rid, set())
        entries = list(enumerate(keys))
        if pkey is not None:
            entries.append((len(keys), pkey))
        new = 0
        for page, key in entries:
            blk = table[page]
            if key in self._index or blk in self._block_key:
                continue                  # mapped warm, or a duplicate
            self._index[key] = blk
            self._block_key[blk] = key
            self._refs[blk] = 1
            shared.add(blk)
            new += 1
        self.shared_blocks_hw = max(self.shared_blocks_hw,
                                    len(self._block_key))
        return new

    def _map_shared(self, rid, blk: int) -> None:
        self._refs[blk] = self._refs.get(blk, 0) + 1
        self._idle.pop(blk, None)
        self._shared_of.setdefault(rid, set()).add(blk)

    def _unmap_shared(self, blk: int) -> None:
        self._refs[blk] -= 1
        if self._refs[blk] == 0:
            self._idle[blk] = None        # cached, reclaimable LRU

    def _take_block(self, why: str) -> int:
        """One block off the free list, reclaiming the LRU idle shared
        block (unregistering its prefix entry) when the list is dry."""
        if self._free:
            return self._free.pop()
        if self._idle:
            blk, _ = self._idle.popitem(last=False)
            del self._index[self._block_key.pop(blk)]
            del self._refs[blk]
            return blk
        raise CachePoolExhausted(why)

    def is_shared(self, rid, block: int) -> bool:
        """Whether ``block`` is a read-only shared mapping in ``rid``'s
        table (a write must copy it first)."""
        return block in self._shared_of.get(rid, ())

    # --- lifecycle ----------------------------------------------------

    def alloc(self, rid, length: int, *,
              shared_blocks: Sequence[int] = ()) -> List[int]:
        """Claim blocks covering ``length`` tokens for a new request.
        ``shared_blocks`` (from :meth:`match_prefix`) are mapped
        read-only as the table's leading pages — refcounted, never
        drawn from the pool — and only the tail is allocated."""
        if rid in self._tables:
            raise ValueError(f"request {rid!r} already has blocks")
        if length < 1:
            raise ValueError("length must be >= 1")
        need = self.config.blocks_for(length) - len(shared_blocks)
        if need < 0:
            raise ValueError(
                f"request {rid!r}: {len(shared_blocks)} shared pages "
                f"exceed the {self.config.blocks_for(length)} pages "
                f"length {length} occupies")
        idle_matched = sum(1 for b in shared_blocks if b in self._idle)
        if need > self.available_blocks - idle_matched:
            raise CachePoolExhausted(
                f"request {rid!r} needs {need} block(s) for length "
                f"{length}, pool has {self.available_blocks} available "
                f"of {self.config.usable_blocks}")
        blocks = list(shared_blocks)
        for blk in shared_blocks:
            self._map_shared(rid, blk)
        blocks.extend(self._take_block(
            f"request {rid!r}: pool drained mid-alloc")
            for _ in range(need))
        self._tables[rid] = blocks
        self._lens[rid] = int(length)
        if shared_blocks:
            self.prefix_hits += 1
        return list(blocks)

    def cow_for_append(self, rid):
        """Copy-on-write guard for the next :meth:`append`: when the
        slot the next token lands in sits inside a shared page, swap in
        a private block and return ``(src, dst)`` for the caller to
        copy on the device; None when the next write is private."""
        page = self._lens[rid] // self.config.block_size
        if page >= len(self._tables[rid]):
            return None                   # the append opens a new page
        return self.make_private(rid, page)

    def make_private(self, rid, page: int):
        """Copy-on-write of page ``page`` of ``rid``'s table if it is a
        shared mapping: a private replacement takes its place and the
        shared ref is released.  Returns ``(src_block, dst_block)`` to
        copy on the device, or None if the page is already private."""
        blocks = self._tables[rid]
        src = blocks[page]
        if not self.is_shared(rid, src):
            return None
        dst = self._take_block(
            f"request {rid!r}: no block for the copy-on-write of "
            f"shared page {page}")
        blocks[page] = dst
        self._shared_of[rid].discard(src)
        self._unmap_shared(src)
        self.cow_copies += 1
        return src, dst

    def pending_cow_blocks(self, rid) -> int:
        """1 when ``rid``'s next append will copy a shared page (the
        reservation must hold that block back), else 0."""
        page = self._lens[rid] // self.config.block_size
        blocks = self._tables[rid]
        return int(page < len(blocks) and self.is_shared(rid, blocks[page]))

    def append(self, rid):
        """Grow ``rid`` by one token, taking a fresh block when the
        token starts a new page.  Returns ``(block_id, offset)``, the
        slot the new token's k/v goes to (its position is the
        pre-append length).  Writing into a shared page raises: call
        :meth:`cow_for_append` first."""
        blocks = self._tables[rid]
        pos = self._lens[rid]
        page, off = divmod(pos, self.config.block_size)
        if page == len(blocks):
            blocks.append(self._take_block(
                f"request {rid!r} crossed a block edge at length "
                f"{pos + 1} with the pool empty — admission control "
                f"must keep headroom (can_admit)"))
        elif self.is_shared(rid, blocks[page]):
            raise RuntimeError(
                f"request {rid!r}: append would write into shared page "
                f"{page} (block {blocks[page]}) — the caller must "
                f"cow_for_append() first")
        self._lens[rid] = pos + 1
        return blocks[page], off

    def truncate(self, rid, new_len: int) -> List[int]:
        """Roll ``rid``'s write cursor back to ``new_len`` tokens (the
        speculative rejection), returning pages past the new end to the
        pool.  A rollback never reaches below the prompt, so it only
        sheds private blocks the same tick's appends claimed."""
        if not 1 <= new_len <= self._lens[rid]:
            raise ValueError(
                f"request {rid!r}: truncate to {new_len} outside "
                f"[1, {self._lens[rid]}]")
        blocks = self._tables[rid]
        keep = self.config.blocks_for(new_len)
        freed: List[int] = []
        while len(blocks) > keep:
            blk = blocks.pop()
            if blk in self._block_key:
                raise RuntimeError(
                    f"request {rid!r}: truncate would free shared block "
                    f"{blk} — rollback crossed the prompt")
            self._free.append(blk)
            freed.append(blk)
        self._lens[rid] = int(new_len)
        return freed

    def free(self, rid) -> List[int]:
        """Return ``rid``'s blocks to the pool (reverse order, so a
        readmit walks them back out first-block-first).  Shared
        mappings are unreferenced instead: a block another table still
        maps stays live, one reaching zero refs parks in the idle LRU."""
        blocks = self._tables.pop(rid)
        del self._lens[rid]
        shared = self._shared_of.pop(rid, set())
        for blk in reversed(blocks):
            if blk in shared:
                self._unmap_shared(blk)
            else:
                self._free.append(blk)
        return blocks

    # --- views --------------------------------------------------------

    def seq_len(self, rid) -> int:
        return self._lens[rid]

    def num_pages(self, rid) -> int:
        return len(self._tables[rid])

    def blocks(self, rid) -> List[int]:
        return list(self._tables[rid])

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
