"""Continuous-batching serving engine (greedy decode) in PyTorch.

Port of ``apex_tpu/serving/engine.py`` on one device, with float or
Q8 (int8 weight-only) weights and a float or int8 KV cache, including
its fast path: speculative decoding with a draft model,
chunked prefill and copy-on-write prompt-prefix sharing.  The loop
alternates two worlds on a fixed cadence:

* **between** steps (host, this module): finished requests are evicted
  (their cache blocks return to the pool), one pending prefill chunk
  advances, queued requests are admitted (blocks allocated, a warm
  prefix mapped, the prompt prefilled through the flash-attention
  kernel or queued for chunks), and the next decode batch is assembled;
* **inside** a step (:mod:`.model`): one prefill per cold admission, then
  one batched decode step per tick through the paged flash-decode
  kernel, greedy argmax on the device, one int per row fetched back.
  With ``speculate_k = K`` a tick is K draft decode steps and one
  target extend step over K+1 positions through the multi-token paged
  kernel; greedy-match acceptance keeps the output identical to plain
  greedy decode.  Chunked and warm-tail prefills run the same extend
  step.

Shapes are **bucketed** as in the JAX engine: the decode batch rounds up
to a :class:`BucketLadder` batch rung and the page span to a page rung,
prompts pad to a page rung times the block size.  PyTorch runs eagerly,
so the ladder compiles nothing here; it keeps the step shapes of the two
engines equal, and with them the padding rows the kernels must handle.

Admission is **reservation-based**: a request is admitted only when the
pool covers its whole worst case (prompt + max new tokens), so a decode
can never exhaust the pool mid-flight.

Left out (later slices port them): deadlines and load shedding, the
request journal, the metrics plane, tensor and expert parallelism, the
fleet's prefix export/import, and ``swap_weights`` (with its bf16 <->
int8 requantization).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from .kv_cache import (DUMP_BLOCK, KVCacheConfig, KVCacheManager,
                       PrefixMatch, init_cache)
from ..ops.quant_matmul import is_quantized_weights
from .model import (GPTServingWeights, ServingModelConfig, copy_cache_block,
                    gpt_decode_step, gpt_extend_step, gpt_prefill_step)
from .resilience import SpeculationGovernor
from .weights import check_serving_weights

__all__ = ["Request", "BucketLadder", "ServingEngine", "ServeSummary",
           "default_cache_config", "parse_ladder"]

# latency samples kept for the percentile window
_LATENCY_WINDOW = 100_000

# the port's defaults: GPT-345M's max_seq 1024 = 64 pages of 16 tokens
DEFAULT_BATCH_BUCKETS = "1,2,4,8"
DEFAULT_PAGE_BUCKETS = "4,8,16,32,64"
DEFAULT_BLOCK_SIZE = 16
DEFAULT_NUM_BLOCKS = 512


def parse_ladder(raw: str) -> Tuple[int, ...]:
    """``"1,2,4"`` -> ``(1, 2, 4)``: sorted, deduplicated, positive."""
    vals = tuple(sorted({int(x) for x in raw.split(",") if x.strip()}))
    if not vals or vals[0] < 1:
        raise ValueError(f"bucket ladder {raw!r} must name positive "
                         f"integers")
    return vals


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """The registered (batch, pages[, prefill-chunk]) shape ladder;
    ``pick_*`` rounds a live size up to the smallest rung.  ``chunks``
    is the prefill-chunk token dimension: empty means one single-block
    rung plus one whole-padded-prompt rung per page rung (the warm-tail
    shapes when chunked prefill is off)."""

    batch: Tuple[int, ...] = parse_ladder(DEFAULT_BATCH_BUCKETS)
    pages: Tuple[int, ...] = parse_ladder(DEFAULT_PAGE_BUCKETS)
    chunks: Tuple[int, ...] = ()

    @staticmethod
    def _pick(rungs: Tuple[int, ...], n: int, what: str) -> int:
        for r in rungs:
            if n <= r:
                return r
        raise ValueError(f"{what} {n} exceeds the ladder {rungs} — "
                         f"register a bigger rung or admit less")

    def pick_batch(self, n: int) -> int:
        return self._pick(self.batch, n, "batch size")

    def pick_pages(self, n: int) -> int:
        return self._pick(self.pages, n, "page span")

    def chunk_rungs(self, block_size: int) -> Tuple[int, ...]:
        """The prefill-chunk rungs: the registered ones, or a single
        block plus one whole-padded-prompt rung per page rung."""
        if self.chunks:
            return self.chunks
        return tuple(sorted({block_size}
                            | {p * block_size for p in self.pages}))

    def pick_chunk(self, n: int, block_size: int) -> int:
        """Round a chunk of ``n`` tokens up to the smallest chunk rung;
        a tail longer than every rung takes the largest rung per tick
        (the caller loops)."""
        rungs = self.chunk_rungs(block_size)
        for r in rungs:
            if n <= r:
                return r
        return rungs[-1]

    @property
    def max_batch(self) -> int:
        return self.batch[-1]

    @property
    def max_pages(self) -> int:
        return self.pages[-1]


@dataclasses.dataclass
class Request:
    """One generation request and its accumulated results."""

    rid: Any
    prompt: List[int]
    max_new_tokens: int
    eos_token: Optional[int] = None
    # engine-owned:
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    token_latency_s: List[float] = dataclasses.field(default_factory=list)
    admitted_at_step: Optional[int] = None
    submit_t: Optional[float] = None
    # admission start to first token (the whole prefill, chunks and
    # copy-on-write included)
    prefill_s: Optional[float] = None
    terminal: Optional[str] = None

    @property
    def done(self) -> bool:
        if self.out_tokens and self.eos_token is not None \
                and self.out_tokens[-1] == self.eos_token:
            return True
        return len(self.out_tokens) >= self.max_new_tokens


@dataclasses.dataclass
class ServeSummary:
    """What a serve run measured (the ``--serve`` row source)."""

    requests_done: int
    tokens_generated: int
    prefill_tokens: int
    wall_s: float
    decode_steps: int
    tokens_per_sec: float
    # decode ticks only (prefill wall excluded)
    decode_wall_s: float
    decode_tokens_per_sec: float
    # per generated token: the prefill wall for a first token, the
    # decode tick wall for every later one
    latency_p50_ms: Optional[float]
    latency_p99_ms: Optional[float]
    queue_wait_p50_ms: Optional[float] = None
    queue_wait_p99_ms: Optional[float] = None
    ttft_p50_ms: Optional[float] = None
    ttft_p99_ms: Optional[float] = None
    itl_p50_ms: Optional[float] = None
    itl_p99_ms: Optional[float] = None
    requests_rejected: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    device: str = "cpu"
    # the fast path: speculative acceptance (None when speculation is
    # off), prompt-prefix sharing (warm admissions, prefill tokens
    # skipped, shared-block high water, copy-on-write count), chunked
    # prefill volume, and whether the governor turned speculation off
    spec_accept_rate: Optional[float] = None
    spec_tokens_proposed: int = 0
    spec_tokens_accepted: int = 0
    warm_prefix_admissions: int = 0
    prefix_hit_tokens: int = 0
    shared_blocks_hw: int = 0
    cow_copies: int = 0
    prefill_chunks: int = 0
    spec_disabled: bool = False


def _percentile_ms(xs: Sequence[float], q: float) -> Optional[float]:
    if not len(xs):
        return None
    return float(np.percentile(np.asarray(xs, np.float64), q)) * 1e3


@dataclasses.dataclass
class _PrefillJob:
    """An admitted request whose prompt k/v is still being written: its
    blocks are owned (shared prefix mapped), ``written`` positions are
    valid.  Advanced one chunk per tick (chunked prefill) or drained at
    admission (the warm tail with chunking off)."""

    req: Request
    tokens: np.ndarray            # the whole prompt, int64
    written: int                  # k/v-valid positions so far
    start: int                    # prefix-shared positions (skipped)
    admit_t: float                # prefill-start instant


def default_cache_config(model_cfg: ServingModelConfig,
                         num_blocks: int = DEFAULT_NUM_BLOCKS,
                         block_size: int = DEFAULT_BLOCK_SIZE,
                         kv_dtype: str = "model") -> KVCacheConfig:
    """Cache plan for ``model_cfg``: ``num_blocks`` blocks (dump block
    included) of ``block_size`` tokens, k/v stored as ``kv_dtype``
    (``model``: the model's dtype, ``bf16``, or ``int8`` with per-row
    scales)."""
    return KVCacheConfig(
        num_layers=model_cfg.num_layers, num_heads=model_cfg.num_heads,
        head_dim=model_cfg.head_dim, num_blocks=num_blocks,
        block_size=block_size, dtype=model_cfg.dtype, kv_dtype=kv_dtype)


class ServingEngine:
    """Continuous-batching loop over one model + one paged cache on
    one device (cuda unless ``device="cpu"``; the weights must already
    be there).

    The fast path (all off by default): ``speculate_k = K > 0`` with a
    draft model (``draft_weights`` + ``draft_cfg``; the draft may be the
    target itself) proposes K tokens a tick, verified by one target
    extend step; ``spec_governor`` (``"auto"``: a default
    :class:`SpeculationGovernor` when speculating, or None) turns
    speculation off after sustained low acceptance.  ``prefill_chunk =
    N > 0`` admits prompts in N-token chunks, one chunk a tick beside
    decode.  ``prefix_share`` maps warm prompt prefixes as shared,
    copy-on-write pages."""

    def __init__(self, weights: GPTServingWeights,
                 model_cfg: ServingModelConfig, cache_cfg: KVCacheConfig,
                 *, ladder: Optional[BucketLadder] = None, device=None,
                 speculate_k: int = 0,
                 draft_weights: Optional[GPTServingWeights] = None,
                 draft_cfg: Optional[ServingModelConfig] = None,
                 prefill_chunk: int = 0, prefix_share: bool = False,
                 spec_governor="auto",
                 clock: Callable[[], float] = time.perf_counter):
        self.device = resolve_device(device)
        if weights.wte.device != self.device:
            raise ValueError(f"weights are on {weights.wte.device}, the "
                             f"engine on {self.device}")
        if (cache_cfg.num_heads, cache_cfg.head_dim,
                cache_cfg.num_layers) != (model_cfg.num_heads,
                                          model_cfg.head_dim,
                                          model_cfg.num_layers):
            raise ValueError("cache config geometry does not match the "
                             "model's")
        if is_quantized_weights(weights) or any(
                hasattr(lw, "router") for lw in weights.layers):
            # a Q8 tree (int8 codes with fp32 column scales) or MoE layers
            # (an fp32 router, cfg.num_experts experts): the shapes the
            # config names (the kernels would refuse anything else)
            check_serving_weights(weights, model_cfg)
        self.weights = weights
        self.model_cfg = model_cfg
        self.cache_cfg = cache_cfg
        self.ladder = ladder if ladder is not None else BucketLadder()
        if self.ladder.max_pages > cache_cfg.usable_blocks:
            raise ValueError(
                f"page ladder max {self.ladder.max_pages} exceeds the "
                f"pool's {cache_cfg.usable_blocks} usable blocks")
        self._clock = clock
        self.speculate_k = int(speculate_k)
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk > 0 and not self.ladder.chunks:
            self.ladder = dataclasses.replace(
                self.ladder, chunks=(self.prefill_chunk,))
        self.prefix_share = bool(prefix_share)
        if self.speculate_k > 0 and draft_weights is None:
            raise ValueError(
                "speculate_k > 0 needs a draft model: pass draft_weights "
                "and draft_cfg (the target's own weights make a self "
                "draft)")
        self.draft_weights = draft_weights
        self.draft_cfg = draft_cfg
        self.draft_cache_cfg: Optional[KVCacheConfig] = None
        self.draft_cache = None
        if draft_weights is not None:
            if draft_cfg is None:
                raise ValueError("draft_weights without draft_cfg")
            if draft_weights.wte.device != self.device:
                raise ValueError(f"draft weights are on "
                                 f"{draft_weights.wte.device}, the engine "
                                 f"on {self.device}")
            if is_quantized_weights(draft_weights):
                check_serving_weights(draft_weights, draft_cfg)
            # the draft's cache has its own layers and heads but the
            # target's pool geometry and storage dtype: one manager's
            # (block, offset) slot names the same page in both caches, so
            # shared and copied pages mirror for free
            self.draft_cache_cfg = KVCacheConfig(
                num_layers=draft_cfg.num_layers,
                num_heads=draft_cfg.num_heads,
                head_dim=draft_cfg.head_dim,
                num_blocks=cache_cfg.num_blocks,
                block_size=cache_cfg.block_size, dtype=draft_cfg.dtype,
                kv_dtype=cache_cfg.kv_dtype)
            self.draft_cache = init_cache(self.draft_cache_cfg, self.device)
        if spec_governor == "auto":
            self.spec_governor = SpeculationGovernor() \
                if self.speculate_k > 0 else None
        else:
            self.spec_governor = spec_governor
        self.spec_disabled = False
        self.manager = KVCacheManager(cache_cfg,
                                      prefix_sharing=self.prefix_share)
        self.cache = init_cache(cache_cfg, self.device)
        self.queue: deque = deque()
        self.active: Dict[Any, Request] = {}
        # admitted requests whose chunked prefill is still running,
        # advanced one chunk a tick, oldest first
        self.prefilling: Dict[Any, _PrefillJob] = {}
        self.done: List[Request] = []
        self.steps = 0
        self.prefill_tokens = 0
        self.prefill_chunks = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        # (rid, index in out_tokens) of every rejected draft token: the
        # target's token there replaced the proposal, and the row rolled
        # back
        self.spec_rejections: List[Tuple[Any, int]] = []
        self._warm_admissions = 0
        self._prefix_hit_tokens = 0
        self._run_wall_s = 0.0
        self._latencies: deque = deque(maxlen=_LATENCY_WINDOW)
        self._queue_wait: deque = deque(maxlen=_LATENCY_WINDOW)
        self._ttft: deque = deque(maxlen=_LATENCY_WINDOW)
        self._itl: deque = deque(maxlen=_LATENCY_WINDOW)
        self._done_count = 0
        self._done_tokens = 0
        self._rejected: Dict[str, int] = {}
        self.decode_wall_s = 0.0
        self.decode_tokens = 0

    # --- request lifecycle --------------------------------------------

    def _reject(self, reason: str, msg: str) -> None:
        self._rejected[reason] = self._rejected.get(reason, 0) + 1
        raise ValueError(msg)

    def submit(self, request: Request) -> None:
        if len(request.prompt) < 1:
            self._reject("empty_prompt",
                         f"request {request.rid!r}: empty prompt")
        if request.max_new_tokens < 1:
            self._reject("max_new_tokens",
                         f"request {request.rid!r}: max_new_tokens "
                         f"{request.max_new_tokens} < 1")
        limit = self.ladder.max_pages * self.cache_cfg.block_size
        worst = len(request.prompt) + request.max_new_tokens
        if worst > limit:
            self._reject("ladder_span",
                         f"request {request.rid!r}: prompt + "
                         f"max_new_tokens = {worst} exceeds the "
                         f"ladder's {limit}-token span")
        if worst > self.model_cfg.max_seq:
            self._reject("max_seq",
                         f"request {request.rid!r}: {worst} tokens "
                         f"exceed the model's max_seq "
                         f"{self.model_cfg.max_seq}")
        if request.submit_t is None:
            request.submit_t = self._clock()
        self.queue.append(request)

    def _reserved_blocks(self) -> int:
        """Blocks the free pool already owes to in-flight requests
        (active and mid-prefill): each may still grow to its worst case
        (prompt + max_new), and one whose next append will copy a shared
        page owes the replacement block too."""
        total = 0
        in_flight = list(self.active.items()) \
            + [(rid, job.req) for rid, job in self.prefilling.items()]
        for rid, req in in_flight:
            worst = self.cache_cfg.blocks_for(
                len(req.prompt) + req.max_new_tokens)
            total += max(0, worst - self.manager.num_pages(rid))
            if self.prefix_share:
                total += self.manager.pending_cow_blocks(rid)
        return total

    def _tensor(self, a: np.ndarray, dtype=torch.int32) -> torch.Tensor:
        return torch.from_numpy(a).to(device=self.device, dtype=dtype)

    def _cow_copy(self, src: int, dst: int) -> None:
        """Copy-on-write of one page on the device, mirrored into the
        draft's cache (the same block ids by construction)."""
        copy_cache_block(self.cache, src, dst)
        if self.draft_cache is not None:
            copy_cache_block(self.draft_cache, src, dst)

    def _first_token(self, req: Request, first: int, dt: float,
                     t_admit: float) -> None:
        """The prefill's token: the request joins the decode set."""
        now = self._clock()
        req.out_tokens.append(first)
        req.token_latency_s.append(dt)
        req.prefill_s = now - t_admit
        self._latencies.append(dt)
        self._ttft.append(now - req.submit_t)
        self.active[req.rid] = req

    def _admit(self, req: Request,
               prefix: Optional[PrefixMatch] = None) -> None:
        """Admit ``req``: allocate its blocks (a warm prefix mapped
        shared, a full-prompt hit's last page copied private), then
        either prefill the whole prompt through the flash-attention
        kernel (cold, chunking off; the draft's prefill beside it) or
        queue the prompt for extend-step chunks (chunked prefill, or a
        warm tail drained here when chunking is off)."""
        p_len = len(req.prompt)
        t0 = self._clock()
        if prefix is None:
            prefix = self.manager.match_prefix(req.prompt)
        self.manager.alloc(req.rid, p_len, shared_blocks=prefix.blocks)
        if prefix.warm:
            self._warm_admissions += 1
            self._prefix_hit_tokens += prefix.tokens
        if prefix.cow:
            cow = self.manager.make_private(req.rid,
                                            len(prefix.blocks) - 1)
            if cow is not None:
                self._cow_copy(*cow)
        req.admitted_at_step = self.steps
        self._queue_wait.append(t0 - req.submit_t)
        if not prefix.warm and self.prefill_chunk <= 0:
            bs = self.cache_cfg.block_size
            pb = self.ladder.pick_pages(self.cache_cfg.blocks_for(p_len))
            s_pad = pb * bs
            bt = self._tensor(self.manager.block_table(req.rid, pb))
            tokens = np.zeros(s_pad, np.int64)
            tokens[:p_len] = req.prompt
            tokens = self._tensor(tokens, torch.long)
            with torch.inference_mode():
                _, next_token = gpt_prefill_step(
                    self.weights, self.model_cfg, self.cache_cfg,
                    self.cache, tokens, p_len, bt)
                if self.draft_cache is not None:
                    gpt_prefill_step(self.draft_weights, self.draft_cfg,
                                     self.draft_cache_cfg, self.draft_cache,
                                     tokens, p_len, bt)
                first = int(next_token)      # the admission's host sync
            self._first_token(req, first, self._clock() - t0, t0)
            self.prefill_tokens += p_len
            self.manager.register_prefix(req.rid, req.prompt)
            return
        job = _PrefillJob(req=req, tokens=np.asarray(req.prompt, np.int64),
                          written=prefix.tokens, start=prefix.tokens,
                          admit_t=t0)
        if self.prefill_chunk > 0:
            self.prefilling[req.rid] = job
            return
        while not self._prefill_step(job):
            pass

    def _prefill_step(self, job: _PrefillJob) -> bool:
        """Write one prefill chunk of ``job``'s prompt through the extend
        step: the valid tokens back-aligned in the chunk rung, the front
        padding writing to the dump page.  On the chunk that completes
        the prompt, read the first generated token (the only host read)
        and move the request into the decode set.  Returns True when the
        prefill finished."""
        req = job.req
        p_len = len(job.tokens)
        bs = self.cache_cfg.block_size
        rem = p_len - job.written
        ct = self.ladder.pick_chunk(rem, bs)
        n = min(rem, ct)
        pb = self.ladder.pick_pages(self.manager.num_pages(req.rid))
        bt = self.manager.block_table(req.rid, pb)
        table = self.manager.blocks(req.rid)
        toks = np.zeros((1, ct), np.int64)
        wb = np.full((1, ct), DUMP_BLOCK, np.int32)
        wo = np.zeros((1, ct), np.int32)
        toks[0, ct - n:] = job.tokens[job.written:job.written + n]
        p = np.arange(job.written, job.written + n)
        wb[0, ct - n:] = np.asarray(table, np.int32)[p // bs]
        wo[0, ct - n:] = p % bs
        args = (self._tensor(toks, torch.long), self._tensor(bt[None]),
                self._tensor(np.asarray([job.written + n], np.int32)),
                self._tensor(wb), self._tensor(wo))
        t0 = self._clock()
        with torch.inference_mode():
            _, out = gpt_extend_step(self.weights, self.model_cfg,
                                     self.cache_cfg, self.cache, *args)
            if self.draft_cache is not None:
                gpt_extend_step(self.draft_weights, self.draft_cfg,
                                self.draft_cache_cfg, self.draft_cache,
                                *args)
            job.written += n
            self.prefill_chunks += 1
            done = job.written >= p_len
            first = int(out[0, -1]) if done else None
        if done:
            self._first_token(req, first, self._clock() - t0, job.admit_t)
            self.prefill_tokens += p_len - job.start
            self.manager.register_prefix(req.rid, job.tokens)
        return done

    def _finish(self, req: Request) -> None:
        req.terminal = "finished"
        self.manager.free(req.rid)
        del self.active[req.rid]
        self.done.append(req)
        self._done_count += 1
        self._done_tokens += len(req.out_tokens)
        self._itl.extend(req.token_latency_s[1:])

    def _evict_finished(self) -> None:
        for rid in [r for r, q in self.active.items() if q.done]:
            self._finish(self.active[rid])

    # --- the engine tick ----------------------------------------------

    def step(self) -> int:
        """One tick: evict finished requests, advance the oldest pending
        prefill by one chunk, admit queued requests while the batch
        ladder (active + prefilling) and the pool's reservations allow,
        then run one bucketed decode step — speculative when
        ``speculate_k > 0`` — over every active request.  Returns the
        number of tokens generated this tick."""
        self._evict_finished()
        if self.prefilling:
            rid = next(iter(self.prefilling))
            if self._prefill_step(self.prefilling[rid]):
                del self.prefilling[rid]
        while self.queue and (len(self.active) + len(self.prefilling)
                              < self.ladder.max_batch):
            req = self.queue[0]
            prefix = self.manager.match_prefix(req.prompt)
            if not self.manager.can_admit(
                    len(req.prompt), req.max_new_tokens,
                    reserved_blocks=self._reserved_blocks(),
                    prefix=prefix):
                break
            self._admit(self.queue.popleft(), prefix=prefix)
        # requests may finish at admission (max_new_tokens == 1)
        self._evict_finished()
        if not self.active:
            return 0
        reqs = [self.active[r] for r in sorted(self.active, key=str)]
        if self.speculate_k > 0:
            return self._spec_tick(reqs)
        return self._decode_tick(reqs)

    def _append_slot(self, req: Request):
        """One KV append with the copy-on-write guard: a slot inside a
        shared page copies the page private first."""
        if self.prefix_share:
            cow = self.manager.cow_for_append(req.rid)
            if cow is not None:
                self._cow_copy(*cow)
        return self.manager.append(req.rid)

    def _decode_tick(self, reqs: List[Request]) -> int:
        n = len(reqs)
        bb = self.ladder.pick_batch(n)
        slots = [self._append_slot(q) for q in reqs]
        pb = self.ladder.pick_pages(
            max(self.manager.num_pages(q.rid) for q in reqs))
        tokens = np.zeros(bb, np.int64)
        positions = np.zeros(bb, np.int64)
        seq_lens = np.zeros(bb, np.int32)
        wb = np.full(bb, DUMP_BLOCK, np.int32)
        wo = np.zeros(bb, np.int32)
        bt = np.full((bb, pb), DUMP_BLOCK, np.int32)
        for i, (q, (blk, off)) in enumerate(zip(reqs, slots)):
            new_len = self.manager.seq_len(q.rid)      # post-append
            tokens[i] = q.out_tokens[-1]
            positions[i] = new_len - 1
            seq_lens[i] = new_len
            wb[i], wo[i] = blk, off
            bt[i] = self.manager.block_table(q.rid, pb)
        t0 = self._clock()
        with torch.inference_mode():
            _, next_tokens = gpt_decode_step(
                self.weights, self.model_cfg, self.cache_cfg, self.cache,
                self._tensor(tokens, torch.long),
                self._tensor(positions, torch.long), self._tensor(bt),
                self._tensor(seq_lens), self._tensor(wb),
                self._tensor(wo))
            out = next_tokens.cpu().numpy()      # the tick's one fetch
        dt = self._clock() - t0
        for i, q in enumerate(reqs):
            q.out_tokens.append(int(out[i]))
            q.token_latency_s.append(dt)
            self._latencies.append(dt)
        self.decode_wall_s += dt
        self.decode_tokens += n
        self.steps += 1
        return n

    def _draft_step(self, toks, pos, bt, sl, wb, wo):
        """One draft decode step; returns its next tokens on the
        device."""
        _, nt = gpt_decode_step(
            self.draft_weights, self.draft_cfg, self.draft_cache_cfg,
            self.draft_cache, toks, self._tensor(pos, torch.long), bt,
            self._tensor(sl), self._tensor(wb), self._tensor(wo))
        return nt

    def _spec_tick(self, reqs: List[Request]) -> int:
        """One speculative tick: the draft proposes K tokens (K decode
        steps), the target scores all K+1 positions in one extend step,
        and greedy-match acceptance keeps the longest agreeing draft
        prefix plus one target token — every emitted token is what plain
        greedy decode emits, and a row advances 1..K+1 tokens.  Rejected
        positions roll the write cursor back (``truncate``); on full
        acceptance the draft catches up the one position only the
        target wrote, so the next tick's proposals read real k/v.  The
        draft's tokens stay on the device; the tick reads the host
        once."""
        K = self.speculate_k
        T = K + 1
        n = len(reqs)
        bb = self.ladder.pick_batch(n)
        base = np.zeros(bb, np.int64)
        caps = np.zeros(bb, np.int64)
        slots: List[List[Tuple[int, int]]] = []
        for i, q in enumerate(reqs):
            base[i] = self.manager.seq_len(q.rid)
            # a row near its token budget writes fewer real slots (the
            # reservation caps the pages a tick may claim); its overshoot
            # positions write to the dump page and their logits go unused
            caps[i] = max(1, min(T, q.max_new_tokens - len(q.out_tokens)))
            row = [self._append_slot(q)]
            row += [self.manager.append(q.rid)
                    for _ in range(int(caps[i]) - 1)]
            slots.append(row)
        pb = self.ladder.pick_pages(
            max(self.manager.num_pages(q.rid) for q in reqs))
        bt = np.full((bb, pb), DUMP_BLOCK, np.int32)
        prev = np.zeros(bb, np.int64)
        for i, q in enumerate(reqs):
            bt[i] = self.manager.block_table(q.rid, pb)
            prev[i] = q.out_tokens[-1]
        t0 = self._clock()
        with torch.inference_mode():
            bt_t = self._tensor(bt)
            toks = self._tensor(prev, torch.long)
            proposals = []
            for k in range(1, K + 1):
                pos = np.zeros(bb, np.int64)
                sl = np.zeros(bb, np.int32)
                wbk = np.full(bb, DUMP_BLOCK, np.int32)
                wok = np.zeros(bb, np.int32)
                pos[:n] = base[:n] + k - 1
                sl[:n] = base[:n] + k
                for i in range(n):
                    if k - 1 < caps[i]:
                        wbk[i], wok[i] = slots[i][k - 1]
                toks = self._draft_step(toks, pos, bt_t, sl, wbk, wok)
                proposals.append(toks)
            # target verification: one teacher-forced extend step over
            # the last token and the K proposals
            vt = torch.stack([self._tensor(prev, torch.long)] + proposals,
                             dim=1)
            slv = np.zeros(bb, np.int32)
            slv[:n] = base[:n] + T
            wbv = np.full((bb, T), DUMP_BLOCK, np.int32)
            wov = np.zeros((bb, T), np.int32)
            for i in range(n):
                for j, (blk, off) in enumerate(slots[i]):
                    wbv[i, j], wov[i, j] = blk, off
            _, out = gpt_extend_step(
                self.weights, self.model_cfg, self.cache_cfg, self.cache,
                vt, bt_t, self._tensor(slv), self._tensor(wbv),
                self._tensor(wov))
            # the tick's one host read: target tokens (T) and proposals (K)
            both = torch.cat([out, vt[:, 1:]], dim=1).cpu().numpy()
        a, d = both[:, :T], both[:, T:]
        gained = 0
        full_rows: List[int] = []
        keeps: List[int] = []
        tick_proposed = tick_accepted = 0
        for i, q in enumerate(reqs):
            cap = int(caps[i])
            emit = [int(a[i, 0])]
            j = 0
            while j < cap - 1 and int(d[i, j]) == emit[-1]:
                emit.append(int(a[i, j + 1]))
                j += 1
            tick_proposed += cap - 1
            tick_accepted += j
            if j < cap - 1:
                self.spec_rejections.append((q.rid,
                                             len(q.out_tokens) + j))
            if q.eos_token is not None and q.eos_token in emit:
                emit = emit[:emit.index(q.eos_token) + 1]
            keep = len(emit)
            if keep < cap:
                self.manager.truncate(q.rid, int(base[i]) + keep)
            if keep == T:
                full_rows.append(i)
            q.out_tokens.extend(emit)
            keeps.append(keep)
            gained += keep
        dt = self._clock() - t0
        # the tokens of a tick arrive together: each is charged the
        # tick's wall split across the row's gained tokens
        for q, keep in zip(reqs, keeps):
            share = dt / keep
            q.token_latency_s.extend([share] * keep)
            self._latencies.extend([share] * keep)
        self.spec_proposed += tick_proposed
        self.spec_accepted += tick_accepted
        if self.spec_governor is not None \
                and self.spec_governor.observe(tick_proposed,
                                               tick_accepted):
            # sustained verify mismatch: stop speculating (the tokens
            # are the same either way)
            self.spec_disabled = True
            self.speculate_k = 0
        if full_rows:
            # draft catch-up: on full acceptance the draft never wrote
            # position base + K (the target's verify did); one draft
            # step over those rows fills it
            toks = np.zeros(bb, np.int64)
            pos = np.zeros(bb, np.int64)
            sl = np.zeros(bb, np.int32)
            wbk = np.full(bb, DUMP_BLOCK, np.int32)
            wok = np.zeros(bb, np.int32)
            for i in full_rows:
                toks[i] = reqs[i].out_tokens[-2]      # the token AT
                pos[i] = base[i] + K                  # position base+K
                sl[i] = base[i] + T
                wbk[i], wok[i] = slots[i][K]
            with torch.inference_mode():
                self._draft_step(self._tensor(toks, torch.long), pos,
                                 bt_t, sl, wbk, wok)
        self.decode_wall_s += dt
        self.decode_tokens += gained
        self.steps += 1
        return gained

    def run(self, *, before_tick: Optional[Callable[[int], None]] = None
            ) -> ServeSummary:
        """Serve until every submitted request finishes.
        ``before_tick`` receives the tick index before each tick (for
        staggered arrivals).  The summary covers the engine's lifetime:
        totals and ``wall_s`` accumulate across ``run()`` calls."""
        t0 = self._clock()
        while self.queue or self.active or self.prefilling:
            if before_tick is not None:
                before_tick(self.steps)
            self.step()
        self._evict_finished()
        self._run_wall_s += self._clock() - t0
        return self.summary()

    def summary(self) -> ServeSummary:
        wall = max(self._run_wall_s, 1e-9)
        gen = self._done_tokens \
            + sum(len(q.out_tokens) for q in self.active.values())
        return ServeSummary(
            requests_done=self._done_count,
            tokens_generated=gen,
            prefill_tokens=self.prefill_tokens,
            wall_s=wall,
            decode_steps=self.steps,
            tokens_per_sec=gen / wall,
            decode_wall_s=self.decode_wall_s,
            decode_tokens_per_sec=(
                self.decode_tokens / max(self.decode_wall_s, 1e-9)
                if self.decode_tokens else 0.0),
            latency_p50_ms=_percentile_ms(self._latencies, 50),
            latency_p99_ms=_percentile_ms(self._latencies, 99),
            queue_wait_p50_ms=_percentile_ms(self._queue_wait, 50),
            queue_wait_p99_ms=_percentile_ms(self._queue_wait, 99),
            ttft_p50_ms=_percentile_ms(self._ttft, 50),
            ttft_p99_ms=_percentile_ms(self._ttft, 99),
            itl_p50_ms=_percentile_ms(self._itl, 50),
            itl_p99_ms=_percentile_ms(self._itl, 99),
            requests_rejected=dict(self._rejected),
            device=str(self.device),
            spec_accept_rate=(
                round(self.spec_accepted / self.spec_proposed, 4)
                if self.spec_proposed
                else (0.0 if self.speculate_k > 0 else None)),
            spec_tokens_proposed=self.spec_proposed,
            spec_tokens_accepted=self.spec_accepted,
            warm_prefix_admissions=self._warm_admissions,
            prefix_hit_tokens=self._prefix_hit_tokens,
            shared_blocks_hw=self.manager.shared_blocks_hw,
            cow_copies=self.manager.cow_copies,
            prefill_chunks=self.prefill_chunks,
            spec_disabled=self.spec_disabled)

    def tokens_digest(self) -> str:
        """Digest of every request's output stream — the same recipe as
        the JAX engine's, so equal streams give equal digests."""
        h = hashlib.md5()
        allq = list(self.done) + list(self.active.values())
        for q in sorted(allq, key=lambda q: str(q.rid)):
            h.update(f"{q.rid}:"
                     f"{','.join(map(str, q.out_tokens))};".encode())
        return h.hexdigest()[:12]
