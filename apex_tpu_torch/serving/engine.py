"""Continuous-batching serving engine (greedy decode) in PyTorch.

Port of ``apex_tpu/serving/engine.py``'s default path: no speculation,
no chunked prefill, no prefix sharing, float KV, one device.  The loop
alternates two worlds on a fixed cadence:

* **between** steps (host, this module): finished requests are evicted
  (their cache blocks return to the pool), queued requests are admitted
  (blocks allocated, the prompt prefilled through the flash-attention
  kernel), and the next decode batch is assembled;
* **inside** a step (:mod:`.model`): one prefill per admission, then one
  batched decode step per tick through the paged flash-decode kernel,
  greedy argmax on the device, one int per row fetched back.

Shapes are **bucketed** as in the JAX engine: the decode batch rounds up
to a :class:`BucketLadder` batch rung and the page span to a page rung,
prompts pad to a page rung times the block size.  PyTorch runs eagerly,
so the ladder compiles nothing here; it keeps the step shapes of the two
engines equal, and with them the padding rows the kernels must handle.

Admission is **reservation-based**: a request is admitted only when the
pool covers its whole worst case (prompt + max new tokens), so a decode
can never exhaust the pool mid-flight.

Left out of this slice (later ones port them): speculative decoding,
chunked prefill, prefix sharing and copy-on-write, int8 KV and the Q8
tier, deadlines and load shedding, the request journal, the metrics
plane, tensor and expert parallelism, and ``swap_weights``.
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
from .kv_cache import DUMP_BLOCK, KVCacheConfig, KVCacheManager, init_cache
from .model import (GPTServingWeights, ServingModelConfig, gpt_decode_step,
                    gpt_prefill_step)

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
    """The registered (batch, pages) shape ladder; ``pick_*`` rounds a
    live size up to the smallest rung."""

    batch: Tuple[int, ...] = parse_ladder(DEFAULT_BATCH_BUCKETS)
    pages: Tuple[int, ...] = parse_ladder(DEFAULT_PAGE_BUCKETS)

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


def _percentile_ms(xs: Sequence[float], q: float) -> Optional[float]:
    if not len(xs):
        return None
    return float(np.percentile(np.asarray(xs, np.float64), q)) * 1e3


def default_cache_config(model_cfg: ServingModelConfig,
                         num_blocks: int = DEFAULT_NUM_BLOCKS,
                         block_size: int = DEFAULT_BLOCK_SIZE
                         ) -> KVCacheConfig:
    """Cache plan for ``model_cfg``: ``num_blocks`` blocks (dump block
    included) of ``block_size`` tokens, k/v in the model's dtype."""
    return KVCacheConfig(
        num_layers=model_cfg.num_layers, num_heads=model_cfg.num_heads,
        head_dim=model_cfg.head_dim, num_blocks=num_blocks,
        block_size=block_size, dtype=model_cfg.dtype)


class ServingEngine:
    """Continuous-batching loop over one model + one paged cache on
    one device (cuda unless ``device="cpu"``; the weights must already
    be there)."""

    def __init__(self, weights: GPTServingWeights,
                 model_cfg: ServingModelConfig, cache_cfg: KVCacheConfig,
                 *, ladder: Optional[BucketLadder] = None, device=None,
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
        self.weights = weights
        self.model_cfg = model_cfg
        self.cache_cfg = cache_cfg
        self.ladder = ladder if ladder is not None else BucketLadder()
        if self.ladder.max_pages > cache_cfg.usable_blocks:
            raise ValueError(
                f"page ladder max {self.ladder.max_pages} exceeds the "
                f"pool's {cache_cfg.usable_blocks} usable blocks")
        self._clock = clock
        self.manager = KVCacheManager(cache_cfg)
        self.cache = init_cache(cache_cfg, self.device)
        self.queue: deque = deque()
        self.active: Dict[Any, Request] = {}
        self.done: List[Request] = []
        self.steps = 0
        self.prefill_tokens = 0
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
        """Blocks the free pool already owes to in-flight requests: each
        may still grow to its worst case (prompt + max_new)."""
        total = 0
        for rid, req in self.active.items():
            worst = self.cache_cfg.blocks_for(
                len(req.prompt) + req.max_new_tokens)
            total += max(0, worst - self.manager.num_pages(rid))
        return total

    def _tensor(self, a: np.ndarray, dtype=torch.int32) -> torch.Tensor:
        return torch.from_numpy(a).to(device=self.device, dtype=dtype)

    def _admit(self, req: Request) -> None:
        """Cold whole-prompt admission: allocate the prompt's blocks,
        run one flash-attention prefill over the right-padded prompt,
        and take the first generated token."""
        p_len = len(req.prompt)
        t0 = self._clock()
        self.manager.alloc(req.rid, p_len)
        req.admitted_at_step = self.steps
        bs = self.cache_cfg.block_size
        pb = self.ladder.pick_pages(self.cache_cfg.blocks_for(p_len))
        s_pad = pb * bs
        bt = self.manager.block_table(req.rid, pb)
        tokens = np.zeros(s_pad, np.int64)
        tokens[:p_len] = req.prompt
        with torch.inference_mode():
            _, next_token = gpt_prefill_step(
                self.weights, self.model_cfg, self.cache_cfg, self.cache,
                self._tensor(tokens, torch.long), p_len,
                self._tensor(bt))
            first = int(next_token)          # the admission's host sync
        now = self._clock()
        dt = now - t0
        req.out_tokens.append(first)
        req.token_latency_s.append(dt)
        self._latencies.append(dt)
        self._queue_wait.append(t0 - req.submit_t)
        self._ttft.append(now - req.submit_t)
        self.active[req.rid] = req
        self.prefill_tokens += p_len

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
        """One tick: evict finished requests, admit queued ones while
        the batch ladder and the pool's reservations allow, then run one
        bucketed decode step over every active request.  Returns the
        number of tokens decoded this tick."""
        self._evict_finished()
        while self.queue and len(self.active) < self.ladder.max_batch:
            req = self.queue[0]
            if not self.manager.can_admit(
                    len(req.prompt), req.max_new_tokens,
                    reserved_blocks=self._reserved_blocks()):
                break
            self._admit(self.queue.popleft())
        # requests may finish at admission (max_new_tokens == 1)
        self._evict_finished()
        if not self.active:
            return 0
        reqs = [self.active[r] for r in sorted(self.active, key=str)]
        return self._decode_tick(reqs)

    def _decode_tick(self, reqs: List[Request]) -> int:
        n = len(reqs)
        bb = self.ladder.pick_batch(n)
        slots = [self.manager.append(q.rid) for q in reqs]
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

    def run(self) -> ServeSummary:
        """Serve until every submitted request finishes.  The summary
        covers the engine's lifetime: totals and ``wall_s`` accumulate
        across ``run()`` calls."""
        t0 = self._clock()
        while self.queue or self.active:
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
            device=str(self.device))

    def tokens_digest(self) -> str:
        """Digest of every request's output stream — the same recipe as
        the JAX engine's, so equal streams give equal digests."""
        h = hashlib.md5()
        allq = list(self.done) + list(self.active.values())
        for q in sorted(allq, key=lambda q: str(q.rid)):
            h.update(f"{q.rid}:"
                     f"{','.join(map(str, q.out_tokens))};".encode())
        return h.hexdigest()[:12]
