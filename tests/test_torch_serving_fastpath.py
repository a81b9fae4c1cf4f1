"""Port parity for the serving fast path: speculative decoding, chunked
prefill and copy-on-write prefix sharing in ``apex_tpu_torch.serving``
against ``apex_tpu.serving`` on the same weights.

The fixtures are ``tests/test_torch_serving.py``'s: a JAX ``GPTModel``
(vocab 256, hidden 128, 2 heads of 64, 2 layers, max_seq 64) from a
seed, its params through ``extract_serving_weights`` and, as numpy,
``serving_weights_from_numpy``; fp32, the JAX side at HIGHEST matmul
precision.  ``gpt_extend_step`` is held against JAX's with its Pallas
kernel in interpret mode; the engines run JAX's dense attention twins
(``prefill_flash=False``, ``decode_attention="reference"``), as the JAX
package's own fast-path tests do, and the port's wrappers run their
plain versions on the CPU.  The narrow draft is the JAX smoke's recipe
(1 layer, half width: 2 heads of 32).

Tolerances: logits 1e-4 and cache pages 1e-5 (as the serving parity
file); token streams, digests and every count exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.serving import BucketLadder as JaxLadder
from apex_tpu.serving import KVCacheConfig as JaxCacheConfig
from apex_tpu.serving import KVCacheManager as JaxManager
from apex_tpu.serving import Request as JaxRequest
from apex_tpu.serving import ServingEngine as JaxEngine
from apex_tpu.serving import ServingModelConfig as JaxModelConfig
from apex_tpu.serving import default_cache_config as jax_cache_config
from apex_tpu.serving import extract_serving_weights
from apex_tpu.serving import gpt_extend_step as jax_extend
from apex_tpu.serving import gpt_sequence_logits as jax_sequence_logits
from apex_tpu.serving import init_cache as jax_init_cache
from apex_tpu.serving.kv_cache import prefix_chain_keys as jax_chain_keys
from apex_tpu.serving.resilience import \
    SpeculationGovernor as JaxGovernor
from apex_tpu.testing.standalone_gpt import GPTModel
from apex_tpu_torch.serving import (BucketLadder, CachePoolExhausted,
                                    KVCacheConfig, KVCacheManager, Request,
                                    ServingEngine, ServingModelConfig,
                                    SpeculationGovernor,
                                    default_cache_config, gpt_extend_step,
                                    init_cache, prefix_chain_keys,
                                    serving_weights_from_numpy)
from apex_tpu_torch.testing.standalone_gpt import (serve_smoke,
                                                   truncated_draft)

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
VOCAB, HIDDEN, HEADS, LAYERS, MAX_SEQ = 256, 128, 2, 2, 64
BLOCK = 8
PROMPTS = [[int(t) for t in np.random.RandomState(40 + i).randint(
    0, VOCAB, n)] for i, n in enumerate([3, 17, 9, 12, 1])]
LADDER = dict(batch=(2, 4), pages=(2, 4))
NUM_BLOCKS = 32


def _gpt(hidden, layers, seed):
    model = GPTModel(vocab_size=VOCAB, hidden_size=hidden,
                     num_layers=layers, num_attention_heads=HEADS,
                     max_sequence_length=MAX_SEQ, attention_dropout=0.0,
                     hidden_dropout=0.0, use_flash=False,
                     dtype=jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    jw = extract_serving_weights(params, layers)
    cfg = ServingModelConfig(vocab_size=VOCAB, hidden_size=hidden,
                             num_heads=HEADS, num_layers=layers,
                             max_seq=MAX_SEQ)
    tw = serving_weights_from_numpy(jax.tree.map(np.asarray, jw), cfg,
                                    device="cpu")
    return model, jw, cfg, tw


@pytest.fixture(scope="module")
def target():
    return _gpt(HIDDEN, LAYERS, 3)


@pytest.fixture(scope="module")
def narrow():
    """The JAX smoke's narrow draft: 1 layer, half width."""
    return _gpt(HIDDEN // 2, 1, 4)


def _jax_cfg(model, dense=True):
    kw = dict(prefill_flash=False, decode_attention="reference") \
        if dense else {}
    return JaxModelConfig.from_model(model, **kw)


def _engines(target, *, draft=None, k=0, ladder=LADDER,
             num_blocks=NUM_BLOCKS, **kw):
    """The JAX engine and the port's with the same options."""
    model, jw, cfg, tw = target
    jkw, tkw = dict(kw), dict(kw)
    if k:
        dmodel, djw, dcfg, dtw = draft
        jkw.update(speculate_k=k, draft_weights=djw,
                   draft_cfg=_jax_cfg(dmodel))
        tkw.update(speculate_k=k, draft_weights=dtw, draft_cfg=dcfg)
    jeng = JaxEngine(jw, _jax_cfg(model), jax_cache_config(
        _jax_cfg(model), num_blocks=num_blocks, block_size=BLOCK,
        kv_dtype="model"), ladder=JaxLadder(**ladder), **jkw)
    teng = ServingEngine(tw, cfg, default_cache_config(
        cfg, num_blocks=num_blocks, block_size=BLOCK),
        ladder=BucketLadder(**ladder), device="cpu", **tkw)
    return jeng, teng


def _serve(eng, request_cls, prompts=PROMPTS, new=5, eos=None,
           staggered=False, tag="r"):
    reqs = [request_cls(rid=f"{tag}{i}", prompt=list(p),
                        max_new_tokens=new, eos_token=eos)
            for i, p in enumerate(prompts)]
    if staggered:
        eng.submit(reqs[0])
        pending = reqs[1:]

        def drip(step):
            if pending and step % 2 == 0:
                eng.submit(pending.pop(0))

        s = eng.run(before_tick=drip)
        while pending:
            eng.submit(pending.pop(0))
            s = eng.run()
    else:
        for r in reqs:
            eng.submit(r)
        s = eng.run()
    return s, {q.rid: list(q.out_tokens) for q in eng.done}


def _both(jeng, teng, **kw):
    with jax.default_matmul_precision("highest"):
        js, jt = _serve(jeng, JaxRequest, **kw)
    ts, tt = _serve(teng, Request, **kw)
    return js, jt, ts, tt


def _all_returned(eng):
    m = eng.manager
    assert not eng.active and not eng.prefilling
    assert m.free_blocks + m.idle_blocks == eng.cache_cfg.usable_blocks


@pytest.fixture(scope="module")
def plain(target):
    """The port's plain engine (no speculation, chunking or sharing):
    the streams every fast-path option must reproduce, by workload."""
    out = {}
    for name, kw in (("base", {}), ("budget", dict(new=4)),
                     ("staggered", dict(staggered=True))):
        _, eng = _engines(target)
        out[name] = _serve(eng, Request, **kw)[1]
    return out


# ---------------------------------------------------------------------------
# the extend step
# ---------------------------------------------------------------------------

def test_extend_step_matches_jax(target):
    """Two rows in one call: the first chunk of a 5-token prompt (front
    padded by 3: negative positions) and the second chunk of a 14-token
    prompt whose first 6 tokens an earlier call wrote.  Tokens and the
    written pages equal JAX's (its Pallas kernel, interpret mode); the
    logits at the valid slots equal JAX's teacher-forced logits."""
    model, jw, cfg, tw = target
    jcfg = _jax_cfg(model, dense=False)
    t, nb = 8, 12
    pa = PROMPTS[1][:5]
    pb = PROMPTS[1][3:17]
    tables = np.array([[3, 0], [5, 7]], np.int32)
    jcc = jax_cache_config(jcfg, num_blocks=nb, block_size=BLOCK,
                           kv_dtype="model")
    ccfg = default_cache_config(cfg, num_blocks=nb, block_size=BLOCK)
    cache = init_cache(ccfg, "cpu")
    jcache = jax_init_cache(jcc)

    def chunk(rows):
        """rows: (prompt, start, n) -> the extend-step arrays, valid
        tokens back-aligned, padding writing to the dump page."""
        toks = np.zeros((2, t), np.int64)
        wb = np.zeros((2, t), np.int32)
        wo = np.zeros((2, t), np.int32)
        sl = np.zeros(2, np.int32)
        for i, (p, start, n) in enumerate(rows):
            toks[i, t - n:] = p[start:start + n]
            pos = np.arange(start, start + n)
            wb[i, t - n:] = tables[i][pos // BLOCK]
            wo[i, t - n:] = pos % BLOCK
            sl[i] = start + n
        return toks, sl, wb, wo

    logits = None
    for rows in ([(pa, 0, 0), (pb, 0, 6)], [(pa, 0, 5), (pb, 6, 8)]):
        toks, sl, wb, wo = chunk(rows)
        with jax.default_matmul_precision("highest"):
            jcache, jtok = jax_extend(jw, jcfg, jcc, jcache,
                                      jnp.asarray(toks, jnp.int32),
                                      jnp.asarray(tables), jnp.asarray(sl),
                                      jnp.asarray(wb), jnp.asarray(wo))
        _, tok, logits = gpt_extend_step(
            tw, cfg, ccfg, cache, torch.from_numpy(toks),
            torch.from_numpy(tables), torch.from_numpy(sl),
            torch.from_numpy(wb), torch.from_numpy(wo), return_logits=True)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert logits.shape == (2, t, VOCAB)
    # the written pages, JAX's packed pairs unpacked
    for name in ("k", "v"):
        j = np.asarray(getattr(jcache, name))      # (L, nb, h/2, bs, 2d)
        j = j.transpose(0, 1, 3, 2, 4).reshape(LAYERS, nb, BLOCK, HEADS,
                                               64).transpose(0, 1, 3, 2, 4)
        got = getattr(cache, name).numpy()
        for blk in (3, 5, 7):
            np.testing.assert_allclose(got[:, blk], j[:, blk],
                                       rtol=CACHE_TOL, atol=CACHE_TOL)
    with jax.default_matmul_precision("highest"):
        want_a = np.asarray(jax_sequence_logits(
            jw, jcfg, jnp.asarray([pa], jnp.int32)))[0]
        want_b = np.asarray(jax_sequence_logits(
            jw, jcfg, jnp.asarray([pb], jnp.int32)))[0]
    np.testing.assert_allclose(logits[0, t - 5:].numpy(), want_a,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(logits[1].numpy(), want_b[6:14],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("draft", ["self", "narrow"])
def test_spec_streams_equal_jax_and_plain(target, narrow, plain, draft, k):
    jeng, teng = _engines(target, k=k,
                          draft=target if draft == "self" else narrow)
    js, jt, ts, tt = _both(jeng, teng)
    assert tt == jt == plain["base"]
    assert teng.tokens_digest() == jeng.tokens_digest()
    assert (ts.spec_tokens_proposed, ts.spec_tokens_accepted) == \
        (js.spec_tokens_proposed, js.spec_tokens_accepted)
    assert ts.spec_accept_rate == js.spec_accept_rate
    assert ts.decode_steps == js.decode_steps
    if draft == "self":
        assert ts.spec_accept_rate == 1.0 and not teng.spec_rejections
    else:
        assert 0.0 <= ts.spec_accept_rate < 1.0
        # each rejection names the stream index where the target's
        # token replaced the proposal
        assert teng.spec_rejections and all(
            0 < j < len(tt[rid]) for rid, j in teng.spec_rejections)
    _all_returned(teng)


@pytest.mark.parametrize("draft", ["self", "narrow"])
def test_spec_eos_mid_window(target, narrow, plain, draft):
    # an EOS a plain stream emits for the first time mid-stream lands
    # inside an accepted window under K=2: the emission and the write
    # cursor stop at it
    rid, j, eos = next((r, j, s[j])
                       for r, s in sorted(plain["base"].items())
                       for j in range(2, len(s) - 1) if s[j] not in s[:j])
    _, peng = _engines(target)
    want = _serve(peng, Request, eos=eos)[1]
    jeng, teng = _engines(target, k=2,
                          draft=target if draft == "self" else narrow)
    _, jt, _, tt = _both(jeng, teng, eos=eos)
    assert tt == jt == want
    assert tt[rid][-1] == eos and len(tt[rid]) == j + 1
    _all_returned(teng)


@pytest.mark.parametrize("draft", ["self", "narrow"])
def test_spec_budget_cap_mid_window(target, narrow, plain, draft):
    # 4 new tokens is not a multiple of K+1 = 3: the last tick caps the
    # row's slots, its overshoot positions write to the dump page
    jeng, teng = _engines(target, k=2,
                          draft=target if draft == "self" else narrow)
    _, jt, ts, tt = _both(jeng, teng, new=4)
    assert tt == jt == plain["budget"]
    assert all(len(v) == 4 for v in tt.values())
    _all_returned(teng)


def test_spec_staggered_arrivals(target, plain):
    jeng, teng = _engines(target, k=2, draft=target)
    _, jt, _, tt = _both(jeng, teng, staggered=True)
    assert tt == jt == plain["staggered"]


def test_self_draft_takes_fewer_ticks(target):
    _, base = _engines(target)
    bs = _serve(base, Request)[0]
    _, spec = _engines(target, k=2, draft=target)
    s = _serve(spec, Request)[0]
    assert s.spec_accept_rate == 1.0
    assert s.spec_tokens_accepted == s.spec_tokens_proposed > 0
    assert s.decode_steps < bs.decode_steps


def test_speculate_k_without_draft_raises(target):
    _, _, cfg, tw = target
    with pytest.raises(ValueError, match="draft"):
        ServingEngine(tw, cfg, default_cache_config(cfg, num_blocks=8),
                      speculate_k=2, device="cpu",
                      ladder=BucketLadder(batch=(2,), pages=(2,)))


def test_governor_matches_jax():
    ticks = [(4, 0), (4, 3), (4, 0), (4, 0), (0, 0), (4, 0), (4, 0),
             (4, 4)]
    j, t = JaxGovernor(min_accept=0.5, window=3), \
        SpeculationGovernor(min_accept=0.5, window=3)
    assert [t.observe(*x) for x in ticks] == [j.observe(*x)
                                              for x in ticks]
    assert t.tripped and t.low_streak == j.low_streak
    with pytest.raises(ValueError):
        SpeculationGovernor(window=0)


def test_governor_trips_and_streams_hold(target, narrow, plain):
    # a governor that wants every draft token accepted trips after its
    # window of ticks; speculation stops, the tokens do not change
    def gov():
        return dict(min_accept=1.0, window=2)

    jeng, teng = _engines(target, k=2, draft=narrow)
    jeng.spec_governor = JaxGovernor(**gov())
    teng.spec_governor = SpeculationGovernor(**gov())
    js, jt, ts, tt = _both(jeng, teng)
    assert tt == jt == plain["base"]
    assert ts.spec_disabled and js.spec_disabled
    assert ts.spec_tokens_proposed == js.spec_tokens_proposed
    assert teng.speculate_k == 0


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

def test_chunked_prefill_equals_jax_and_whole_prompt(target, plain):
    lad = dict(LADDER, chunks=(4,))
    jeng, teng = _engines(target, ladder=lad, prefill_chunk=4)
    js, jt, ts, tt = _both(jeng, teng)
    assert tt == jt == plain["base"]
    assert ts.prefill_chunks == js.prefill_chunks > len(PROMPTS)
    assert ts.decode_steps == js.decode_steps
    _all_returned(teng)


def test_long_prompt_spans_ticks_while_decode_continues(target):
    _, teng = _engines(target, ladder=dict(batch=(2,), pages=(4,),
                                           chunks=(4,)), prefill_chunk=4)
    short = Request(rid="short", prompt=[1, 2], max_new_tokens=12)
    long_req = Request(rid="long", prompt=PROMPTS[1][:16],
                       max_new_tokens=3)
    teng.submit(short)
    progress = []

    def drip(step):
        if step == 1:
            teng.submit(long_req)
        progress.append((len(short.out_tokens), "long" in teng.prefilling))

    teng.run(before_tick=drip)
    spanned = [p for p in progress if p[1]]
    assert len(spanned) >= 2                    # the prefill crossed ticks
    assert spanned[-1][0] > spanned[0][0]       # short decoded meanwhile
    # the short prompt's one chunk, then 16 tokens in 4-token chunks
    assert teng.prefill_chunks == 1 + 4
    _all_returned(teng)


# ---------------------------------------------------------------------------
# copy-on-write prefix sharing: the manager
# ---------------------------------------------------------------------------

CCFG = KVCacheConfig(num_layers=1, num_heads=2, head_dim=8, num_blocks=10,
                     block_size=4)
JCCFG = JaxCacheConfig(num_layers=1, num_heads=2, head_dim=8,
                       num_blocks=10, block_size=4)


def test_chain_keys_equal_jax():
    for n in (0, 3, 8, 10):
        assert prefix_chain_keys(list(range(n)), 4) == \
            jax_chain_keys(list(range(n)), 4)


def _manager_trace(m):
    """One sequence of manager calls; returns what it observed."""
    seen = []
    prompt = list(range(10))                    # 2 full blocks + 2 tail
    seen.append(m.alloc("a", 10))
    seen.append(m.register_prefix("a", prompt))
    hit = m.match_prefix(prompt)
    seen.append((hit.blocks, hit.tokens, hit.cow))
    part = m.match_prefix(prompt[:8] + [99, 98])
    seen.append((part.blocks, part.tokens, part.cow))
    seen.append(m.match_prefix([99] + prompt[1:]).warm)
    seen.append(m.can_admit(10, 4, prefix=hit))
    seen.append(m.alloc("b", 10, shared_blocks=hit.blocks))
    seen.append(m.make_private("b", 2))
    seen.append(m.cow_for_append("a"))
    seen.append([m.append("a") for _ in range(3)])
    seen.append(m.truncate("a", 11))
    m.free("a")
    seen.append((m.free_blocks, m.idle_blocks, m.shared_blocks,
                 m.available_blocks, m.used_blocks))
    m.free("b")
    seen.append((m.free_blocks, m.idle_blocks, m.shared_blocks,
                 m.cow_copies, m.prefix_hits, m.shared_blocks_hw))
    seen.append(m.alloc("big", 36))             # reclaims the idle LRU
    seen.append((m.idle_blocks, m.shared_blocks,
                 m.match_prefix(prompt).warm))
    return seen


def test_manager_trace_equals_jax():
    assert _manager_trace(KVCacheManager(CCFG, prefix_sharing=True)) == \
        _manager_trace(JaxManager(JCCFG, prefix_sharing=True))


def test_no_free_while_shared():
    m = KVCacheManager(CCFG, prefix_sharing=True)
    prompt = list(range(8))
    blocks = m.alloc("a", 8)
    m.register_prefix("a", prompt)
    hit = m.match_prefix(prompt + [7])          # 2 full blocks warm
    m.alloc("b", 9, shared_blocks=hit.blocks)
    m.free("a")
    assert all(blk not in m._free for blk in blocks)
    m.free("b")
    # zero refs park them idle (cached), still off the free list
    assert all(blk not in m._free for blk in blocks)
    assert m.idle_blocks == 2 and m.match_prefix(prompt + [7]).warm


def test_append_into_shared_page_guarded():
    m = KVCacheManager(CCFG, prefix_sharing=True)
    m.alloc("a", 6)
    m.register_prefix("a", list(range(6)))      # 1 full + a partial of 2
    with pytest.raises(RuntimeError, match="shared page"):
        m.append("a")
    src, dst = m.cow_for_append("a")
    assert m.append("a") == (dst, 2) and m.pending_cow_blocks("a") == 0
    m.alloc("c", 10)
    m.register_prefix("c", list(range(10, 20)))
    with pytest.raises(RuntimeError, match="shared block"):
        m.truncate("c", 4)                      # below the prompt


def test_can_admit_counts_only_unshared_tail():
    cfg = KVCacheConfig(num_layers=1, num_heads=2, head_dim=8,
                        num_blocks=6, block_size=4)       # 5 usable
    m = KVCacheManager(cfg, prefix_sharing=True)
    prompt = list(range(12))
    m.alloc("a", 12)
    m.register_prefix("a", prompt)
    hit = m.match_prefix(prompt)
    assert len(hit.blocks) == 3 and hit.cow
    assert m.can_admit(12, 4, prefix=hit)
    assert not m.can_admit(12, 4)               # cold: 4 pages > 2 free
    assert not m.can_admit(12, 4, prefix=hit, reserved_blocks=1)


def test_pool_exhaustion_still_raises():
    m = KVCacheManager(KVCacheConfig(num_layers=1, num_heads=2, head_dim=8,
                                     num_blocks=5, block_size=4),
                       prefix_sharing=True)
    with pytest.raises(CachePoolExhausted):
        m.alloc("x", 20)                        # 5 pages > 4 usable
    m.alloc("a", 16)
    with pytest.raises(CachePoolExhausted):
        m.append("a")


# ---------------------------------------------------------------------------
# copy-on-write prefix sharing: the engine
# ---------------------------------------------------------------------------

SYS = PROMPTS[1][:13]                           # the "system prompt"
SHARE = dict(batch=(2, 4), pages=(4,))


def test_warm_equals_cold_and_jax(target):
    prompts = [SYS + [i] for i in range(3)]
    jeng, teng = _engines(target, ladder=SHARE, num_blocks=48,
                          prefix_share=True)
    _, jcold, _, cold = _both(jeng, teng, prompts=prompts, new=4)
    _, _, _, _ = _both(jeng, teng, prompts=prompts, new=4, tag="w")
    js, ts = jeng.summary(), teng.summary()
    warm = {q.rid.replace("w", "r"): q.out_tokens
            for q in teng.done if str(q.rid).startswith("w")}
    jwarm = {q.rid.replace("w", "r"): q.out_tokens
             for q in jeng.done if str(q.rid).startswith("w")}
    _, peng = _engines(target, ladder=SHARE, num_blocks=48)
    want = _serve(peng, Request, prompts=prompts, new=4)[1]
    assert cold == jcold == want and warm == jwarm == want
    for f in ("warm_prefix_admissions", "prefix_hit_tokens",
              "shared_blocks_hw", "cow_copies", "prefill_tokens"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.warm_prefix_admissions >= 3 and ts.cow_copies > 0
    assert teng.tokens_digest() == jeng.tokens_digest()
    _all_returned(teng)


def test_shared_pages_unchanged_through_warm_decode(target):
    _, teng = _engines(target, ladder=SHARE, num_blocks=48,
                       prefix_share=True)
    _serve(teng, Request, prompts=[SYS + [0]], new=4)
    hit = teng.manager.match_prefix(SYS + [0])
    assert hit.warm and hit.cow
    shared = list(hit.blocks[:-1])              # the CoW page may change
    before = (teng.cache.k[:, shared].clone(),
              teng.cache.v[:, shared].clone())
    teng.submit(Request(rid="warm", prompt=SYS + [0], max_new_tokens=6))
    s = teng.run()
    assert s.cow_copies >= 1
    assert torch.equal(teng.cache.k[:, shared], before[0])
    assert torch.equal(teng.cache.v[:, shared], before[1])


def test_warm_admission_prefills_only_the_tail(target):
    _, teng = _engines(target, ladder=SHARE, num_blocks=48,
                       prefix_share=True)
    _serve(teng, Request, prompts=[SYS + [0]], new=3)
    assert teng.prefill_tokens == len(SYS) + 1
    teng.submit(Request(rid="warm", prompt=SYS + [0], max_new_tokens=3))
    teng.run()
    assert teng.prefill_tokens == len(SYS) + 2  # the final token alone
    # a block-aligned partial hit prefills from the block boundary
    other = SYS[:8] + [30, 31]
    hit = teng.manager.match_prefix(other)
    assert len(hit.blocks) == 1 and hit.tokens == 8 and not hit.cow
    teng.submit(Request(rid="p", prompt=other, max_new_tokens=3))
    s = teng.run()
    assert s.warm_prefix_admissions == 2
    assert teng.prefill_tokens == len(SYS) + 2 + 2


def test_sharing_admits_more_load(target):
    # a pool too small for two cold worst cases takes the second warm
    _, teng = _engines(target, ladder=dict(batch=(2,), pages=(3,)),
                       num_blocks=5, prefix_share=True)   # 4 usable
    prompt = PROMPTS[1][:16]                    # worst 16 + 4: 3 pages
    teng.submit(Request(rid="a", prompt=prompt, max_new_tokens=4))
    teng.run()
    hit = teng.manager.match_prefix(prompt)
    assert hit.warm
    assert 2 * teng.cache_cfg.blocks_for(16 + 4) > 4
    assert teng.manager.can_admit(16, 4, prefix=hit)
    teng.submit(Request(rid="b", prompt=prompt, max_new_tokens=4))
    assert teng.run().requests_done == 2


# ---------------------------------------------------------------------------
# everything at once, and the smoke entry point
# ---------------------------------------------------------------------------

def test_spec_chunk_share_combined(target, plain):
    lad = dict(LADDER, chunks=(4,))
    jeng, teng = _engines(target, k=2, draft=target, ladder=lad,
                          prefill_chunk=4, prefix_share=True)
    prompts = PROMPTS + [PROMPTS[1][:12] + [5]]   # one shares a prefix
    js, jt, ts, tt = _both(jeng, teng, prompts=prompts, staggered=True)
    assert tt == jt
    assert {k: v for k, v in tt.items() if k != "r5"} == plain["staggered"]
    assert ts.spec_accept_rate == 1.0
    for f in ("prefill_chunks", "warm_prefix_admissions",
              "prefix_hit_tokens", "cow_copies", "decode_steps"):
        assert getattr(ts, f) == getattr(js, f), f
    _all_returned(teng)


def test_serve_smoke_fast_path_digests():
    kw = dict(model="tiny", max_new_tokens=6, device="cpu", min_prompt=3,
              max_prompt=40)
    _, base = serve_smoke(4, **kw)
    for fast in (dict(speculate_k=2), dict(speculate_k=3, draft="truncated"),
                 dict(prefill_chunk=16), dict(prefix_share=True),
                 dict(speculate_k=2, prefill_chunk=16, prefix_share=True)):
        s, eng = serve_smoke(4, **kw, **fast)
        assert eng.tokens_digest() == base.tokens_digest(), fast
        if fast.get("speculate_k"):
            assert s.spec_tokens_proposed > 0
    with pytest.raises(ValueError, match="draft"):
        serve_smoke(1, **kw, speculate_k=2, draft="narrow")


def test_truncated_draft_shares_the_target_tensors(target):
    _, _, cfg, tw = target
    dw, dcfg = truncated_draft(tw, cfg, 1)
    assert dcfg.num_layers == 1 and len(dw.layers) == 1
    assert dw.wte is tw.wte and dw.layers[0] is tw.layers[0]
    with pytest.raises(ValueError):
        truncated_draft(tw, cfg, 3)
