"""Port parity for the serving slice: the whole GPT serve of
``apex_tpu_torch`` against ``apex_tpu.serving`` on the same weights.

A JAX ``GPTModel`` (hidden 128, 2 heads so d=64 and JAX runs its
head-packed kernels and cache, 2 layers, vocab 256) is initialized from
a seed; its params go through ``extract_serving_weights`` and, as numpy,
through ``serving_weights_from_numpy``.  fp32 throughout, the JAX side
at HIGHEST matmul precision, its Pallas kernels in CPU interpret mode.

Tolerances: logits 1e-4 (fp32 through two layers, a 256-wide head and
reassociated softmax sums); cache contents 1e-5; token streams exact.

Also here: the import rule (the port loads no ``jax*`` and no
``apex_tpu.*`` module) and the device rule (entry points raise without
CUDA unless ``device="cpu"``).
"""
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.serving import BucketLadder as JaxLadder
from apex_tpu.serving import Request as JaxRequest
from apex_tpu.serving import ServingEngine as JaxEngine
from apex_tpu.serving import ServingModelConfig as JaxModelConfig
from apex_tpu.serving import default_cache_config as jax_cache_config
from apex_tpu.serving import extract_serving_weights
from apex_tpu.serving import gpt_prefill_step as jax_prefill
from apex_tpu.serving import gpt_sequence_logits as jax_sequence_logits
from apex_tpu.serving import init_cache as jax_init_cache
from apex_tpu.testing.standalone_gpt import GPTModel
from apex_tpu_torch import resolve_device
from apex_tpu_torch.serving import (BucketLadder, Request, ServingEngine,
                                    ServingModelConfig,
                                    default_cache_config, gpt_decode_step,
                                    gpt_prefill_step, gpt_sequence_logits,
                                    init_cache, init_serving_weights,
                                    serving_weights_from_numpy)
from apex_tpu_torch.testing.standalone_gpt import serve_smoke, train_smoke

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
VOCAB, HIDDEN, HEADS, LAYERS, MAX_SEQ = 256, 128, 2, 2, 64
BLOCK = 8


@pytest.fixture(scope="module")
def models():
    model = GPTModel(vocab_size=VOCAB, hidden_size=HIDDEN,
                     num_layers=LAYERS, num_attention_heads=HEADS,
                     max_sequence_length=MAX_SEQ, attention_dropout=0.0,
                     hidden_dropout=0.0, use_flash=False,
                     dtype=jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(3),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    jcfg = JaxModelConfig.from_model(model)
    jw = extract_serving_weights(params, LAYERS)
    cfg = ServingModelConfig(vocab_size=VOCAB, hidden_size=HIDDEN,
                             num_heads=HEADS, num_layers=LAYERS,
                             max_seq=MAX_SEQ)
    tw = serving_weights_from_numpy(jax.tree.map(np.asarray, jw), cfg,
                                    device="cpu")
    return jcfg, jw, cfg, tw


def _tokens(n, seed):
    return np.random.RandomState(seed).randint(0, VOCAB, n)


def test_sequence_logits_match_jax(models):
    jcfg, jw, cfg, tw = models
    toks = np.stack([_tokens(37, 1), _tokens(37, 2)])
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_sequence_logits(jw, jcfg,
                                              jnp.asarray(toks)))
    got = gpt_sequence_logits(tw, cfg, torch.from_numpy(toks)).numpy()
    assert got.shape == (2, 37, VOCAB)
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_prefill_then_decode_logits_and_cache_match_jax(models):
    jcfg, jw, cfg, tw = models
    plen, pages = 13, 4                      # s_pad 32, 2 owned pages
    prompt = _tokens(plen, 4)
    blocks = np.array([3, 5, 0, 0], np.int32)
    s_pad = pages * BLOCK
    padded = np.zeros(s_pad, np.int64)
    padded[:plen] = prompt
    # JAX: its packed cache after the prefill, and the oracle logits
    jcc = jax_cache_config(jcfg, num_blocks=8, block_size=BLOCK,
                           kv_dtype="model")
    assert jcc.kv_shape[2:] == (1, BLOCK, 128)        # packed d=64 pairs
    with jax.default_matmul_precision("highest"):
        jcache, jtok = jax_prefill(jw, jcfg, jcc, jax_init_cache(jcc),
                                   jnp.asarray(padded, jnp.int32),
                                   jnp.int32(plen), jnp.asarray(blocks))
    ccfg = default_cache_config(cfg, num_blocks=8, block_size=BLOCK)
    cache = init_cache(ccfg, "cpu")
    _, tok, logits = gpt_prefill_step(
        tw, cfg, ccfg, cache, torch.from_numpy(padded), plen,
        torch.from_numpy(blocks), return_logits=True)
    assert int(tok) == int(jtok)
    # the port's (L, nb, h, bs, d) cache == JAX's packed one, unpacked;
    # only the owned pages (the dump page takes the padding rows)
    jk = np.asarray(jcache.k)                 # (L, nb, h/2, bs, 2d)
    jk = jk.transpose(0, 1, 3, 2, 4).reshape(LAYERS, 8, BLOCK, HEADS,
                                             64).transpose(0, 1, 3, 2, 4)
    np.testing.assert_allclose(cache.k[:, [3, 5]].numpy(), jk[:, [3, 5]],
                               rtol=CACHE_TOL, atol=CACHE_TOL)
    # decode three tokens, teacher-forced from the oracle's stream
    seq = list(prompt) + [int(tok)]
    step_logits = [logits.numpy()]
    bt = torch.from_numpy(blocks[None, :2].copy())
    for _ in range(3):
        pos = len(seq) - 1
        blk, off = int(blocks[pos // BLOCK]), pos % BLOCK
        _, nxt, lg = gpt_decode_step(
            tw, cfg, ccfg, cache, torch.tensor([seq[-1]]),
            torch.tensor([pos]), bt, torch.tensor([pos + 1],
                                                  dtype=torch.int32),
            torch.tensor([blk], dtype=torch.int32),
            torch.tensor([off], dtype=torch.int32), return_logits=True)
        step_logits.append(lg[0].numpy())
        seq.append(int(nxt[0]))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_sequence_logits(
            jw, jcfg, jnp.asarray([seq[:-1]], jnp.int32)))[0]
    np.testing.assert_allclose(np.stack(step_logits), want[plen - 1:],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_engine_streams_equal_jax_engine(models):
    jcfg, jw, cfg, tw = models
    lengths = [3, 17, 9, 30, 1, 12]
    prompts = [[int(t) for t in _tokens(n, 10 + i)]
               for i, n in enumerate(lengths)]
    new = 5
    jeng = JaxEngine(jw, jcfg, jax_cache_config(jcfg, num_blocks=24,
                                                block_size=BLOCK,
                                                kv_dtype="model"),
                     ladder=JaxLadder(batch=(2, 4), pages=(2, 5)))
    teng = ServingEngine(tw, cfg, default_cache_config(
        cfg, num_blocks=24, block_size=BLOCK),
        ladder=BucketLadder(batch=(2, 4), pages=(2, 5)), device="cpu")
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=f"r{i}", prompt=p, max_new_tokens=new))
        teng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=new))
    with jax.default_matmul_precision("highest"):
        jeng.run()
    s = teng.run()
    want = {q.rid: q.out_tokens for q in jeng.done}
    got = {q.rid: q.out_tokens for q in teng.done}
    assert got == want
    assert teng.tokens_digest() == jeng.tokens_digest()
    assert s.requests_done == len(prompts)
    assert s.tokens_generated == new * len(prompts)
    assert teng.manager.free_blocks == 23       # every block returned


def test_engine_rejects_what_jax_rejects(models):
    _, _, cfg, tw = models
    eng = ServingEngine(tw, cfg, default_cache_config(
        cfg, num_blocks=8, block_size=BLOCK),
        ladder=BucketLadder(batch=(2,), pages=(2,)), device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(rid="e", prompt=[], max_new_tokens=1))
    with pytest.raises(ValueError, match="span"):
        eng.submit(Request(rid="big", prompt=[1] * 14, max_new_tokens=4))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(Request(rid="z", prompt=[1], max_new_tokens=0))
    assert eng.summary().requests_rejected == {
        "empty_prompt": 1, "ladder_span": 1, "max_new_tokens": 1}


def test_import_loads_no_jax_and_no_apex_tpu():
    code = textwrap.dedent("""
        import sys
        before = set(sys.modules)
        import apex_tpu_torch, apex_tpu_torch.ops, apex_tpu_torch.amp
        import apex_tpu_torch.serving, apex_tpu_torch._build
        import apex_tpu_torch.testing.standalone_gpt
        import apex_tpu_torch.normalization, apex_tpu_torch.transformer
        import apex_tpu_torch.transformer.tensor_parallel
        import apex_tpu_torch.contrib.xentropy, apex_tpu_torch.optimizers
        import apex_tpu_torch.ops.fused_pipeline
        import apex_tpu_torch.amp.mixed_precision
        import apex_tpu_torch.testing.standalone_bert
        import apex_tpu_torch.testing.arguments
        import apex_tpu_torch.testing.global_vars
        import apex_tpu_torch.optimizers.fused_mixed_precision_lamb
        import apex_tpu_torch.transformer.tensor_parallel.random
        import apex_tpu_torch.transformer.microbatches
        new = set(sys.modules) - before
        bad = sorted(m for m in new if m.split(".")[0] in
                     ("jax", "jaxlib", "flax", "optax", "apex_tpu"))
        print("BAD", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert "BAD []" in out, out


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    cfg = ServingModelConfig(vocab_size=32, hidden_size=128, num_heads=2,
                             num_layers=1, max_seq=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_serving_weights(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_smoke(1, model="tiny", max_new_tokens=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_smoke(1, model="tiny")
    # asked for by name, the CPU runs the plain versions
    assert resolve_device("cpu") == torch.device("cpu")
    s, eng = serve_smoke(2, model="tiny", max_new_tokens=3, device="cpu",
                         min_prompt=3, max_prompt=20)
    assert s.device == "cpu" and s.tokens_generated == 6
    w = init_serving_weights(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(w, cfg, default_cache_config(cfg, num_blocks=8),
                      ladder=BucketLadder(batch=(1,), pages=(2,)))


def test_train_smoke_on_the_cpu_when_asked():
    r = train_smoke(3, model="tiny", device="cpu")
    assert r.device == "cpu" and len(r.losses) == 3
    assert all(np.isfinite(r.losses)) and r.losses[-1] < r.losses[0]
    assert r.setup.tokens_per_step == 64 * 2
    # the plain configuration starts from the same weights and data
    p = train_smoke(1, model="tiny", device="cpu", kernels=False)
    assert p.losses[0] == r.losses[0]
