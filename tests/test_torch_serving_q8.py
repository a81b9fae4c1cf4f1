"""Port parity for the quantized serving tier: Q8 weights (every layer
matmul int8 with per-column fp32 scales) and the int8 KV cache in
``apex_tpu_torch.serving`` against ``apex_tpu.serving`` on the same
weights.

A JAX ``GPTModel`` (vocab 256, hidden 128, 2 heads of 64, 2 layers,
max_seq 64) from a seed goes through ``extract_serving_weights`` and
JAX's ``quantize_weights``; the Q8 tree, as numpy, through
``serving_weights_from_numpy``, which keeps the codes and scales.  fp32
compute, the JAX side at HIGHEST matmul precision.  The JAX engines run
their dense attention twins (``prefill_flash=False``,
``decode_attention="reference"``) and, off the TPU, JAX's plain
``quant_matmul``, as the JAX package's own serving tests do; the port's
wrappers run their plain versions on the CPU.

Tolerances: token streams and digests exact (as the float serving
parity); logits 1e-4 (fp32 through two layers, as the float parity);
the Q8 greedy divergence from the float serve within JAX's committed
``Q8_GREEDY_DIVERGENCE_BOUND`` (0.10, ``tests/test_serving.py``) on the
JAX test's own tiny model and prompts.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.amp.policy import Q8 as JAX_Q8
from apex_tpu.ops.quant_matmul import quantize_weights as jax_quantize
from apex_tpu.serving import BucketLadder as JaxLadder
from apex_tpu.serving import Request as JaxRequest
from apex_tpu.serving import ServingEngine as JaxEngine
from apex_tpu.serving import ServingModelConfig as JaxModelConfig
from apex_tpu.serving import default_cache_config as jax_cache_config
from apex_tpu.serving import extract_serving_weights
from apex_tpu.serving import gpt_sequence_logits as jax_sequence_logits
from apex_tpu.testing.standalone_gpt import GPTModel
from apex_tpu_torch.amp import Policy, get_policy
from apex_tpu_torch.serving import (BucketLadder, Request, ServingEngine,
                                    ServingModelConfig,
                                    default_cache_config,
                                    gpt_sequence_logits,
                                    is_quantized_weights, quantize_weights,
                                    serving_weights_from_numpy)
from apex_tpu_torch.testing.standalone_gpt import main, serve_smoke

LOGIT_TOL = 1e-4
VOCAB, HIDDEN, HEADS, LAYERS, MAX_SEQ = 256, 128, 2, 2, 64
BLOCK = 8
PROMPTS = [[int(t) for t in np.random.RandomState(60 + i).randint(
    0, VOCAB, n)] for i, n in enumerate([3, 17, 9, 30, 1, 12])]
LADDER = dict(batch=(2, 4), pages=(2, 5))
NUM_BLOCKS = 24
# ISSUE-16's committed bound (tests/test_serving.py)
Q8_GREEDY_DIVERGENCE_BOUND = 0.10


def _gpt(vocab, hidden, heads, layers, max_seq, seed):
    model = GPTModel(vocab_size=vocab, hidden_size=hidden,
                     num_layers=layers, num_attention_heads=heads,
                     max_sequence_length=max_seq, attention_dropout=0.0,
                     hidden_dropout=0.0, use_flash=False,
                     dtype=jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    jw = extract_serving_weights(params, layers)
    jcfg = JaxModelConfig.from_model(model, prefill_flash=False,
                                     decode_attention="reference")
    cfg = ServingModelConfig(vocab_size=vocab, hidden_size=hidden,
                             num_heads=heads, num_layers=layers,
                             max_seq=max_seq)
    return jcfg, jw, cfg


@pytest.fixture(scope="module")
def q8():
    jcfg, jw, cfg = _gpt(VOCAB, HIDDEN, HEADS, LAYERS, MAX_SEQ, 3)
    jq = jax_quantize(jw)
    tq = serving_weights_from_numpy(jax.tree.map(np.asarray, jq), cfg,
                                    device="cpu")
    return jcfg, jq, cfg, tq


def _serve(eng, request_cls, *, new=5, staggered=False):
    reqs = [request_cls(rid=f"r{i}", prompt=list(p), max_new_tokens=new)
            for i, p in enumerate(PROMPTS)]
    if staggered:
        eng.submit(reqs[0])
        pending = reqs[1:]

        def drip(step):
            if pending and step % 2 == 0:
                eng.submit(pending.pop(0))

        eng.run(before_tick=drip)
        while pending:
            eng.submit(pending.pop(0))
            eng.run()
    else:
        for r in reqs:
            eng.submit(r)
        eng.run()
    return {q.rid: list(q.out_tokens) for q in eng.done}


def _engines(q8, kv_dtype, chunk=0, k=0):
    jcfg, jq, cfg, tq = q8
    jeng = JaxEngine(jq, jcfg, jax_cache_config(
        jcfg, num_blocks=NUM_BLOCKS, block_size=BLOCK, kv_dtype=kv_dtype),
        ladder=JaxLadder(**LADDER), speculate_k=k,
        draft_weights=jq if k else None, draft_cfg=jcfg if k else None,
        prefill_chunk=chunk, prefix_share=False)
    teng = ServingEngine(tq, cfg, default_cache_config(
        cfg, num_blocks=NUM_BLOCKS, block_size=BLOCK, kv_dtype=kv_dtype),
        ladder=BucketLadder(**LADDER), device="cpu", speculate_k=k,
        draft_weights=tq if k else None, draft_cfg=cfg if k else None,
        prefill_chunk=chunk)
    return jeng, teng


def test_q8_sequence_logits_match_jax(q8):
    jcfg, jq, cfg, tq = q8
    toks = np.stack([np.random.RandomState(s).randint(0, VOCAB, 29)
                     for s in (1, 2)])
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_sequence_logits(jq, jcfg, jnp.asarray(toks)))
    got = gpt_sequence_logits(tq, cfg, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("kv_dtype,chunk", [("int8", 0), ("int8", 16),
                                            ("model", 0)])
def test_q8_engine_streams_equal_jax(q8, kv_dtype, chunk):
    jeng, teng = _engines(q8, kv_dtype, chunk)
    with jax.default_matmul_precision("highest"):
        want = _serve(jeng, JaxRequest, staggered=bool(chunk))
    got = _serve(teng, Request, staggered=bool(chunk))
    assert got == want
    assert teng.tokens_digest() == jeng.tokens_digest()
    assert teng.cache.k.dtype == (torch.int8 if kv_dtype == "int8"
                                  else torch.float32)
    if chunk:
        assert teng.prefill_chunks == jeng.prefill_chunks > len(PROMPTS)
    assert teng.manager.free_blocks == NUM_BLOCKS - 1


def test_q8_int8_self_draft_keeps_the_stream(q8):
    # the draft's cache takes the target's storage dtype; speculation
    # through the int8 branches leaves the greedy stream unchanged
    _, teng = _engines(q8, "int8", k=2)
    assert teng.draft_cache_cfg.kv_dtype == "int8"
    assert teng.draft_cache.k.dtype == torch.int8
    spec = _serve(teng, Request)
    _, plain = _engines(q8, "int8")
    assert spec == _serve(plain, Request)
    assert teng.spec_accepted == teng.spec_proposed > 0


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_q8_greedy_divergence_within_committed_bound(kv_dtype):
    # the JAX test's model and prompts (tests/test_serving.py:566-592)
    jcfg, jw, cfg = _gpt(64, 64, 2, 2, 32, 0)
    weights = serving_weights_from_numpy(jax.tree.map(np.asarray, jw),
                                         cfg, device="cpu")
    prompts = [[3, 7, 1], [11, 2, 9, 4, 5], [1, 2], [6, 6, 6, 6]]
    outs = {}
    for tag, w, kv in (("float", weights, "model"),
                       ("q8", quantize_weights(weights), kv_dtype)):
        eng = ServingEngine(w, cfg, default_cache_config(
            cfg, num_blocks=16, block_size=4, kv_dtype=kv),
            ladder=BucketLadder(batch=(2,), pages=(3,)), device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=6))
        eng.run()
        assert len(eng.done) == len(prompts)
        outs[tag] = {q.rid: q.out_tokens for q in eng.done}
    total = sum(len(v) for v in outs["float"].values())
    diverged = sum(a != b for rid in outs["float"]
                   for a, b in zip(outs["float"][rid], outs["q8"][rid]))
    assert diverged / total <= Q8_GREEDY_DIVERGENCE_BOUND, (diverged, total)


def test_q8_policy_mirrors_jax():
    p = get_policy("Q8")
    assert p.quantize_weights == JAX_Q8.quantize_weights == "int8"
    assert p.param_dtype == torch.bfloat16
    assert (p.master_weights, p.loss_scale, p.keep_batchnorm_fp32) == \
        (JAX_Q8.master_weights, JAX_Q8.loss_scale,
         JAX_Q8.keep_batchnorm_fp32)
    assert get_policy("O5").quantize_weights is None
    with pytest.raises(ValueError, match="quantize_weights"):
        Policy(quantize_weights="int4")


def test_engine_rejects_a_malformed_q8_tree(q8):
    _, _, cfg, tq = q8
    bad = tq._replace(layers=(tq.layers[0]._replace(
        qkv_s=tq.layers[0].qkv_s.double()),) + tq.layers[1:])
    with pytest.raises(ValueError, match="int8 codes"):
        ServingEngine(bad, cfg, default_cache_config(cfg, num_blocks=8),
                      ladder=BucketLadder(batch=(1,), pages=(2,)),
                      device="cpu")


def test_serve_smoke_and_cli_q8_int8(capsys):
    s, eng = serve_smoke(3, model="tiny", policy="Q8", kv_dtype="int8",
                         max_new_tokens=4, device="cpu", min_prompt=3,
                         max_prompt=30)
    assert is_quantized_weights(eng.weights)
    assert eng.weights.layers[0].qkv_k.dtype == torch.int8
    assert eng.weights.wte.dtype == torch.bfloat16     # head stays bf16
    assert eng.cache_cfg.kv_dtype == "int8" and eng.cache.k_scale is not None
    assert s.tokens_generated == 12
    assert main(["--serve", "--policy", "Q8", "--kv-dtype", "int8",
                 "--model", "tiny", "--device", "cpu", "--requests", "3",
                 "--new-tokens", "4", "--min-prompt", "3",
                 "--max-prompt", "30"]) == 0
    out = capsys.readouterr().out
    assert "SERVE_DONE policy=Q8 kv_dtype=int8" in out
    assert f"digest={eng.tokens_digest()}" in out
