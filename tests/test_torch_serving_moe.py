"""Port parity for MoE serving: the port's ``ServingEngine`` over
``MoELayerWeights`` against the JAX single-chip MoE engine, fp32, on the
JAX package's own ``moe_setup`` shape (``tests/test_serving_ep.py``: the
smoke GPT at vocab 64, hidden 32, 4 heads, 2 layers; zero fc biases; E = 4
experts from ``expand_moe_weights`` with expert e's wi scaled by
1 + 0.05 e, so that a wrong route changes the output).  The JAX engine
runs its dense attention twins (``prefill_flash=False,
decode_attention="reference"``), as the port's other serving tests do;
its routing is the jnp twin, the port's the plain version of row 18.

* Served tokens identical at capacity factor 8.0 (nothing drops) and 1.25
  (drops in every decode tick: capacity 1 at a bucket of 4 rows), over
  mixed-length requests and bucket changes, and through a chunked-prefill
  leg (the extend step, 4-token chunks) at 1.25.
* The teacher-forced logits of ``gpt_sequence_logits`` within 1e-4 of
  JAX's (fp32 through two layers, as ``test_torch_serving.py``).
* E = 1 serves what the dense engine serves.
* ``expand_moe_weights`` equals JAX's given the same (zero) router; the
  JAX tree carries across with an fp32 router; MoE refuses Q8.
"""
import dataclasses

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
from apex_tpu.serving import expand_moe_weights as jax_expand
from apex_tpu.serving import extract_serving_weights
from apex_tpu.serving import gpt_sequence_logits as jax_sequence_logits
from apex_tpu.testing.standalone_gpt import GPTModel
from apex_tpu_torch.ops import quantize_weights
from apex_tpu_torch.serving import (BucketLadder, MoELayerWeights, Request,
                                    ServingEngine, ServingModelConfig,
                                    default_cache_config, expand_moe_weights,
                                    gpt_sequence_logits,
                                    serving_weights_from_numpy)
from apex_tpu_torch.serving.weights import check_serving_weights
from apex_tpu_torch.testing.standalone_gpt import serve_smoke
from apex_tpu_torch.transformer import expert_parallel

VOCAB, HIDDEN, HEADS, LAYERS, MAX_SEQ = 64, 32, 4, 2, 64
E = 4
BLOCK = 4
LADDER = dict(batch=(2, 4), pages=(2, 4, 8))
PROMPT_LENGTHS = [3, 9, 1, 14, 6, 11]
NEW = 5
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    """(JAX model, JAX dense tree, JAX MoE tree, port cfg, port dense,
    port MoE): JAX's ``moe_setup``."""
    model = GPTModel(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS,
                     num_attention_heads=HEADS, max_sequence_length=MAX_SEQ,
                     attention_dropout=0.0, hidden_dropout=0.0,
                     use_flash=False, dtype=jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    jw = extract_serving_weights(params, LAYERS)
    jw = jw._replace(layers=tuple(
        lw._replace(fc1_b=jnp.zeros_like(lw.fc1_b),
                    fc2_b=jnp.zeros_like(lw.fc2_b)) for lw in jw.layers))
    jmoe = jax_expand(jw, E, jax.random.PRNGKey(3))
    scale = (1.0 + 0.05 * jnp.arange(E, dtype=jnp.float32))[:, None, None]
    jmoe = jmoe._replace(layers=tuple(lw._replace(wi=lw.wi * scale)
                                      for lw in jmoe.layers))
    cfg = ServingModelConfig(vocab_size=VOCAB, hidden_size=HIDDEN,
                             num_heads=HEADS, num_layers=LAYERS,
                             max_seq=MAX_SEQ)
    tw = serving_weights_from_numpy(jax.tree.map(np.asarray, jw), cfg,
                                    device="cpu")
    tmoe = serving_weights_from_numpy(jax.tree.map(np.asarray, jmoe),
                                      _moe(cfg), device="cpu")
    return model, jw, jmoe, cfg, tw, tmoe


def _moe(cfg, cf=8.0, e=E):
    return dataclasses.replace(cfg, num_experts=e, moe_capacity_factor=cf)


def _prompts():
    rng = np.random.RandomState(11)
    return [[int(t) for t in rng.randint(0, VOCAB, n)]
            for n in PROMPT_LENGTHS]


def _serve(eng, request_cls):
    for i, p in enumerate(_prompts()):
        eng.submit(request_cls(rid=f"r{i}", prompt=p, max_new_tokens=NEW))
    s = eng.run()
    return s, {q.rid: list(q.out_tokens) for q in eng.done}


def _port_engine(weights, cfg, ladder=LADDER, **kw):
    return ServingEngine(weights, cfg, default_cache_config(
        cfg, num_blocks=48, block_size=BLOCK),
        ladder=BucketLadder(**ladder), device="cpu", **kw)


def _jax_engine(model, weights, cf, ladder=LADDER, **kw):
    jcfg = JaxModelConfig.from_model(
        model, prefill_flash=False, decode_attention="reference",
        num_experts=E, moe_capacity_factor=cf)
    return JaxEngine(weights, jcfg, jax_cache_config(
        jcfg, num_blocks=48, block_size=BLOCK, kv_dtype="model"),
        ladder=JaxLadder(**ladder), **kw)


@pytest.fixture
def drops(monkeypatch):
    """Counts the choices the port's routing front drops while serving."""
    seen = {"calls": 0, "dropped": 0}
    real = expert_parallel._fused

    def counting(*a, **kw):
        rd = real(*a, **kw)
        seen["calls"] += 1
        seen["dropped"] += int((~rd.keep).sum())
        return rd

    monkeypatch.setattr(expert_parallel, "_fused", counting)
    return seen


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_engine_tokens_equal_jax(setup, cf, drops):
    model, _, jmoe, cfg, _, tmoe = setup
    _, want = _serve(_jax_engine(model, jmoe, cf), JaxRequest)
    teng = _port_engine(tmoe, _moe(cfg, cf))
    s, got = _serve(teng, Request)
    assert got == want
    assert s.requests_done == len(PROMPT_LENGTHS)
    assert teng.manager.free_blocks == 47            # every block returned
    # one routing call a layer a step; drops only below capacity = rows
    assert drops["calls"] == LAYERS * (len(PROMPT_LENGTHS) + s.decode_steps)
    assert (drops["dropped"] > 0) == (cf < 8.0)


def test_chunked_prefill_equals_jax(setup, drops):
    model, _, jmoe, cfg, _, tmoe = setup
    lad = dict(LADDER, chunks=(4,))
    _, want = _serve(_jax_engine(model, jmoe, 1.25, ladder=lad,
                                 prefill_chunk=4), JaxRequest)
    teng = _port_engine(tmoe, _moe(cfg, 1.25), ladder=lad, prefill_chunk=4)
    s, got = _serve(teng, Request)
    assert got == want
    assert s.prefill_chunks > len(PROMPT_LENGTHS) and drops["dropped"] > 0


def test_sequence_logits_match_jax(setup):
    model, _, jmoe, cfg, _, tmoe = setup
    toks = np.random.RandomState(5).randint(0, VOCAB, (2, 21))
    jcfg = JaxModelConfig.from_model(model, prefill_flash=False,
                                     num_experts=E, moe_capacity_factor=8.0)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_sequence_logits(jmoe, jcfg, jnp.asarray(toks)))
    got = gpt_sequence_logits(tmoe, _moe(cfg), torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_one_expert_serves_the_dense_model(setup):
    """E = 1: one logit, gate 1.0, capacity >= rows: the dense FFN."""
    _, _, _, cfg, tw, _ = setup
    _, want = _serve(_port_engine(tw, cfg), Request)
    moe1 = expand_moe_weights(tw, 1, torch.Generator().manual_seed(3))
    _, got = _serve(_port_engine(moe1, _moe(cfg, 8.0, 1)), Request)
    assert got == want


def test_expand_moe_weights_matches_jax(setup):
    _, jw, _, cfg, tw, tmoe = setup
    want = jax_expand(jw, E)                          # zero router
    got = expand_moe_weights(tw, E)
    for lw, jl in zip(got.layers, want.layers):
        assert isinstance(lw, MoELayerWeights)
        for name in MoELayerWeights._fields:
            np.testing.assert_array_equal(getattr(lw, name).numpy(),
                                          np.asarray(getattr(jl, name)),
                                          err_msg=name)
    drawn = expand_moe_weights(tw, E, torch.Generator().manual_seed(0))
    again = expand_moe_weights(tw, E, torch.Generator().manual_seed(0))
    r = drawn.layers[0].router
    assert r.dtype == torch.float32 and tuple(r.shape) == (HIDDEN, E)
    assert torch.equal(r, again.layers[0].router)
    assert 0.01 < float(r.std()) < 0.03
    assert not torch.equal(r, drawn.layers[1].router)
    # the carried JAX tree keeps its fp32 router and scaled experts
    assert tmoe.layers[0].router.dtype == torch.float32
    assert torch.allclose(tmoe.layers[0].wi[3],
                          1.15 * tw.layers[0].fc1_k, atol=1e-6)


def test_weights_checks(setup):
    _, _, _, cfg, tw, tmoe = setup
    with pytest.raises(ValueError, match="router"):
        check_serving_weights(tmoe, _moe(cfg, e=8))   # E differs
    with pytest.raises(ValueError, match="Q8"):
        quantize_weights(tmoe)
    with pytest.raises(ValueError, match="Q8"):
        serve_smoke(1, model="tiny", policy="Q8", moe_experts=2,
                    max_new_tokens=2, device="cpu")
    bf16 = tmoe._replace(layers=tuple(lw._replace(router=lw.router.half())
                                      for lw in tmoe.layers))
    with pytest.raises(ValueError, match="fp32"):
        ServingEngine(bf16, _moe(cfg), default_cache_config(
            cfg, num_blocks=8, block_size=BLOCK),
            ladder=BucketLadder(batch=(2,), pages=(2,)), device="cpu")


def test_serve_smoke_moe_equals_its_oracle():
    """The chip smoke's cf 8.0 reasoning at CPU size: with capacity = rows
    nothing drops, so every served token is the argmax of the
    teacher-forced ``gpt_sequence_logits`` through the plain versions."""
    s, eng = serve_smoke(3, model="tiny", moe_experts=4, max_new_tokens=4,
                         min_prompt=3, max_prompt=30, device="cpu")
    assert s.tokens_generated == 12
    mc = eng.model_cfg
    assert mc.num_experts == 4 and mc.moe_capacity_factor == 8.0
    assert all(isinstance(lw, MoELayerWeights) for lw in eng.weights.layers)
    for req in eng.done:
        seq = torch.tensor([req.prompt + req.out_tokens[:-1]])
        logits = gpt_sequence_logits(eng.weights, mc.plain(), seq)[0]
        want = logits[len(req.prompt) - 1:].argmax(dim=-1).tolist()
        assert req.out_tokens == want
