"""Port parity for the BERT slice: ``apex_tpu_torch.testing.
standalone_bert`` against ``apex_tpu.testing.standalone_bert``, from the
same weights, on the same padded batch.

A JAX ``BertModel`` (vocab 256, hidden 128, 2 heads so d = 64, 2 layers,
seq 64, batch 4) is initialized from ``PRNGKey(0)``; its fp32 params go
through ``bert_params_from_numpy`` into the port's ``BertModel``.  The
batch is drawn from ``RandomState(0)``: tokens, labels = tokens rolled
by one, NSP labels, and a padding mask whose rows keep 64, 40, 17 and 53
tokens (so the extended mask masks 24 + 47 + 11 query rows whole).

* The mask function equals JAX's; the weight mapper covers every flax
  leaf exactly once (with and without a token-type table).
* The forward, fp32, no amp: the LM and NSP logits on the flash route
  (the (b, s) mask on the E kernels' kv_mask lane) and on the
  materialized route (the extended mask through the padding softmax),
  with and without token types: 2e-5 (measured 1.2e-6).
* Four train steps, the JAX side jitted at HIGHEST matmul precision with
  ``APEX_TPU_PIPELINE_PALLAS=1`` (its Pallas kernels in CPU interpret
  mode: LayerNorm, the E flash forward and backward with kv_mask, LAMB
  phase 1, the padding softmax, the Adam and norm sweeps), the port on
  the CPU through the plain versions:

  - O5 with ``fused_lamb(1e-3)`` on the flash route, the model computing
    in fp32 (params bf16 by the policy): losses 1e-5 (measured 9.5e-7);
  - the same in bf16 compute, bench.py's recipe: losses 5e-3 (measured
    6.1e-4, and 1.6e-3 on another seeded batch of these shapes; the
    bf16 activations round at other places in the two frameworks, one
    or two bf16 ulps of the logits at step 1);
  - O2 with ``fused_adam(1e-3)`` in fp16 compute on the padding-softmax
    route (row 5), dynamic scale from 2^16: losses 5e-4 (measured
    5.5e-5, and 1.6e-4 on another seeded batch: the forward's fp16
    rounding, the transformer's output one fp16 ulp apart in places;
    the GPT tests' 2e-4 would leave too little room), and the (finite,
    scale, skipped) sequence exactly JAX's (step 1 overflows in fp16 on
    both sides).
* The CLI on ``--device cpu`` prints its ``TRAIN_DONE`` line.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jax_amp
from apex_tpu.contrib.xentropy import \
    softmax_cross_entropy_loss as jax_xentropy
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu.optimizers import fused_lamb as jax_fused_lamb
from apex_tpu.testing.standalone_bert import BertModel as JaxBert
from apex_tpu.testing.standalone_bert import \
    bert_extended_attention_mask as jax_ext_mask
from apex_tpu.testing.standalone_gpt import unbox
from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import fused_adam, fused_lamb
from apex_tpu_torch.testing import standalone_bert
from apex_tpu_torch.testing.standalone_bert import (
    BertModel, bert_extended_attention_mask, bert_loss,
    bert_params_from_numpy, padded_mask)

VOCAB, HIDDEN, HEADS, LAYERS, SEQ, BATCH = 256, 128, 2, 2, 64, 4
LENS = (64, 40, 17, 53)
LR, STEPS = 1e-3, 4
FWD_TOL = 2e-5
LOSS_TOL = {"O5-f32": 1e-5, "O5-bf16": 5e-3, "O2-f16": 5e-4}
JAXD = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
TORCHD = {"f32": torch.float32, "bf16": torch.bfloat16,
          "f16": torch.float16}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    toks = rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
    mask = (np.arange(SEQ)[None] < np.array(LENS)[:, None]).astype(np.int32)
    nsp = rng.randint(0, 2, BATCH).astype(np.int32)
    return dict(toks=toks, mask=mask, labels=np.roll(toks, -1, -1), nsp=nsp,
                types=rng.randint(0, 2, (BATCH, SEQ)).astype(np.int32))


def _jax_model(use_flash, dtype):
    return JaxBert(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS,
                   num_attention_heads=HEADS, max_sequence_length=SEQ,
                   attention_dropout=0.0, hidden_dropout=0.0,
                   use_flash=use_flash, dtype=dtype)


def _port_model(use_flash, dtype, params_np, num_tokentypes=0):
    net = BertModel(VOCAB, HIDDEN, LAYERS, HEADS, SEQ,
                    num_tokentypes=num_tokentypes, use_flash=use_flash,
                    dtype=dtype, device="cpu")
    net.load_state_dict(bert_params_from_numpy(params_np))
    return net


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_extended_mask_matches_jax(batch):
    want = np.asarray(jax_ext_mask(jnp.asarray(batch["mask"], jnp.float32)))
    got = bert_extended_attention_mask(_t(batch["mask"]))
    assert got.dtype == torch.bool and got.shape == (BATCH, 1, SEQ, SEQ)
    np.testing.assert_array_equal(got.numpy(), want)
    # every padded query row is masked whole
    assert got[1, 0, LENS[1]:].all() and not got[1, 0, :LENS[1]].all()


def test_padded_mask_keeps_a_quarter_full():
    g = torch.Generator().manual_seed(0)
    m = padded_mask(16, 512, g)
    lens = m.sum(-1)
    assert (lens[:4] == 512).all() and lens.min() >= 128
    assert (m[:, :-1] >= m[:, 1:]).all()          # tails padded


def test_model_flops_count_live_pairs():
    """bench.py's formula on an all-ones mask; on a padded one the
    attention term counts only the (query, key) pairs both real."""
    n, layers, hidden, b, s = 1000, 2, 128, 4, 64
    ones = torch.ones(b, s, dtype=torch.long)
    assert standalone_bert.bert_model_flops(n, layers, hidden, ones) == \
        6.0 * n * b * s + 12.0 * layers * hidden * b * s * s
    pairs = sum(x * x for x in LENS)
    assert standalone_bert.bert_model_flops(
        n, layers, hidden, _t(np.asarray(
            [[1] * x + [0] * (s - x) for x in LENS]))) == \
        6.0 * n * b * s + 12.0 * layers * hidden * pairs


@pytest.mark.parametrize("tokentypes", [False, True])
def test_params_map_every_flax_leaf_once(batch, tokentypes):
    model = _jax_model(True, jnp.float32)
    args = (jnp.asarray(batch["toks"]), jnp.asarray(batch["mask"]))
    if tokentypes:
        args += (jnp.asarray(batch["types"]),)
    params = jax.tree.map(np.asarray, unbox(
        model.init(jax.random.PRNGKey(0), *args)["params"]))
    leaves = jax.tree_util.tree_leaves_with_path(params)
    names = [".".join(k.key for k in path) for path, _ in leaves]
    mapped = bert_params_from_numpy(params)
    assert sorted(mapped) == sorted(names) and len(set(names)) == len(names)
    net = BertModel(VOCAB, HIDDEN, LAYERS, HEADS, SEQ,
                    num_tokentypes=2 if tokentypes else 0, device="cpu")
    assert sorted(dict(net.named_parameters())) == sorted(names)
    net.load_state_dict(mapped)                  # strict: all, no more
    for (path, leaf) in leaves:
        name = ".".join(k.key for k in path)
        assert np.array_equal(net.get_parameter(name).detach().numpy(),
                              leaf)


@pytest.mark.parametrize("use_flash,tokentypes", [(True, False),
                                                  (False, False),
                                                  (True, True)])
def test_forward_matches_jax(batch, use_flash, tokentypes):
    model = _jax_model(use_flash, jnp.float32)
    args = [jnp.asarray(batch["toks"]), jnp.asarray(batch["mask"])]
    if tokentypes:
        args.append(jnp.asarray(batch["types"]))
    params = model.init(jax.random.PRNGKey(1), *args)["params"]
    with jax.default_matmul_precision("highest"):
        lm_j, nsp_j = model.apply({"params": params}, *args)
    net = _port_model(use_flash, torch.float32,
                      jax.tree.map(np.asarray, unbox(params)),
                      num_tokentypes=2 if tokentypes else 0)
    with torch.no_grad():
        lm_t, nsp_t = net(*(_t(a) for a in args))
    assert lm_t.shape == (BATCH, SEQ, VOCAB) and nsp_t.shape == (BATCH, 2)
    assert nsp_t.dtype == torch.float32
    np.testing.assert_allclose(lm_t.numpy(), np.asarray(lm_j), rtol=0,
                               atol=FWD_TOL)
    np.testing.assert_allclose(nsp_t.numpy(), np.asarray(nsp_j), rtol=0,
                               atol=FWD_TOL)


def _runs(batch, policy, dt):
    """``(jax losses and infos, port losses and infos)`` over STEPS
    steps from the same weights."""
    use_flash = policy == "O5"
    model = _jax_model(use_flash, JAXD[dt])
    toks, mask, labels, nsp = (jnp.asarray(batch[k]) for k in
                               ("toks", "mask", "labels", "nsp"))
    variables = model.init(jax.random.PRNGKey(0), toks, mask)
    params_np = jax.tree.map(np.asarray, unbox(variables["params"]))
    tx = jax_fused_lamb(LR, use_pallas=True) if use_flash else \
        jax_fused_adam(LR, use_pallas=True)
    params, aopt, state = jax_amp.initialize(
        variables["params"], tx, opt_level=policy, pipeline=True)

    def step(params, state):
        def loss_fn(p):
            lm, bl = model.apply({"params": p}, toks, mask, lm_labels=labels)
            loss = jnp.mean(lm) + jnp.mean(jax_xentropy(
                bl, nsp, half_to_float=True))
            return aopt.scale_loss(loss, state), loss

        grads, loss = jax.grad(loss_fn, has_aux=True)(params)
        params, state, info = aopt.apply_gradients(grads, state, params)
        return params, state, loss, info

    step = jax.jit(step)
    jl, ji = [], []
    with jax.default_matmul_precision("highest"):
        for _ in range(STEPS):
            params, state, loss, info = step(params, state)
            jl.append(float(loss))
            ji.append((bool(info.grads_finite), float(info.loss_scale),
                       int(info.steps_skipped)))
    net = _port_model(use_flash, TORCHD[dt], params_np)
    opt = fused_lamb(LR) if use_flash else fused_adam(LR)
    net, ao = amp.initialize(net, opt, opt_level=policy, pipeline=True)
    t = [_t(batch[k]) for k in ("toks", "mask", "labels", "nsp")]
    tl, ti = [], []
    for _ in range(STEPS):
        ao.zero_grad()
        loss = bert_loss(net, *t)
        ao.scale_loss(loss).backward()
        info = ao.apply_gradients()
        tl.append(float(loss.detach()))
        ti.append((info.grads_finite, info.loss_scale, info.steps_skipped))
    return (jl, ji), (tl, ti)


@pytest.fixture(scope="module")
def pallas_pipeline():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_PIPELINE_PALLAS", "1")
        yield


@pytest.mark.parametrize("policy,dt", [("O5", "f32"), ("O5", "bf16"),
                                       ("O2", "f16")])
def test_train_steps_match_jax(batch, pallas_pipeline, policy, dt):
    (jl, ji), (tl, ti) = _runs(batch, policy, dt)
    np.testing.assert_allclose(tl, jl, rtol=0,
                               atol=LOSS_TOL[f"{policy}-{dt}"])
    assert ti == ji
    assert tl[-1] < tl[0]
    if policy == "O2":
        assert ti[0] == (False, 2.0 ** 15, 1) and all(f for f, _, _ in
                                                     ti[1:])


def test_cli_on_the_cpu(capsys):
    assert standalone_bert.main(["--train", "--model", "tiny", "--device",
                                 "cpu", "--steps", "3", "--policy",
                                 "O5"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("TRAIN_DONE model=bert-tiny policy=O5 steps=3")
    fields = dict(kv.split("=", 1) for kv in line.split()[1:])
    assert float(fields["loss_last"]) < float(fields["loss_first"])
    assert fields["device"] == "cpu" and fields["skipped"] == "0"


def test_cli_full_mask_on_the_cpu(capsys):
    """``--full-mask`` trains on bench.py's all-ones mask: every token
    real, so both token rates agree."""
    assert standalone_bert.main(["--train", "--model", "tiny", "--device",
                                 "cpu", "--steps", "2", "--full-mask"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    fields = dict(kv.split("=", 1) for kv in line.split()[1:])
    assert fields["real_tokens"] == "256/256"
    assert fields["real_tokens_s"] == fields["tokens_s"]
