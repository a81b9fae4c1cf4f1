"""Port parity for the long-sequence train step: the O5 GPT train step of
``apex_tpu_torch`` against ``apex_tpu``'s at seq 1152, where the JAX
package's E-layout attention takes its blocked walk (the 128-padded
sequence is past one 1024-row block: ``_flash_fwd_e_blocked`` and
``_flash_bwd_e_blocked``, rows 11 and 13), from the same weights.

The recipe is ``tests/test_torch_training.py``'s: a JAX
``GPTModel(use_flash=True)`` (vocab 256, hidden 128, 2 heads so d = 64,
1 layer, seq 1152, batch 1) is initialized from a seed and goes through
``amp.initialize(..., fused_adam(1e-3, use_pallas=True),
opt_level="O5", pipeline=True)``; its fp32 params, as numpy, go through
``gpt_params_from_numpy`` into the port's ``GPTModel`` and
``apex_tpu_torch.amp.initialize(..., fused_adam(1e-3), "O5")``.  Both
take 3 steps on the same batch: the JAX side jitted at HIGHEST matmul
precision with its Pallas kernels in CPU interpret mode, the port on the
CPU through the plain versions (which the port's E entry names
``flash_attention_e_blocked`` / ``_bwd_blocked`` at this length).

Tolerances (``tests/test_torch_training.py``'s): fp32 compute losses
1e-4; masters 99.9 % of elements within 1e-5 and every element within
lr = 1e-3 (Adam's division by sqrt(v) turns a 1e-7 gradient difference
on a near-zero gradient into a step-sized one); bf16 compute losses
2e-2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jax_amp
from apex_tpu.ops.flash_attention import _e_mode
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu.testing.standalone_gpt import GPTModel as JaxGPT
from apex_tpu.testing.standalone_gpt import gpt_loss as jax_gpt_loss
from apex_tpu.testing.standalone_gpt import unbox
from apex_tpu_torch import amp
from apex_tpu_torch.ops import e_mode
from apex_tpu_torch.ops.flash_attention import _e_counter
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.testing.standalone_gpt import (MODELS, GPTModel,
                                                   gpt_loss,
                                                   gpt_params_from_numpy,
                                                   model_flops)

VOCAB, HIDDEN, HEADS, LAYERS, SEQ, BATCH = 256, 128, 2, 1, 1152, 1
LR, STEPS = 1e-3, 3
F32_LOSS_TOL = 1e-4
MASTER_TOL, MASTER_SHARE = 1e-5, 0.999
BF16_LOSS_TOL = 2e-2


def _jax_run(dtype, toks, labels):
    model = JaxGPT(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS,
                   num_attention_heads=HEADS, max_sequence_length=SEQ,
                   attention_dropout=0.0, hidden_dropout=0.0,
                   use_flash=True, dtype=dtype)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(toks))
    params_np = jax.tree.map(np.asarray, unbox(variables["params"]))
    params, aopt, state = jax_amp.initialize(
        variables["params"], jax_fused_adam(LR, use_pallas=True),
        opt_level="O5", pipeline=True)
    t, lab = jnp.asarray(toks), jnp.asarray(labels)

    def step(params, state):
        def loss_fn(p):
            loss = jax_gpt_loss(model.apply({"params": p}, t), lab)
            return aopt.scale_loss(loss, state), loss

        grads, loss = jax.grad(loss_fn, has_aux=True)(params)
        params, state, _ = aopt.apply_gradients(grads, state, params)
        return params, state, loss

    step = jax.jit(step)
    losses = []
    with jax.default_matmul_precision("highest"):
        for _ in range(STEPS):
            params, state, loss = step(params, state)
            losses.append(float(loss))
    template = jax.tree.map(lambda x: x.astype(jnp.float32), params)
    masters = jax.tree.map(np.asarray,
                           unbox(state.master_params.to_model(template)))
    return params_np, losses, gpt_params_from_numpy(masters)


def _port_run(dtype, params_np, toks, labels):
    net = GPTModel(VOCAB, HIDDEN, LAYERS, HEADS, SEQ, dtype=dtype,
                   device="cpu")
    net.load_state_dict(gpt_params_from_numpy(params_np))
    net, aopt = amp.initialize(net, fused_adam(LR), opt_level="O5",
                               pipeline=True)
    t, lab = torch.from_numpy(toks).long(), torch.from_numpy(labels).long()
    losses = []
    for _ in range(STEPS):
        aopt.zero_grad()
        loss = gpt_loss(net(t), lab)
        aopt.scale_loss(loss).backward()
        aopt.apply_gradients()
        losses.append(float(loss.detach()))
    return losses, aopt.masters()


@pytest.fixture(scope="module")
def batch():
    toks = np.random.RandomState(0).randint(0, VOCAB, (BATCH, SEQ))
    return toks.astype(np.int32), np.roll(toks, -1, -1).astype(np.int32)


def test_both_sides_take_the_blocked_route():
    assert _e_mode(SEQ, HEADS, HIDDEN // HEADS)[0] == "blocked"
    assert e_mode(SEQ) == "blocked" and e_mode(1024) == "single"
    assert _e_counter(SEQ, None) == "flash_attention_e_blocked"
    assert _e_counter(SEQ, None, bwd=True) == \
        "flash_attention_e_bwd_blocked"
    # the long-sequence preset: GPT-345M at bench.py's gpt2_345m_s2048
    geo = MODELS["gpt345m_s2048"]
    assert (geo["seq"], geo["batch"], geo["max_seq"]) == (2048, 4, 2048)
    assert e_mode(geo["seq"]) == "blocked"
    assert _e_mode(geo["seq"], geo["num_heads"],
                   geo["hidden_size"] // geo["num_heads"])[0] == "blocked"


def test_o5_fp32_compute_step_matches_jax(batch):
    params_np, jl, jm = _jax_run(jnp.float32, *batch)
    tl, tm = _port_run(torch.float32, params_np, *batch)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=F32_LOSS_TOL)
    assert tl[-1] < tl[0]
    assert set(tm) == set(jm)
    diff = torch.cat([(tm[k] - jm[k]).abs().flatten() for k in jm])
    assert float((diff <= MASTER_TOL).float().mean()) >= MASTER_SHARE
    assert float(diff.max()) <= LR
    # the position table has SEQ rows, and the step moved it
    assert tm["embedding.position_embeddings.embedding"].shape == \
        (SEQ, HIDDEN)
    start = gpt_params_from_numpy(params_np)
    assert not torch.equal(tm["embedding.position_embeddings.embedding"],
                           start["embedding.position_embeddings.embedding"])


def test_o5_bf16_compute_step_matches_jax(batch):
    params_np, jl, _ = _jax_run(jnp.bfloat16, *batch)
    tl, _ = _port_run(torch.bfloat16, params_np, *batch)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=BF16_LOSS_TOL)
    assert tl[-1] < tl[0]


def test_long_preset_flops_count_the_position_table():
    # bench.py:2251-2252: 6 N tokens + 12 L hidden b s^2, N with the
    # 2048-row position table (the model built on the meta device)
    geo = MODELS["gpt345m_s2048"]
    net = GPTModel(geo["vocab_size"], geo["hidden_size"], geo["num_layers"],
                   geo["num_heads"], geo["max_seq"], device="meta")
    n = sum(p.numel() for p in net.parameters())
    assert n == 354_871_296 + 1024 * 1024       # 1024 more position rows
    b, s, L, hd = geo["batch"], geo["seq"], geo["num_layers"], \
        geo["hidden_size"]
    assert model_flops("gpt345m_s2048", n) == \
        6.0 * n * b * s + 12.0 * L * hd * s * s * b
