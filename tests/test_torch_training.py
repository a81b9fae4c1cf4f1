"""Port parity for the training slice: the whole O5 GPT train step of
``apex_tpu_torch`` against ``apex_tpu``'s, from the same weights.

A JAX ``GPTModel(use_flash=True)`` (vocab 256, hidden 128, 2 heads so
d = 64, 2 layers, seq 64, batch 2) is initialized from a seed and goes
through ``amp.initialize(..., fused_adam(1e-3, use_pallas=True),
opt_level="O5", pipeline=True)``; its fp32 params, as numpy, go through
``gpt_params_from_numpy`` into the port's ``GPTModel`` and
``apex_tpu_torch.amp.initialize(..., fused_adam(1e-3), "O5")``.  Both
take 4 steps on the same batch: the JAX side jitted at HIGHEST matmul
precision with its Pallas kernels (LayerNorm, E-layout flash, the Adam
sweep) in CPU interpret mode, the port on the CPU through the plain
versions inside its autograd Functions and sweep.

Tolerances:
* fp32 compute (the model dtype fp32, the params cast to bf16 per the
  policy, as ``make_smoke_setup`` does): losses 1e-4; masters: 99.9 %
  of elements within 1e-5, and every element within lr = 1e-3, one
  Adam step's nominal size — Adam divides by sqrt(v), so an element
  whose gradient is near zero turns a 1e-7 gradient difference into a
  step-sized one (measured: 0.05 % of elements beyond 1e-5, max
  2.8e-4).
* bf16 compute: losses 2e-2 (bf16 activations rounded at other places
  by the two frameworks; measured ~5e-4).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jax_amp
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu.testing.standalone_gpt import GPTModel as JaxGPT
from apex_tpu.testing.standalone_gpt import gpt_loss as jax_gpt_loss
from apex_tpu.testing.standalone_gpt import unbox
from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.testing.standalone_gpt import (GPTModel, gpt_loss,
                                                   gpt_params_from_numpy)

VOCAB, HIDDEN, HEADS, LAYERS, SEQ, BATCH = 256, 128, 2, 2, 64, 2
LR, STEPS = 1e-3, 4
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
    return net, losses, aopt.masters()


@pytest.fixture(scope="module")
def batch():
    toks = np.random.RandomState(0).randint(0, VOCAB, (BATCH, SEQ))
    return toks.astype(np.int32), np.roll(toks, -1, -1).astype(np.int32)


def test_o5_fp32_compute_step_matches_jax(batch):
    params_np, jl, jm = _jax_run(jnp.float32, *batch)
    net, tl, tm = _port_run(torch.float32, params_np, *batch)
    # O5 casts every parameter, LayerNorm's too, to bf16
    assert {p.dtype for p in net.parameters()} == {torch.bfloat16}
    np.testing.assert_allclose(tl, jl, rtol=0, atol=F32_LOSS_TOL)
    assert tl[-1] < tl[0]
    assert set(tm) == set(jm)
    diff = torch.cat([(tm[k] - jm[k]).abs().flatten() for k in jm])
    assert float((diff <= MASTER_TOL).float().mean()) >= MASTER_SHARE
    assert float(diff.max()) <= LR
    # the masters moved: the step was taken
    start = gpt_params_from_numpy(params_np)
    assert all(not torch.equal(tm[k], start[k]) for k in
               ("embedding.word_embeddings.embedding",
                "transformer.final_layernorm.weight"))


def test_o5_bf16_compute_step_matches_jax(batch):
    params_np, jl, _ = _jax_run(jnp.bfloat16, *batch)
    _, tl, _ = _port_run(torch.bfloat16, params_np, *batch)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=BF16_LOSS_TOL)
    assert tl[-1] < tl[0]


def test_grads_are_views_of_the_flat_buffer():
    # backward accumulates into the flat gradient buffer in place, the
    # tied embedding's two uses summed
    net = GPTModel(64, 128, 1, 2, 16, device="cpu").reset_parameters(
        torch.Generator().manual_seed(1))
    net, aopt = amp.initialize(net, fused_adam(1e-3), opt_level="O5",
                               pipeline=True)
    (group,) = aopt.groups
    toks = torch.randint(0, 64, (2, 16), generator=torch.Generator()
                         .manual_seed(2))
    aopt.zero_grad()
    aopt.scale_loss(gpt_loss(net(toks), toks.roll(-1, -1))).backward()
    for p, off in zip(group.params, group.offsets):
        assert p.grad.data_ptr() == group.grad[off:].data_ptr()
        assert p.data_ptr() == group.data[off:].data_ptr()
    assert float(group.grad.float().abs().sum()) > 0
    before = group.data.clone()
    aopt.apply_gradients()
    assert not torch.equal(before, group.data)   # the model copy moved
    net.zero_grad()                 # grads to None: the views are gone
    with pytest.raises(RuntimeError, match="amp_opt.zero_grad"):
        aopt.apply_gradients()


def test_unported_paths_raise():
    # (the (b, h, s, d) flash attention's backward, row 8, was checked
    # here until it was ported: tests/test_torch_flash_attention_bwd.py)
    # (global-norm clipping was checked here until it was ported:
    # tests/test_torch_optim_recipe.py)
    # a policy without master weights (O3: fp16 params stepped directly)
    net = GPTModel(64, 128, 1, 2, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="master weights"):
        amp.initialize(net, fused_adam(1e-3), opt_level="O3")


def test_batchnorm_params_stay_fp32_in_their_own_group():
    # O5 keeps batch-norm parameters fp32 (by name, as the JAX
    # predicate): they form an fp32 group whose parameters are their own
    # masters and get no low-precision copy
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.dense = torch.nn.Linear(8, 8)
            self.bn = torch.nn.BatchNorm1d(8)

        def forward(self, x):
            return self.bn(self.dense(x.to(self.dense.weight.dtype)).float())

    net = Net()
    net, aopt = amp.initialize(net, fused_adam(1e-2), opt_level="O5",
                               pipeline=True)
    assert [g.dtype for g in aopt.groups] == [torch.bfloat16, torch.float32]
    low, full = aopt.groups
    assert full.master is full.data and full.lowp is None
    assert net.bn.weight.dtype == torch.float32
    assert net.dense.weight.dtype == torch.bfloat16
    before = {k: v.clone() for k, v in aopt.masters().items()}
    aopt.zero_grad()
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    aopt.scale_loss(net(x).square().mean()).backward()
    aopt.apply_gradients()
    after = aopt.masters()
    assert all(not torch.equal(before[k], after[k]) for k in before)
    assert torch.equal(net.dense.weight, after["dense.weight"].bfloat16())
    assert torch.equal(net.bn.weight, after["bn.weight"])
