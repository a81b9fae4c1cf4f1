"""Port parity for the amp policies without master weights: O4 and O1
(op-level autocast over an fp32 model, flash attention) and O0 and O3
(``make_smoke_setup``'s materialized scores), each stepping its
parameters themselves on amp's staged route, against ``apex_tpu``'s,
from the same weights and batch, loss for loss over 3 steps.

O4 / O1: a JAX ``GPTModel(use_flash=True)`` (vocab 256, hidden 128, 2
heads so d = 64, 2 layers, seq 64, batch 2) initialized from
``PRNGKey(0)``; ``amp.initialize(..., fused_adam(1e-3, use_pallas=True),
opt_level=L)`` (no masters: the Adam step's Pallas kernel on the fp32
params, CPU interpret mode); each step ``jax.jit`` of ``jax.grad`` of
``autocast(loss_fn, policy=L)`` then ``apply_gradients``, at HIGHEST
matmul precision (the autocast's rounded operands are upcast on the CPU
and must not be truncated again).  The port: the same params through
``gpt_params_from_numpy`` into ``GPTModel(use_flash=True)``,
``apex_tpu_torch.amp.initialize(..., fused_adam(1e-3), L)`` and
``train_step``'s form (forward and loss under ``amp.autocast``).

O0 / O3: ``make_smoke_setup(opt_level=L, ...)`` at the same sizes (O3 at
fp16 compute, the port's recipe) and ``make_step_fn``, jitted; its
params and tokens go to the port's ``GPTModel(use_flash=False)`` in the
policy's dtype.  ``make_smoke_setup``'s ``fused_adam`` takes the jnp
path: it forms the step as ``p + delta`` with the delta in p's dtype,
where the port's kernel (and its plain version) rounds ``p - lr * u``
once; in fp32 the two agree, in O3's fp16 a parameter may differ by an
ulp.

Tolerances on the losses (the largest gap over the 3 steps, measured on
the CPU, in the parenthesis):
* O4: 1e-3 (1.6e-4: bf16 operands rounded at the same places, fp32 sums
  in other orders, flash's bf16 output);
* O1: 5e-4 (1.2e-4);
* O0: 2e-5 (2.9e-6);
* O3: 5e-4 (7.8e-5: fp16 activations rounded at other places by the two
  frameworks, and the update's rounding above).
Every policy: the (finite, scale, skipped) sequence exactly JAX's, the
params' dtypes the policy's, no master copy, the staged route.  O1's
planted inf: the step is skipped with params and moments bitwise held,
the count held and the scale halved.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jax_amp
from apex_tpu.amp.autocast import autocast as jax_autocast
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu.testing.standalone_gpt import GPTModel as JaxGPT
from apex_tpu.testing.standalone_gpt import gpt_loss as jax_gpt_loss
from apex_tpu.testing.standalone_gpt import (make_smoke_setup, make_step_fn,
                                             unbox)
from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.testing.standalone_gpt import (GPTModel, gpt_loss,
                                                   gpt_params_from_numpy)

VOCAB, HIDDEN, HEADS, LAYERS, SEQ, BATCH = 256, 128, 2, 2, 64, 2
LR, STEPS = 1e-3, 3
LOSS_TOL = {"O4": 1e-3, "O1": 5e-4, "O0": 2e-5, "O3": 5e-4}
PARAM_DTYPE = {"O4": torch.float32, "O1": torch.float32,
               "O0": torch.float32, "O3": torch.float16}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module's small tensors: on a loaded
    machine a pool of threads costs more than the ops themselves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch():
    toks = np.random.RandomState(0).randint(0, VOCAB, (BATCH, SEQ))
    return toks.astype(np.int32), np.roll(toks, -1, -1).astype(np.int32)


def _jax_autocast_run(level):
    toks, labels = _batch()
    model = JaxGPT(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS,
                   num_attention_heads=HEADS, max_sequence_length=SEQ,
                   attention_dropout=0.0, hidden_dropout=0.0,
                   use_flash=True, dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(toks))
    params_np = jax.tree.map(np.asarray, unbox(variables["params"]))
    params, aopt, state = jax_amp.initialize(
        variables["params"], jax_fused_adam(LR, use_pallas=True),
        opt_level=level)
    assert state.master_params is None
    t, lab = jnp.asarray(toks), jnp.asarray(labels)
    fwd = jax_autocast(lambda p: jax_gpt_loss(model.apply({"params": p}, t),
                                              lab), policy=aopt.policy)

    def step(params, state):
        def loss_fn(p):
            loss = fwd(p)
            return aopt.scale_loss(loss, state), loss

        grads, loss = jax.grad(loss_fn, has_aux=True)(params)
        params, state, info = aopt.apply_gradients(grads, state, params)
        return params, state, loss, info

    step = jax.jit(step)
    losses, infos = [], []
    with jax.default_matmul_precision("highest"):
        for _ in range(STEPS):
            params, state, loss, info = step(params, state)
            losses.append(float(loss))
            infos.append((bool(info.grads_finite), float(info.loss_scale),
                          int(info.steps_skipped)))
    return dict(params_np=params_np, losses=losses, infos=infos,
                dtypes={str(x.dtype) for x in jax.tree.leaves(params)})


def _jax_smoke_run(level):
    dtype = jnp.float16 if level == "O3" else jnp.float32
    setup = make_smoke_setup(vocab=VOCAB, hidden=HIDDEN, num_heads=HEADS,
                             num_layers=LAYERS, batch=BATCH, seq=SEQ,
                             opt_level=level, lr=LR, seed=0, dtype=dtype)
    assert setup.amp_state.master_params is None
    params_np = jax.tree.map(lambda x: np.asarray(x, np.float32),
                             unbox(setup.params))
    step = jax.jit(make_step_fn(setup))
    params, state = setup.params, setup.amp_state
    losses, infos = [], []
    with jax.default_matmul_precision("highest"):
        for _ in range(STEPS):
            params, state, loss, _, info = step(params, state)
            losses.append(float(loss))
            infos.append((bool(info.grads_finite), float(info.loss_scale),
                          int(info.steps_skipped)))
    return dict(params_np=params_np, losses=losses, infos=infos,
                tokens=np.array(setup.tokens), labels=np.array(setup.labels),
                dtypes={str(x.dtype) for x in jax.tree.leaves(params)})


def _port_setup(level, params_np):
    policy = amp.get_policy(level)
    net = GPTModel(VOCAB, HIDDEN, LAYERS, HEADS, SEQ,
                   use_flash=policy.cast_ops, dtype=policy.param_dtype,
                   device="cpu")
    net.load_state_dict(gpt_params_from_numpy(params_np))
    return amp.initialize(net, fused_adam(LR), opt_level=level)


def _port_step(net, aopt, t, lab):
    aopt.zero_grad()
    loss = amp.autocast(lambda: gpt_loss(net(t), lab),
                        policy=aopt.policy)()
    aopt.scale_loss(loss).backward()
    info = aopt.apply_gradients()
    return float(loss.detach()), (info.grads_finite, info.loss_scale,
                                  info.steps_skipped)


def _port_run(level, params_np, toks, labels):
    net, aopt = _port_setup(level, params_np)
    assert not aopt.use_pipeline and aopt.masters() == {}
    assert {p.dtype for p in net.parameters()} == {PARAM_DTYPE[level]}
    t, lab = torch.from_numpy(toks).long(), torch.from_numpy(labels).long()
    losses, infos = [], []
    for _ in range(STEPS):
        loss, info = _port_step(net, aopt, t, lab)
        losses.append(loss)
        infos.append(info)
    return dict(losses=losses, infos=infos, aopt=aopt)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX runs, shared by the tests (the Pallas kernels in interpret
    mode are the slow part)."""
    return {"O4": _jax_autocast_run("O4"), "O1": _jax_autocast_run("O1"),
            "O0": _jax_smoke_run("O0"), "O3": _jax_smoke_run("O3")}


@pytest.mark.parametrize("level", ["O4", "O1", "O0", "O3"])
def test_nomaster_steps_match_jax(jax_runs, level):
    j = jax_runs[level]
    toks, labels = (j["tokens"], j["labels"]) if "tokens" in j else _batch()
    p = _port_run(level, j["params_np"], toks, labels)
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=0,
                               atol=LOSS_TOL[level])
    assert p["losses"][-1] < p["losses"][0]
    assert p["infos"] == j["infos"]
    want_scale = 2.0 ** 16 if level == "O1" else 1.0
    assert p["infos"] == [(True, want_scale, 0)] * STEPS
    assert j["dtypes"] == {str(jnp.dtype(
        str(PARAM_DTYPE[level]).replace("torch.", "")))}
    # fp32 moments a parameter, the count advanced every step
    state = p["aopt"].state
    assert state.count == STEPS
    assert {m.dtype for m in (*state.m, *state.v)} == {torch.float32}


def test_o1_planted_inf_skips_bitwise(jax_runs):
    toks, labels = _batch()
    net, aopt = _port_setup("O1", jax_runs["O1"]["params_np"])
    t, lab = torch.from_numpy(toks).long(), torch.from_numpy(labels).long()
    _port_step(net, aopt, t, lab)
    before = [x.clone() for x in (*aopt._masters, *aopt.state.m,
                                  *aopt.state.v)]
    count, scale = aopt.state.count, aopt.scaler.loss_scale
    aopt.zero_grad()
    loss = amp.autocast(lambda: gpt_loss(net(t), lab), policy=amp.O1)()
    aopt.scale_loss(loss).backward()
    name, param = aopt.params[3]
    param.grad.view(-1)[0] = float("inf")
    info = aopt.apply_gradients()
    assert info.grads_checked and not info.grads_finite
    assert (info.loss_scale, info.steps_skipped) == (scale / 2, 1)
    after = [*aopt._masters, *aopt.state.m, *aopt.state.v]
    assert all(torch.equal(a, b) for a, b in zip(before, after)), name
    assert aopt.state.count == count
    # the next step applies
    _, info = _port_step(net, aopt, t, lab)
    assert info[0] and aopt.state.count == count + 1


def test_nomaster_routes_and_refusals():
    net = GPTModel(64, 128, 1, 2, 16, device="cpu")
    # pipeline=True without masters raises, as JAX's constructor does
    with pytest.raises(ValueError, match="master weights"):
        amp.initialize(net, fused_adam(1e-3), opt_level="O4", pipeline=True)
    with pytest.raises(ValueError, match="master weights"):
        jax_amp.AmpOptimizer(jax_fused_adam(1e-3), jax_amp.O4,
                             pipeline=True)
    # an optimizer with no low-precision-parameter lane refuses O3
    from apex_tpu_torch.optimizers import fused_sgd
    net3 = GPTModel(64, 128, 1, 2, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="fp32 parameters only"):
        amp.initialize(net3, fused_sgd(0.1, momentum=0.9), opt_level="O3")
    # a cast_ops policy refuses a loss computed outside autocast
    net4 = GPTModel(64, 128, 1, 2, 16, device="cpu").reset_parameters(
        torch.Generator().manual_seed(0))
    net4, aopt = amp.initialize(net4, fused_adam(1e-3), opt_level="O4")
    toks = torch.randint(0, 64, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    with pytest.raises(RuntimeError, match="amp.autocast"):
        aopt.scale_loss(gpt_loss(net4(toks), toks.roll(-1, -1)))
    # ... also after some other autocast region ran (an eval forward),
    # and for a loss from a region in another compute dtype
    with torch.no_grad():
        amp.autocast(net4, policy=amp.O4)(toks)
    with pytest.raises(RuntimeError, match="amp.autocast"):
        aopt.scale_loss(gpt_loss(net4(toks), toks.roll(-1, -1)))
    with pytest.raises(RuntimeError, match="amp.autocast"):
        aopt.scale_loss(amp.autocast(
            lambda: gpt_loss(net4(toks), toks.roll(-1, -1)),
            policy=amp.O1)())
    loss = amp.autocast(lambda: gpt_loss(net4(toks), toks.roll(-1, -1)),
                        policy=amp.O4)()
    aopt.scale_loss(loss).backward()
    info = aopt.apply_gradients()
    assert not info.grads_checked and info.grads_finite


@pytest.mark.parametrize("level", ["O4", "O3"])
def test_train_cli_nomaster_on_the_cpu(level, capsys):
    from apex_tpu_torch.testing.standalone_gpt import main

    assert main(["--train", "--policy", level, "--model", "tiny",
                 "--device", "cpu", "--steps", "3"]) == 0
    out = capsys.readouterr().out
    line = [x for x in out.splitlines() if x.startswith("TRAIN_DONE")][0]
    fields = dict(kv.split("=") for kv in line.split()[1:])
    assert fields["policy"] == level and fields["skipped"] == "0"
    assert float(fields["loss_last"]) < float(fields["loss_first"])
