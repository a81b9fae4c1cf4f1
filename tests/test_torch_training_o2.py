"""Port parity for the O2 train step: fp16 parameters, fp32 masters and a
dynamic loss scale, through the materialized-scores attention
(``use_flash=False``) and the fused causal softmax, against
``apex_tpu``'s, from the same weights.

A JAX ``GPTModel(use_flash=False)`` (vocab 256, hidden 128, 2 layers, 2
heads, seq 64, batch 2) is initialized from ``PRNGKey(0)`` and goes
through ``amp.initialize(..., fused_adam(1e-3, use_pallas=True),
opt_level="O2", pipeline=True)`` with ``APEX_TPU_PIPELINE_PALLAS=1``, so
the norm/finite sweep and the Adam sweep run their Pallas kernels (CPU
interpret mode), as does the causal softmax in fp16 compute; matmuls at
HIGHEST precision.  Its fp32 params go through ``gpt_params_from_numpy``
into the port's ``GPTModel(use_flash=False)`` and
``apex_tpu_torch.amp.initialize(..., fused_adam(1e-3), "O2")``, which
runs the plain versions on the CPU.  Both take steps on one batch drawn
from ``RandomState(0)`` (labels rolled by one).

Tolerances:
* fp32 compute (the params fp16 per the policy, the model computing in
  fp32, as ``make_smoke_setup``'s default): losses 1e-4 (measured 9.5e-7
  at most); grad norm 1e-4 relative (measured 5e-6); masters under the
  O5 test's rule (99.9 % within 1e-5, all within lr); the (finite,
  scale, skipped) sequence exact.
* fp16 compute: losses 2e-4.  fp16 activations round at other places in
  the two frameworks (PyTorch's CPU fp16 matmuls against XLA's);
  measured 5.1e-5 at most over the 4 steps (4.8e-6 at step 1).
* fp16 compute from a scale of 2^40: 6 skipped steps (the scale 2^24 by
  the clip, then halving to 2^19) and 4 applied ones at 2^19, the
  sequence exactly JAX's; the port's masters, moments and fp16 params
  bitwise unchanged by every skipped step.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jax_amp
from apex_tpu.amp import scaler as jax_scaler
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu.testing.standalone_gpt import GPTModel as JaxGPT
from apex_tpu.testing.standalone_gpt import gpt_loss as jax_gpt_loss
from apex_tpu.testing.standalone_gpt import unbox
from apex_tpu_torch import amp
from apex_tpu_torch.amp import scaler
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.testing.standalone_gpt import (GPTModel, gpt_loss,
                                                   gpt_params_from_numpy)

VOCAB, HIDDEN, HEADS, LAYERS, SEQ, BATCH = 256, 128, 2, 2, 64, 2
LR, STEPS, OVERFLOW_STEPS = 1e-3, 4, 10
F32_LOSS_TOL, GNORM_RTOL = 1e-4, 1e-4
MASTER_TOL, MASTER_SHARE = 1e-5, 0.999
FP16_LOSS_TOL = 2e-4
HUGE_SCALE = 2.0 ** 40


def _batch():
    toks = np.random.RandomState(0).randint(0, VOCAB, (BATCH, SEQ))
    return toks.astype(np.int32), np.roll(toks, -1, -1).astype(np.int32)


def _jax_run(dtype, steps, start_scale=None):
    toks, labels = _batch()
    model = JaxGPT(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS,
                   num_attention_heads=HEADS, max_sequence_length=SEQ,
                   attention_dropout=0.0, hidden_dropout=0.0,
                   use_flash=False, dtype=dtype)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(toks))
    params_np = jax.tree.map(np.asarray, unbox(variables["params"]))
    params, aopt, state = jax_amp.initialize(
        variables["params"], jax_fused_adam(LR, use_pallas=True),
        opt_level="O2", pipeline=True)
    if start_scale is not None:
        s = state.scalers[0]
        state = state._replace(scalers=(
            s._replace(loss_scale=jnp.float32(start_scale)),))
    t, lab = jnp.asarray(toks), jnp.asarray(labels)

    def step(params, state):
        def loss_fn(p):
            loss = jax_gpt_loss(model.apply({"params": p}, t), lab)
            return aopt.scale_loss(loss, state), loss

        grads, loss = jax.grad(loss_fn, has_aux=True)(params)
        params, state, info = aopt.apply_gradients(grads, state, params)
        return params, state, loss, info

    step = jax.jit(step)
    losses, infos = [], []
    with jax.default_matmul_precision("highest"):
        for _ in range(steps):
            params, state, loss, info = step(params, state)
            losses.append(float(loss))
            infos.append((bool(info.grads_finite), float(info.loss_scale),
                          int(info.steps_skipped), float(info.grad_norm)))
    template = jax.tree.map(lambda x: x.astype(jnp.float32), params)
    masters = jax.tree.map(np.asarray,
                           unbox(state.master_params.to_model(template)))
    return dict(params_np=params_np, losses=losses, infos=infos,
                masters=gpt_params_from_numpy(masters))


def _port_run(dtype, params_np, steps, start_scale=None):
    toks, labels = _batch()
    net = GPTModel(VOCAB, HIDDEN, LAYERS, HEADS, SEQ, use_flash=False,
                   dtype=dtype, device="cpu")
    net.load_state_dict(gpt_params_from_numpy(params_np))
    net, aopt = amp.initialize(net, fused_adam(LR), opt_level="O2",
                               pipeline=True)
    if start_scale is not None:
        aopt.scaler = dataclasses.replace(aopt.scaler,
                                          loss_scale=start_scale)
    t, lab = torch.from_numpy(toks).long(), torch.from_numpy(labels).long()
    losses, infos, held = [], [], []
    for _ in range(steps):
        (group,) = aopt.groups
        before = [x.clone() for x in (group.master, group.data,
                                      *aopt.state.m, *aopt.state.v)]
        count = aopt.state.count
        aopt.zero_grad()
        loss = gpt_loss(net(t), lab)
        aopt.scale_loss(loss).backward()
        info = aopt.apply_gradients()
        losses.append(float(loss.detach()))
        infos.append((info.grads_finite, info.loss_scale, info.steps_skipped,
                      info.grad_norm))
        if not info.grads_finite:
            after = (group.master, group.data, *aopt.state.m,
                     *aopt.state.v)
            held.append(all(torch.equal(a, b) for a, b in zip(before, after))
                        and aopt.state.count == count)
    return dict(net=net, losses=losses, infos=infos, held=held,
                masters=aopt.masters())


@pytest.fixture(scope="module")
def runs():
    """The JAX runs, shared by the tests (the Pallas kernels in interpret
    mode are the slow part)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_PIPELINE_PALLAS", "1")
        return {"f32": _jax_run(jnp.float32, STEPS),
                "f16": _jax_run(jnp.float16, STEPS),
                "overflow": _jax_run(jnp.float16, OVERFLOW_STEPS,
                                     HUGE_SCALE)}


def _sequence(infos):
    return [(f, s, k) for f, s, k, _ in infos]


def test_o2_fp32_compute_step_matches_jax(runs):
    j = runs["f32"]
    p = _port_run(torch.float32, j["params_np"], STEPS)
    # O2 casts every parameter, LayerNorm's too, to fp16
    assert {q.dtype for q in p["net"].parameters()} == {torch.float16}
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=0,
                               atol=F32_LOSS_TOL)
    assert p["losses"][-1] < p["losses"][0]
    assert _sequence(p["infos"]) == _sequence(j["infos"]) == \
        [(True, 2.0 ** 16, 0)] * STEPS
    np.testing.assert_allclose([i[3] for i in p["infos"]],
                               [i[3] for i in j["infos"]], rtol=GNORM_RTOL)
    tm, jm = p["masters"], j["masters"]
    assert set(tm) == set(jm)
    diff = torch.cat([(tm[k] - jm[k]).abs().flatten() for k in jm])
    assert float((diff <= MASTER_TOL).float().mean()) >= MASTER_SHARE
    assert float(diff.max()) <= LR


def test_o2_fp16_compute_step_matches_jax(runs):
    j = runs["f16"]
    p = _port_run(torch.float16, j["params_np"], STEPS)
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=0,
                               atol=FP16_LOSS_TOL)
    assert p["losses"][-1] < p["losses"][0]
    assert _sequence(p["infos"]) == _sequence(j["infos"])
    assert all(i[0] for i in p["infos"])


def test_o2_fp16_overflow_skips_match_jax(runs):
    j = runs["overflow"]
    p = _port_run(torch.float16, j["params_np"], OVERFLOW_STEPS, HUGE_SCALE)
    want = [(False, 2.0 ** e, k + 1) for k, e in
            enumerate(range(24, 18, -1))] + [(True, 2.0 ** 19, 6)] * 4
    assert _sequence(j["infos"]) == want
    assert _sequence(p["infos"]) == want
    # every skipped step held masters, moments, params and the count
    assert p["held"] == [True] * 6
    # a skipped step's grad norm is NaN or inf as JAX's is: NaN while the
    # backward made NaNs, +inf at 2^20
    assert [math.isnan(i[3]) for i in p["infos"][:6]] == \
        [math.isnan(i[3]) for i in j["infos"][:6]] == [True] * 5 + [False]
    assert p["infos"][5][3] == j["infos"][5][3] == math.inf
    # the applied steps then match the JAX losses
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=0,
                               atol=FP16_LOSS_TOL)


def test_dynamic_scaler_matches_jax_update():
    # a seeded run of finite and overflow steps with growth_interval 3:
    # it grows past max (clipped at 2^24) and backs off below min
    # (clipped at 1)
    rng = np.random.RandomState(5)
    flags = [True] * 40 + [False] * 30 + \
        [bool(x) for x in rng.rand(60) > 0.3]
    js = jax_scaler.init("dynamic")._replace(
        loss_scale=jnp.float32(2.0 ** 20), growth_interval=3)
    ts = dataclasses.replace(scaler.init("dynamic"), loss_scale=2.0 ** 20,
                             growth_interval=3)
    scales = []
    for f in flags:
        js = jax_scaler.update(js, jnp.bool_(f))
        ts = scaler.update(ts, f)
        assert (ts.loss_scale, ts.growth_tracker, ts.steps_skipped) == \
            (float(js.loss_scale), int(js.growth_tracker),
             int(js.steps_skipped))
        scales.append(ts.loss_scale)
    assert max(scales) == 2.0 ** 24 and min(scales) == 1.0
    # the state dict round-trips, with the JAX keys
    assert scaler.load_state_dict(scaler.state_dict(ts)) == ts
    assert set(scaler.state_dict(ts)) == set(jax_scaler.state_dict(js))
    # a static scale holds and only counts skips
    st = scaler.update(scaler.init(128.0), False)
    assert (st.loss_scale, st.steps_skipped, st.dynamic) == (128.0, 1, False)


def test_check_finite_false_is_refused_for_a_dynamic_scale():
    net = GPTModel(64, 128, 1, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="check_finite=False"):
        amp.initialize(net, fused_adam(1e-3), opt_level="O2",
                       check_finite=False)
    # forced on under a static scale: the step is checked and reports
    # its norm
    net = GPTModel(64, 128, 1, 2, 16, device="cpu").reset_parameters(
        torch.Generator().manual_seed(0))
    net, aopt = amp.initialize(net, fused_adam(1e-3), opt_level="O5",
                               check_finite=True, pipeline=True)
    toks = torch.randint(0, 64, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    aopt.zero_grad()
    aopt.scale_loss(gpt_loss(net(toks), toks.roll(-1, -1))).backward()
    info = aopt.apply_gradients()
    assert info.grads_checked and info.grads_finite
    assert info.grad_norm is not None and info.grad_norm > 0


def test_train_cli_o2_on_the_cpu():
    import subprocess
    import sys

    cmd = [sys.executable, "-m", "apex_tpu_torch.testing.standalone_gpt",
           "--train", "--policy", "O2", "--model", "tiny"]
    out = subprocess.run(cmd + ["--device", "cpu", "--steps", "4"],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    line = [x for x in out.splitlines() if x.startswith("TRAIN_DONE")][0]
    fields = dict(kv.split("=") for kv in line.split()[1:])
    assert fields["policy"] == "O2" and fields["device"] == "cpu"
    assert fields["skipped"] == "0" and float(fields["scale"]) == 2.0 ** 16
    assert float(fields["loss_last"]) < float(fields["loss_first"])
    # without --device cpu it wants the card, and raises where there is
    # none
    if torch.cuda.is_available():
        return
    bad = subprocess.run(cmd + ["--steps", "1"], capture_output=True,
                         text=True, timeout=300)
    assert bad.returncode != 0 and "device='cpu'" in bad.stderr
