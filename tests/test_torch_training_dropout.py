"""Port parity for training with dropout: the tiny GPT and BERT train
steps of ``apex_tpu_torch`` against ``apex_tpu``'s with attention, hidden
and embedding dropout on, from the same weights and the same random
draws.

The random draws are made equal, not reproduced: JAX's threefry keys and
the port's generators give other bits.  Both sides take prescribed draws
from numpy through test-local patches, nothing in either package
changed:

* attention dropout on the flash route: ``dropout_seed_from_key`` in
  ``apex_tpu.transformer.layers`` and ``dropout_seed`` in
  ``apex_tpu_torch.transformer.layers`` return the same seeds in call
  order (a layer's attention, layer by layer).  The kernels' keep masks
  are then the counter hash of the same seed on both sides.  The JAX
  step is jitted once: its patched function hands out elements of a
  traced seed array, so each step gets fresh seeds, as the port's does.
* Bernoulli masks (hidden and embedding dropout, attention dropout on
  the materialized route): ``jax.random.bernoulli`` and the port's
  ``dropout_mask`` return the same masks in JAX's ``make_rng`` order —
  the embedding, then per layer the attention's probabilities, the
  hidden dropout after attention and after the MLP — from traced
  arguments on the JAX side.

Cases and tolerances (each measured gap in brackets; one seed off by one
on the port's side moves the GPT O5 losses by 1.4e-2):
* GPT O5, attention dropout 0.1 and hidden 0 (``bench.py``'s
  ``gpt2_345m_dropout`` recipe), fp32 compute: 4 losses within 1e-4
  (``test_torch_training.py``'s fp32 limit) [3.8e-6].
* GPT O2 on the materialized route with every rate 0.1 (embedding
  dropout at the hidden rate), 4 steps: fp32 compute within 1e-4 and
  fp16 compute within 2e-4 (``test_torch_training_o2.py``'s limits; in
  fp16 both sides divide by 1 - rate rounded to fp16) [4.8e-7, 3.9e-5].
* BERT O5 on a padded batch with attention dropout 0.1 (the kv_mask +
  dropout lane), fp32 compute: 4 losses within 1e-5
  (``test_torch_bert.py``'s O5 fp32 limit) [1.4e-6].
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
from apex_tpu.testing.standalone_gpt import GPTModel as JaxGPT
from apex_tpu.testing.standalone_gpt import gpt_loss as jax_gpt_loss
from apex_tpu.testing.standalone_gpt import unbox
from apex_tpu.transformer import layers as jax_layers
from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import fused_adam, fused_lamb
from apex_tpu_torch.testing import standalone_gpt
from apex_tpu_torch.testing.standalone_bert import (BertModel, bert_loss,
                                                    bert_params_from_numpy)
from apex_tpu_torch.testing.standalone_gpt import (GPTModel, gpt_loss,
                                                   gpt_params_from_numpy)
from apex_tpu_torch.transformer import DropoutRNG
from apex_tpu_torch.transformer import layers as port_layers

VOCAB, HIDDEN, HEADS, LAYERS, SEQ, BATCH = 256, 128, 2, 2, 64, 2
BERT_BATCH, BERT_LENS = 4, (64, 40, 17, 53)
LR, STEPS, RATE = 1e-3, 4, 0.1
LOSS_TOL = {"gpt-O5-f32": 1e-4, "gpt-O2-f32": 1e-4, "gpt-O2-f16": 2e-4,
            "bert-O5-f32": 1e-5}
JAXD = {"f32": jnp.float32, "f16": jnp.float16}
TORCHD = {"f32": torch.float32, "f16": torch.float16}


class _Draws:
    """The prescribed draws of every step, handed out in call order: to
    the jitted JAX step from its traced arguments, to the port from
    numpy."""

    def __init__(self, seeds, masks):
        self.seeds, self.masks = seeds, masks     # per step
        self.i = self.j = 0
        self.cur = None

    # JAX: ``step`` sets ``cur`` to its traced (seeds, masks) first
    def jax_seed(self, key):
        self.i += 1
        return self.cur[0][self.i - 1]

    def jax_bernoulli(self, key, p, shape):
        self.j += 1
        m = self.cur[1][self.j - 1]
        assert tuple(m.shape) == tuple(shape) and abs(float(p) - (1 - RATE)) \
            < 1e-12
        return m

    # the port: step by step, in order
    def port_seed(self, generator):
        step, k = divmod(self.i, len(self.seeds[0]))
        self.i += 1
        return int(self.seeds[step][k])

    def port_mask(self, shape, rate, generator):
        step, k = divmod(self.j, len(self.masks[0]))
        self.j += 1
        m = self.masks[step][k]
        assert tuple(m.shape) == tuple(shape) and rate == RATE
        return torch.from_numpy(m)


def _draws(n_seeds, mask_shapes, seed=0):
    rng = np.random.RandomState(seed)
    seeds = [rng.randint(0, 2 ** 31 - 1, n_seeds).astype(np.int32)
             for _ in range(STEPS)]
    masks = [[rng.rand(*s) >= RATE for s in mask_shapes]
             for _ in range(STEPS)]
    return _Draws(seeds, masks)


def _jax_steps(model, params, aopt, state, loss_fn, draws, monkeypatch):
    """STEPS jitted JAX steps, each fed its draws."""
    monkeypatch.setattr(jax_layers, "dropout_seed_from_key", draws.jax_seed)
    monkeypatch.setattr(jax.random, "bernoulli", draws.jax_bernoulli)
    key = jax.random.PRNGKey(0)

    def step(params, state, seeds, masks):
        draws.cur, draws.i, draws.j = (seeds, masks), 0, 0

        def lf(p):
            loss = loss_fn(lambda *a, **kw: model.apply(
                {"params": p}, *a, deterministic=False,
                rngs={"dropout": key}, **kw))
            return aopt.scale_loss(loss, state), loss

        grads, loss = jax.grad(lf, has_aux=True)(params)
        params, state, _ = aopt.apply_gradients(grads, state, params)
        return params, state, loss

    step = jax.jit(step)
    losses = []
    with jax.default_matmul_precision("highest"):
        for n in range(STEPS):
            params, state, loss = step(
                params, state, jnp.asarray(draws.seeds[n]),
                tuple(jnp.asarray(m) for m in draws.masks[n]))
            losses.append(float(loss))
    monkeypatch.undo()
    return losses


def _port_steps(net, aopt, loss_fn, draws, monkeypatch):
    monkeypatch.setattr(port_layers, "dropout_seed", draws.port_seed)
    monkeypatch.setattr(port_layers, "dropout_mask", draws.port_mask)
    draws.i = draws.j = 0
    rng = DropoutRNG(0)
    losses = []
    for _ in range(STEPS):
        aopt.zero_grad()
        loss = loss_fn(net, rng)
        aopt.scale_loss(loss).backward()
        aopt.apply_gradients()
        losses.append(float(loss.detach()))
    monkeypatch.undo()
    # every draw was taken, once
    assert draws.i == sum(len(s) for s in draws.seeds)
    assert draws.j == sum(len(m) for m in draws.masks)
    return losses


def _gpt_batch():
    toks = np.random.RandomState(0).randint(0, VOCAB, (BATCH, SEQ))
    return toks.astype(np.int32), np.roll(toks, -1, -1).astype(np.int32)


@pytest.fixture(scope="module")
def pallas_pipeline():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_PIPELINE_PALLAS", "1")
        yield


def _gpt_run(policy, dt, attention, hidden, monkeypatch):
    use_flash = policy == "O5"
    toks, labels = _gpt_batch()
    model = JaxGPT(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS,
                   num_attention_heads=HEADS, max_sequence_length=SEQ,
                   attention_dropout=attention, hidden_dropout=hidden,
                   use_flash=use_flash, dtype=JAXD[dt])
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(toks))
    params_np = jax.tree.map(np.asarray, unbox(variables["params"]))
    params, aopt, state = jax_amp.initialize(
        variables["params"], jax_fused_adam(LR, use_pallas=True),
        opt_level=policy, pipeline=True)
    # the draws of a step, in JAX's make_rng order
    n_seeds = LAYERS if use_flash and attention else 0
    shapes = []
    if hidden:
        shapes.append((BATCH, SEQ, HIDDEN))
    for _ in range(LAYERS):
        if attention and not use_flash:
            shapes.append((BATCH, HEADS, SEQ, SEQ))
        if hidden:
            shapes += [(BATCH, SEQ, HIDDEN)] * 2
    draws = _draws(n_seeds, shapes)
    t, lab = jnp.asarray(toks), jnp.asarray(labels)
    jl = _jax_steps(model, params, aopt, state,
                    lambda f: jax_gpt_loss(f(t), lab), draws, monkeypatch)

    net = GPTModel(VOCAB, HIDDEN, LAYERS, HEADS, SEQ,
                   attention_dropout=attention, hidden_dropout=hidden,
                   use_flash=use_flash, dtype=TORCHD[dt], device="cpu")
    net.load_state_dict(gpt_params_from_numpy(params_np))
    net, ao = amp.initialize(net, fused_adam(LR), opt_level=policy,
                             pipeline=True)
    tt, tlab = torch.from_numpy(toks).long(), torch.from_numpy(labels).long()
    tl = _port_steps(net, ao, lambda m, rng: gpt_loss(
        m(tt, deterministic=False, rng=rng), tlab), draws, monkeypatch)
    return jl, tl


def test_gpt_o5_attention_dropout_matches_jax(pallas_pipeline, monkeypatch):
    jl, tl = _gpt_run("O5", "f32", RATE, 0.0, monkeypatch)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_TOL["gpt-O5-f32"])
    assert tl[-1] < tl[0]
    # dropout took effect: the dropout-free run's losses differ
    jl0, _ = _gpt_run("O5", "f32", 0.0, 0.0, monkeypatch)
    assert abs(jl0[0] - jl[0]) > 1e-3


@pytest.mark.parametrize("dt", ["f32", "f16"])
def test_gpt_o2_hidden_embedding_attention_dropout_matches_jax(
        pallas_pipeline, monkeypatch, dt):
    jl, tl = _gpt_run("O2", dt, RATE, RATE, monkeypatch)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_TOL[f"gpt-O2-{dt}"])
    assert tl[-1] < tl[0]


def test_bert_o5_kv_mask_dropout_lane_matches_jax(pallas_pipeline,
                                                  monkeypatch):
    rng = np.random.RandomState(0)
    toks = rng.randint(0, VOCAB, (BERT_BATCH, SEQ)).astype(np.int32)
    mask = (np.arange(SEQ)[None] < np.array(BERT_LENS)[:, None]) \
        .astype(np.int32)
    nsp = rng.randint(0, 2, BERT_BATCH).astype(np.int32)
    labels = np.roll(toks, -1, -1)
    model = JaxBert(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS,
                    num_attention_heads=HEADS, max_sequence_length=SEQ,
                    attention_dropout=RATE, hidden_dropout=0.0,
                    use_flash=True, dtype=jnp.float32)
    jt, jm, jlab, jn = (jnp.asarray(a) for a in (toks, mask, labels, nsp))
    variables = model.init(jax.random.PRNGKey(0), jt, jm)
    params_np = jax.tree.map(np.asarray, unbox(variables["params"]))
    params, aopt, state = jax_amp.initialize(
        variables["params"], jax_fused_lamb(LR, use_pallas=True),
        opt_level="O5", pipeline=True)

    def jax_loss(f):
        lm, bl = f(jt, jm, lm_labels=jlab)
        return jnp.mean(lm) + jnp.mean(jax_xentropy(bl, jn,
                                                    half_to_float=True))

    draws = _draws(LAYERS, [])
    jl = _jax_steps(model, params, aopt, state, jax_loss, draws, monkeypatch)

    net = BertModel(VOCAB, HIDDEN, LAYERS, HEADS, SEQ, num_tokentypes=0,
                    attention_dropout=RATE, hidden_dropout=0.0,
                    use_flash=True, device="cpu")
    net.load_state_dict(bert_params_from_numpy(params_np))
    net, ao = amp.initialize(net, fused_lamb(LR), opt_level="O5",
                             pipeline=True)
    t = [torch.from_numpy(a).long() for a in (toks, mask, labels, nsp)]
    tl = _port_steps(net, ao, lambda m, rng: bert_loss(m, *t, rng=rng),
                     draws, monkeypatch)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_TOL["bert-O5-f32"])
    assert tl[-1] < tl[0]


def test_train_recipe_draws_fresh_seeds_from_its_own_rng():
    """``make_train_setup`` with a rate owns a DropoutRNG (none at rate
    0); each step draws one host seed a layer; the same seed repeats the
    run, another changes it."""
    kw = dict(model="tiny", device="cpu", attention_dropout=RATE)
    assert standalone_gpt.make_train_setup(model="tiny",
                                           device="cpu").rng is None
    a = standalone_gpt.train_smoke(2, **kw)
    b = standalone_gpt.train_smoke(2, **kw)
    c = standalone_gpt.train_smoke(2, seed=1, **kw)
    assert a.losses == b.losses and a.losses != c.losses
    setup = a.setup
    state = setup.rng.seeds.get_state()
    standalone_gpt.train_step(setup)
    drawn = torch.Generator()
    drawn.set_state(state)
    layers = standalone_gpt.MODELS["tiny"]["num_layers"]
    for _ in range(layers):
        torch.randint(0, 2 ** 31 - 1, (), generator=drawn)
    assert torch.equal(drawn.get_state(), setup.rng.seeds.get_state())
