"""Activation checkpointing in the port: ``apex_tpu_torch.transformer.
tensor_parallel.random.checkpoint`` and ``ParallelTransformer(
checkpoint_activations=True)``, and the MLP's ``ffn_hidden_size`` and
``activation``.

* Bitwise against the uncheckpointed port, at attention and hidden
  dropout 0.1, for each of the four policies (``full``, ``dots``,
  ``dots_with_no_batch_dims``, ``all_but_ffn_wide``) on the flash route
  (the (b, s) mask on the E kernels' kv_mask lane, the seeds from the
  DropoutRNG's CPU generator) and on the materialized route (the
  extended mask through the padding softmax, the masks from its other
  generator): two forward and backward passes (a 2-layer, hidden 128,
  2-head transformer at seq 64, batch 2) give the same losses, the same
  gradients of every parameter and of the input, and leave both
  generators in the same states, bit for bit.  A wrapper that did not
  restore the generators would change the second pass's gradients and
  the generators' states (the recompute draws anew).
* At dropout 0, fp32, against JAX's checkpointed ``ParallelTransformer``
  (``nn.checkpoint`` under the same policy, its Pallas kernels in CPU
  interpret mode) from the same weights, at ``tests/
  test_torch_training.py``'s tolerances: the loss within 1e-4 and 99.9 %
  of every gradient's elements within 1e-5.
* An unknown policy raises ``ValueError`` in both packages.
* ``ffn_hidden_size`` other than 4h and a non-default activation:
  ``ParallelMLP`` and a ``ParallelTransformer`` against JAX's, forward
  and gradients at the same tolerances.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.transformer.enums import AttnMaskType as JaxMaskType
from apex_tpu.transformer.layers import ParallelMLP as JaxMLP
from apex_tpu.transformer.layers import \
    ParallelTransformer as JaxTransformer
from apex_tpu.testing.standalone_gpt import unbox
from apex_tpu_torch.testing.standalone_gpt import gpt_params_from_numpy
from apex_tpu_torch.transformer import (DropoutRNG, ParallelMLP,
                                        ParallelTransformer)
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.tensor_parallel import (CHECKPOINT_POLICIES,
                                                        checkpoint)

HIDDEN, HEADS, LAYERS, SEQ, BATCH = 128, 2, 2, 64, 2
LENS = (64, 37)
POLICIES = sorted(CHECKPOINT_POLICIES)
LOSS_TOL, GRAD_TOL, GRAD_SHARE = 1e-4, 1e-5, 0.999


def _mask():
    return (torch.arange(SEQ)[None] < torch.tensor(LENS)[:, None]).float()


def _inputs(seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(BATCH, SEQ, HIDDEN, generator=g)
    w = torch.randn(BATCH, SEQ, HIDDEN, generator=g)
    return x, w


def _port(ckpt, policy, flash, dropout, **kw):
    net = ParallelTransformer(
        LAYERS, HIDDEN, HEADS, attn_mask_type=AttnMaskType.padding,
        attention_dropout=dropout, hidden_dropout=dropout, use_flash=flash,
        checkpoint_activations=ckpt, checkpoint_policy=policy,
        device="cpu", **kw)
    g = torch.Generator().manual_seed(0)
    for m in net.modules():
        if m is not net and hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    return net


def _passes(net, flash, rng, n=2):
    """``n`` forward and backward passes; each pass's loss, gradients
    (parameters and input) and the two generators' states after it."""
    x, w = _inputs()
    mask = _mask()
    out = []
    for _ in range(n):
        xi = x.clone().requires_grad_(True)
        net.zero_grad()
        if flash:
            y = net(xi, None, mask, False, rng)
        else:
            ext = (mask[:, None, :] * mask[:, :, None])[:, None] < 0.5
            y = net(xi, ext, None, False, rng)
        loss = (y.float() * w).sum() / y.numel()
        loss.backward()
        out.append((loss.detach(), [p.grad.clone() for p in
                                    net.parameters()] + [xi.grad],
                    rng.seeds.get_state(), rng.masks.get_state()))
    return out


@pytest.mark.parametrize("flash", [True, False], ids=["flash",
                                                      "materialized"])
@pytest.mark.parametrize("policy", POLICIES)
def test_checkpointed_dropout_is_bitwise(policy, flash):
    want = _passes(_port(False, "full", flash, 0.1), flash,
                   DropoutRNG(3, "cpu"))
    got = _passes(_port(True, policy, flash, 0.1), flash,
                  DropoutRNG(3, "cpu"))
    for (l0, g0, s0, m0), (l1, g1, s1, m1) in zip(want, got):
        assert torch.equal(l0, l1)
        assert len(g0) == len(g1)
        assert all(torch.equal(a, b) for a, b in zip(g0, g1))
        assert torch.equal(s0, s1) and torch.equal(m0, m1)
    # the two passes drew different dropout: the replay is not trivial
    assert not torch.equal(want[0][0], want[1][0])


def test_checkpoint_call_forms():
    # checkpoint(fn) returns the checkpointed function; a generator
    # among the arguments is replayed
    lin = torch.nn.Linear(8, 8)
    gen = torch.Generator().manual_seed(5)

    def fn(x, g):
        keep = torch.rand(x.shape, generator=g) >= 0.5
        return torch.where(keep, lin(x), 0.0)

    x = torch.randn(4, 8, requires_grad=True)
    want_state = None
    outs = []
    for wrap in (lambda: fn(x, gen), lambda: checkpoint(fn, x, gen),
                 lambda: checkpoint(fn, policy="dots")(x, gen)):
        gen.manual_seed(5)
        lin.zero_grad()
        y = wrap()
        y.sum().backward()
        outs.append((y.detach(), lin.weight.grad.clone()))
        state = gen.get_state()
        want_state = state if want_state is None else want_state
        assert torch.equal(state, want_state)
    assert all(torch.equal(a[0], outs[0][0]) and torch.equal(a[1],
                                                             outs[0][1])
               for a in outs)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="checkpoint_policy"):
        checkpoint(lambda x: x, torch.ones(2), policy="everything")
    with pytest.raises(ValueError, match="checkpoint_policy"):
        ParallelTransformer(1, 32, 2, checkpoint_activations=True,
                            checkpoint_policy="everything", device="cpu")
    model = JaxTransformer(num_layers=1, hidden_size=32,
                           num_attention_heads=2,
                           checkpoint_activations=True,
                           checkpoint_policy="everything")
    with pytest.raises(ValueError, match="checkpoint_policy"):
        model.init(jax.random.PRNGKey(0), jnp.ones((1, 8, 32)))


# --- against JAX ------------------------------------------------------------

def _jax_grads(model, x, w, extra):
    """JAX's loss and gradients (params, input) at HIGHEST precision."""
    variables = model.init(jax.random.PRNGKey(0), x, *extra)
    params = unbox(variables["params"])

    def loss_fn(p, xi):
        y = model.apply({"params": p}, xi, *extra)
        return jnp.sum(y.astype(jnp.float32) * w) / y.size

    with jax.default_matmul_precision("highest"):
        loss, (gp, gx) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            params, x)
    return (jax.tree.map(np.asarray, params), float(loss),
            gpt_params_from_numpy(jax.tree.map(np.asarray, gp)),
            np.asarray(gx))


def _hold_grads(net, xi, jgrads, jgx):
    got = dict(net.named_parameters())
    assert set(got) == set(jgrads)
    pairs = [(got[k].grad, jgrads[k]) for k in jgrads] + [(xi.grad, jgx)]
    for t, w in pairs:
        diff = np.abs(t.numpy() - np.asarray(w))
        assert (diff <= GRAD_TOL).mean() >= GRAD_SHARE, diff.max()


def _torch_loss(net, x, w, *extra):
    xi = torch.from_numpy(np.asarray(x)).requires_grad_(True)
    y = net(xi, *extra)
    loss = (y.float() * torch.from_numpy(np.asarray(w))).sum() / y.numel()
    loss.backward()
    return float(loss), xi


@pytest.mark.parametrize("policy", POLICIES)
def test_checkpointed_transformer_matches_jax(policy):
    x, w = (jnp.asarray(t.numpy()) for t in _inputs())
    mask = jnp.asarray(_mask().numpy())
    model = JaxTransformer(num_layers=LAYERS, hidden_size=HIDDEN,
                           num_attention_heads=HEADS,
                           attn_mask_type=JaxMaskType.padding,
                           attention_dropout=0.0, hidden_dropout=0.0,
                           checkpoint_activations=True,
                           checkpoint_policy=policy)
    params, jloss, jgrads, jgx = _jax_grads(
        model, x, w, (None, True, mask))
    net = ParallelTransformer(LAYERS, HIDDEN, HEADS,
                              attn_mask_type=AttnMaskType.padding,
                              attention_dropout=0.0, hidden_dropout=0.0,
                              checkpoint_activations=True,
                              checkpoint_policy=policy, device="cpu")
    net.load_state_dict(gpt_params_from_numpy(params))
    loss, xi = _torch_loss(net, x, w, None, torch.from_numpy(
        np.asarray(mask)), True)
    assert abs(loss - jloss) <= LOSS_TOL
    _hold_grads(net, xi, jgrads, jgx)


@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_mlp_width_and_activation_match_jax(activation):
    hidden, ffn = 64, 96
    jact = jax.nn.gelu if activation == "gelu" else jax.nn.relu
    tact = {"gelu": None, "relu": torch.relu}[activation]
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(2, 5, hidden).astype(np.float32))
    w = jnp.asarray(rng.randn(2, 5, hidden).astype(np.float32))
    model = JaxMLP(hidden, ffn_hidden_size=ffn, activation=jact)
    params, jloss, jgrads, jgx = _jax_grads(model, x, w, ())
    kw = {} if tact is None else dict(activation=tact)
    net = ParallelMLP(hidden, ffn, device="cpu", **kw)
    assert net.dense_h_to_4h.kernel.shape == (hidden, ffn)
    net.load_state_dict(gpt_params_from_numpy(params))
    loss, xi = _torch_loss(net, x, w)
    assert abs(loss - jloss) <= LOSS_TOL
    _hold_grads(net, xi, jgrads, jgx)


def test_transformer_ffn_width_matches_jax():
    x, w = (jnp.asarray(t.numpy()) for t in _inputs())
    model = JaxTransformer(num_layers=1, hidden_size=HIDDEN,
                           num_attention_heads=HEADS, ffn_hidden_size=200,
                           attention_dropout=0.0, hidden_dropout=0.0)
    params, jloss, jgrads, jgx = _jax_grads(model, x, w, ())
    net = ParallelTransformer(1, HIDDEN, HEADS, ffn_hidden_size=200,
                              attention_dropout=0.0, hidden_dropout=0.0,
                              device="cpu")
    assert net.layer_0.mlp.dense_4h_to_h.kernel.shape == (200, HIDDEN)
    net.load_state_dict(gpt_params_from_numpy(params))
    loss, xi = _torch_loss(net, x, w)
    assert abs(loss - jloss) <= LOSS_TOL
    _hold_grads(net, xi, jgrads, jgx)
