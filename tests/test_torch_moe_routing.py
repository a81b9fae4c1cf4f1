"""Port parity for the fused MoE routing front (row 18): the port's
``moe_route_dispatch`` (its plain version here, on CPU tensors) against
the JAX ``moe_route_dispatch`` running its Pallas kernel in CPU interpret
mode (``backend="pallas"``) and against the JAX twin, on the same numpy
inputs.  The ``random`` second policy gets JAX's own draw
(``jax.random.uniform(rng, (T,))``) through the port's ``_fused``, which
takes ``u`` explicitly.

The cases are JAX's own grid (``tests/test_moe_routing.py``): capacity 1,
more experts than tokens, every token on one expert, the top-2
second-drop accounting, ``random`` with a shared ``u``, bf16 tokens, T
and E not multiples of 128.

Tolerances, JAX's own (``tests/test_moe_routing.py:34-45``): expert_index,
slot and keep exact; gate and buf within 1e-6 absolute; the aux loss
within 1e-5 relative.  Gradients of JAX's test loss in x and logits
within 1e-6 of ``jax.grad``'s, relative to the largest gradient element:
the elements reach ~12, where one fp32 ulp is ~1e-6, and the two
frameworks reduce the combine's and the softmax backward's sums in other
orders (measured 2.9e-6 absolute, 2.4e-7 relative; JAX's own test holds
1e-6 absolute between two routes through the same XLA program).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.moe_routing import moe_combine as jax_combine
from apex_tpu.ops.moe_routing import moe_route_dispatch as jax_route
from apex_tpu.ops.moe_routing import \
    moe_route_dispatch_reference as jax_twin
from apex_tpu_torch.ops import (RouteDispatch, moe_combine,
                                moe_route_dispatch,
                                moe_route_dispatch_reference)
from apex_tpu_torch.ops.moe_routing import _fused

GATE_TOL = 1e-6
BUF_TOL = 1e-6
AUX_RTOL = 1e-5
GRAD_RTOL = 1e-6


def _case(seed, t, h, e):
    rng = np.random.RandomState(seed)
    return (rng.randn(t, h).astype(np.float32),
            rng.randn(t, e).astype(np.float32))


def _u(t, seed=0):
    """JAX's draw for the random policy, as numpy."""
    key = jax.random.PRNGKey(seed)
    return key, np.asarray(jax.random.uniform(key, (t,)))


def _both(x, logits, *, dtype=np.float32, seed=0, **kw):
    """(JAX Pallas, JAX twin, port) on the same inputs."""
    t = x.shape[0]
    key, u = _u(t, seed)
    random = kw.get("second_policy") == "random"
    xj = jnp.asarray(x).astype(dtype)
    # jitted: interpret mode compiles ~3x faster as one program
    a = jax.jit(lambda xx, ll: jax_route(
        xx, ll, backend="pallas", rng=key if random else None, **kw))(
        xj, jnp.asarray(logits))
    b = jax_twin(xj, jnp.asarray(logits), jnp.asarray(u) if random
                 else None, **kw)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32)).copy())
    if dtype == jnp.bfloat16:
        xt = xt.bfloat16()
    c = _fused(xt, torch.from_numpy(logits.copy()),
               torch.from_numpy(u.copy()) if random else None, **kw)
    return a, b, c


def _hold(port: RouteDispatch, jax_rd):
    for name in ("expert_index", "slot", "keep"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(jax_rd, name)),
                                      err_msg=name)
    np.testing.assert_allclose(port.gate.numpy(), np.asarray(jax_rd.gate),
                               atol=GATE_TOL)
    np.testing.assert_allclose(port.buf.float().numpy(),
                               np.asarray(jax_rd.buf.astype(jnp.float32)),
                               atol=BUF_TOL)
    np.testing.assert_allclose(float(port.load_balancing_loss),
                               float(jax_rd.load_balancing_loss),
                               rtol=AUX_RTOL)


def _hold_both(a, b, c):
    _hold(c, a)
    _hold(c, b)


@pytest.mark.parametrize("top_k", [1, 2])
def test_capacity_one(top_k):
    x, logits = _case(0, 32, 16, 4)
    a, b, c = _both(x, logits, capacity=1, top_k=top_k)
    _hold_both(a, b, c)
    idx = c.expert_index.reshape(-1)
    for ex in range(4):
        assert int(c.keep[idx == ex].sum()) <= 1
    assert bool((c.slot == 0).all())


@pytest.mark.parametrize("top_k", [1, 2])
def test_more_experts_than_tokens(top_k):
    x, logits = _case(1, 3, 8, 16)
    a, b, c = _both(x, logits, capacity=2, top_k=top_k)
    _hold_both(a, b, c)
    hit = set(c.expert_index.reshape(-1)[c.keep].tolist())
    cold = [ex for ex in range(16) if ex not in hit]
    assert bool((c.buf[cold] == 0).all())


def test_all_tokens_one_expert_overflow():
    t, h, e, cap = 24, 8, 4, 5
    x, _ = _case(2, t, h, e)
    logits = np.zeros((t, e), np.float32)
    logits[:, 2] = 10.0
    a, b, c = _both(x, logits, capacity=cap)
    _hold_both(a, b, c)
    assert bool((c.expert_index == 2).all())
    assert c.keep[:cap].all() and not c.keep[cap:].any()
    np.testing.assert_array_equal(c.slot[:cap].numpy(), np.arange(cap))


def test_top2_second_choice_drop_accounting():
    x, logits = _case(3, 32, 16, 4)
    a, b, c = _both(x, logits, capacity=8, top_k=2, second_policy="random",
                    seed=3)
    _hold_both(a, b, c)
    dropped = (c.gate[1] == 0.0).numpy()
    assert dropped.any() and not dropped.all()
    keep = c.keep.reshape(2, -1).numpy()
    assert not keep[1][dropped].any()
    idx, slot, kf = (c.expert_index.reshape(-1).numpy(), c.slot.numpy(),
                     c.keep.numpy())
    for ex in range(4):
        slots = np.sort(slot[(idx == ex) & kf])
        np.testing.assert_array_equal(slots, np.arange(len(slots)))


@pytest.mark.parametrize("t,h,e,cap,top_k,pol", [
    (64, 32, 8, 4, 1, "all"),
    (64, 32, 8, 12, 2, "all"),
    (130, 16, 5, 33, 2, "random"),   # T, E, capacity off the TPU's grains
    (8, 8, 3, 1, 2, "random"),
    (37, 24, 8, 7, 1, "all"),
])
def test_grid(t, h, e, cap, top_k, pol):
    x, logits = _case(t + e, t, h, e)
    a, b, c = _both(x, logits, capacity=cap, top_k=top_k,
                    second_policy=pol, seed=t)
    _hold_both(a, b, c)


def test_bf16_tokens():
    x, logits = _case(4, 16, 8, 4)
    a, b, c = _both(x, logits, dtype=jnp.bfloat16, capacity=6)
    assert c.buf.dtype == torch.bfloat16
    _hold_both(a, b, c)


def test_combine_matches_jax():
    t, h, e, cap = 32, 16, 4, 10
    x, logits = _case(6, t, h, e)
    rd = moe_route_dispatch_reference(torch.from_numpy(x),
                                      torch.from_numpy(logits),
                                      capacity=cap, top_k=2)
    out = torch.tanh(rd.buf)
    got = moe_combine(out, rd.expert_index, rd.slot, rd.keep, rd.gate)
    want = jax_combine(jnp.asarray(out.numpy()),
                       jnp.asarray(rd.expert_index.numpy()),
                       jnp.asarray(rd.slot.numpy()),
                       jnp.asarray(rd.keep.numpy()),
                       jnp.asarray(rd.gate.numpy()))
    assert got.shape == (t, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("top_k,pol", [(1, "all"), (2, "random")])
def test_grad_matches_jax(top_k, pol):
    """JAX's ``test_grad_matches_reference`` loss, differentiated by
    ``jax.grad`` through the Pallas route's custom VJP and by autograd
    through the port's Function (backward: the plain version at the
    saved inputs)."""
    t, h, e, cap = 16, 8, 4, 5
    x, logits = _case(7, t, h, e)
    key, u = _u(t, 7)

    def loss_jax(xx, ll):
        rd = jax_route(xx, ll, capacity=cap, top_k=top_k, second_policy=pol,
                       rng=key, backend="pallas")
        y = jax_combine(rd.buf * 2.0, rd.expert_index, rd.slot, rd.keep,
                        rd.gate)
        return jnp.sum(y ** 2) + 0.1 * rd.load_balancing_loss

    gx_j, gl_j = jax.jit(jax.grad(loss_jax, (0, 1)))(jnp.asarray(x),
                                                      jnp.asarray(logits))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    lt = torch.from_numpy(logits.copy()).requires_grad_()
    rd = _fused(xt, lt, torch.from_numpy(u.copy()) if pol == "random"
                else None, capacity=cap, top_k=top_k, second_policy=pol)
    y = moe_combine(rd.buf * 2.0, rd.expert_index, rd.slot, rd.keep, rd.gate)
    ((y ** 2).sum() + 0.1 * rd.load_balancing_loss).backward()
    for got, want in ((xt.grad.numpy(), np.asarray(gx_j)),
                      (lt.grad.numpy(), np.asarray(gl_j))):
        np.testing.assert_allclose(got, want,
                                   atol=GRAD_RTOL * np.abs(want).max())
    assert bool((lt.grad != 0).any())          # the router trains


def test_public_entry_draws_from_the_generator():
    """``rng`` is a torch.Generator: the draw is ``torch.rand(T)`` from it,
    the same numbers ``_fused`` then consumes."""
    x, logits = _case(9, 40, 8, 4)
    xt, lt = torch.from_numpy(x), torch.from_numpy(logits)
    got = moe_route_dispatch(xt, lt, capacity=12, top_k=2,
                             second_policy="random",
                             rng=torch.Generator().manual_seed(5))
    u = torch.rand(40, generator=torch.Generator().manual_seed(5))
    want = _fused(xt, lt, u, capacity=12, top_k=2, second_policy="random")
    for name in RouteDispatch._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert bool((got.gate[1] == 0).any())


def test_validation_errors():
    x = torch.zeros(4, 8)
    logits = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="capacity"):
        moe_route_dispatch(x, logits, capacity=0)
    with pytest.raises(ValueError, match="top_k"):
        moe_route_dispatch(x, logits, capacity=1, top_k=3)
    with pytest.raises(ValueError, match="second_policy"):
        moe_route_dispatch(x, logits, capacity=1, second_policy="half")
    with pytest.raises(ValueError, match="requires rng"):
        moe_route_dispatch(x, logits, capacity=1, top_k=2,
                           second_policy="random")
    with pytest.raises(ValueError, match="mismatch"):
        moe_route_dispatch(x, torch.zeros(5, 2), capacity=1)
    # neither CPU nor CUDA: no plain version, no kernel
    with pytest.raises(ValueError, match="cuda or cpu"):
        moe_route_dispatch(x.to("meta"), logits.to("meta"), capacity=1)
