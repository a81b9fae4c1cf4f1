"""Port parity for the one-device MoE (``apex_tpu_torch.transformer.
expert_parallel``) against ``apex_tpu.transformer.expert_parallel``, on the
same numpy inputs and carried parameters.

* ``top1_router``, ``top2_router`` (``all``, and ``random`` fed JAX's own
  draw) and ``_dispatch_indices``: expert indices, slots and keep flags
  exact; gates within 1e-6, the aux loss within 1e-5 relative (JAX's
  routing tolerances).
* ``ExpertParallelMLP(axis_name=None)``, fused and unfused fronts, top1
  and top2 under both second policies, at capacity factor 1.25 so tokens
  drop, with the carried router sharpened 50x so that gates are decisive
  and the random policy drops second choices: the forward within 1e-5 of
  max |y| and the gradients of ``sum(y**2) + 0.1 * aux`` in x, router, wi
  and wo within 1e-5 of each one's max |grad| (fp32 GEMMs and the softmax
  backward summed in other orders; measured <= 1.1e-6 relative).
* Any ``axis_name`` but None raises: the sharded exchange is not ported.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.transformer import expert_parallel as jep
from apex_tpu_torch.transformer import expert_parallel as tep

T, H, F, E = 32, 16, 32, 4
GATE_TOL = 1e-6
AUX_RTOL = 1e-5
MLP_RTOL = 1e-5
ROUTER_SHARPEN = 50.0


def _logits(seed, t=T, e=E):
    return np.random.RandomState(seed).randn(t, e).astype(np.float32)


def _hold_router(got, want):
    np.testing.assert_array_equal(got.expert_index.numpy(),
                                  np.asarray(want.expert_index))
    np.testing.assert_allclose(got.gate.numpy(), np.asarray(want.gate),
                               atol=GATE_TOL)
    np.testing.assert_allclose(float(got.load_balancing_loss),
                               float(want.load_balancing_loss),
                               rtol=AUX_RTOL)


def test_top1_router_matches_jax():
    logits = _logits(0)
    want = jep.top1_router(jnp.asarray(logits))
    got = tep.top1_router(torch.from_numpy(logits))
    _hold_router(got, want)
    assert got.expert_index.dtype == torch.int32


@pytest.mark.parametrize("pol", ["all", "random"])
def test_top2_router_matches_jax(pol):
    logits = _logits(1)
    key = jax.random.PRNGKey(4)
    want = jep.top2_router(jnp.asarray(logits), second_policy=pol, rng=key)
    # JAX draws u = uniform(rng, (T,)) inside; the port is handed it
    u = torch.from_numpy(np.array(jax.random.uniform(key, (T,))))
    got = tep.top2_router(torch.from_numpy(logits), pol, u=u)
    _hold_router(got, want)
    if pol == "random":
        assert bool((got.gate[1] == 0).any())


@pytest.mark.parametrize("capacity,with_valid", [(2, False), (5, True),
                                                 (40, True)])
def test_dispatch_indices_match_jax(capacity, with_valid):
    rng = np.random.RandomState(capacity)
    idx = rng.randint(0, E, 2 * T).astype(np.int32)
    valid = rng.rand(2 * T) > 0.3 if with_valid else None
    ws, wk = jep._dispatch_indices(
        jnp.asarray(idx), E, capacity,
        valid=None if valid is None else jnp.asarray(valid))
    gs, gk = tep._dispatch_indices(
        torch.from_numpy(idx), E, capacity,
        valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))


def test_dispatch_indices_capacity_example():
    """JAX's own example: expert 0 takes tokens 0, 1; tokens 2, 5 overflow."""
    slot, keep = tep._dispatch_indices(torch.tensor([0, 0, 0, 1, 2, 0]), 3,
                                       capacity=2)
    assert keep.tolist() == [True, True, False, True, True, False]
    assert slot[:2].tolist() == [0, 1] and slot[3:5].tolist() == [0, 0]


CASES = [("top1", "all", True), ("top2", "all", True),
         ("top2", "random", True), ("top1", "all", False),
         ("top2", "all", False), ("top2", "random", False)]


@pytest.mark.parametrize("router,pol,fused", CASES)
def test_expert_parallel_mlp_matches_jax(router, pol, fused):
    kw = dict(capacity_factor=1.25, axis_name=None, router=router,
              second_policy=pol, fused_dispatch=fused)
    jl = jep.ExpertParallelMLP(H, F, E, **kw)
    params = jl.init(jax.random.PRNGKey(0))
    # a sharper router than init's 0.02: decisive gates, so that the
    # random policy drops second choices here
    params["router"] = params["router"] * ROUTER_SHARPEN
    x = np.random.RandomState(2).randn(T, H).astype(np.float32)
    key = jax.random.PRNGKey(9)

    def loss_jax(p, xx):
        y, aux = jl.apply(p, xx, rng=key)
        return jnp.sum(y ** 2) + 0.1 * aux, y

    (_, yj), (gpj, gxj) = jax.jit(jax.value_and_grad(
        loss_jax, (0, 1), has_aux=True))(params, jnp.asarray(x))

    tl = tep.ExpertParallelMLP(H, F, E, **kw)
    tp = {k: torch.from_numpy(np.asarray(v).copy()).requires_grad_()
          for k, v in params.items()}
    xt = torch.from_numpy(x.copy()).requires_grad_()
    u = torch.from_numpy(np.array(jax.random.uniform(key, (T,))))
    y, aux = tl.apply(tp, xt, u=u if pol == "random" else None)
    ((y ** 2).sum() + 0.1 * aux).backward()
    if pol == "random":
        r = tep.top2_router(tep.router_logits(xt, tp["router"]), pol, u=u)
        assert bool((r.gate[1] == 0).any())

    yj = np.asarray(yj)
    np.testing.assert_allclose(y.detach().numpy(), yj,
                               atol=MLP_RTOL * np.abs(yj).max())
    for name, got, want in [("x", xt.grad, gxj)] + [
            (k, tp[k].grad, gpj[k]) for k in ("router", "wi", "wo")]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=MLP_RTOL * np.abs(want).max(),
                                   err_msg=name)
    assert float(tp["router"].grad.abs().max()) > 0      # the router trains


def test_fused_and_unfused_fronts_route_alike():
    """Row 18's fused front and the routers + ``_dispatch_indices`` give
    the same output: the routing decisions are bit-identical."""
    x = torch.from_numpy(np.random.RandomState(3).randn(T, H).astype(
        np.float32))
    logits = torch.from_numpy(_logits(5))

    def expert_fn(buf):
        return torch.tanh(buf) * torch.arange(1, E + 1.0)[:, None, None]

    y1, a1 = tep.moe_dispatch_combine_fused(x, logits, expert_fn, E,
                                            top_k=2, axis_name=None)
    y2 = tep.moe_dispatch_combine(x, tep.top2_router(logits), expert_fn, E,
                                  axis_name=None)
    assert torch.equal(y1, y2)
    assert float(a1) == pytest.approx(
        float(tep.top2_router(logits).load_balancing_loss), rel=1e-6)


def test_sharded_exchange_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 8"):
        tep.ExpertParallelMLP(H, F, E)             # JAX's default axis
    with pytest.raises(NotImplementedError, match="item 8"):
        tep.moe_dispatch_combine_fused(torch.zeros(4, H), torch.zeros(4, E),
                                       lambda b: b, E, axis_name="expert")
    with pytest.raises(ValueError, match="requires rng"):
        tep.top2_router(torch.zeros(4, E), "random")
