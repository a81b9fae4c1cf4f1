"""Port parity: ``apex_tpu_torch.contrib.optimizers.distributed_fused_adam``
at world size 1, over a one-rank gloo group (a ``HashStore``, no network),
against the JAX package's ``distributed_fused_adam(use_pallas=True)``
inside ``shard_map`` over a one-device mesh (its shard update in Pallas
interpret mode) over 4 steps; and against the port's own dense
``fused_adam.update``, which at one rank computes every element with the
same plain code on the CPU: bitwise.

Tolerance against JAX: parameters and the moment shards within 1e-6 of
the buffer's max |x| (the Adam body's per-element agreement, see
``test_torch_fused_optim_update.py``).
"""
import importlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from apex_tpu._compat import shard_map
from apex_tpu.contrib.optimizers import distributed_fused_adam as j_dist
from apex_tpu.contrib.optimizers.distributed_fused_adam import \
    _shard_padded as j_shard_padded
from apex_tpu.ops import multi_tensor as jmt
from apex_tpu_torch.contrib.optimizers import distributed_fused_adam
from apex_tpu_torch.optimizers import (apply_updates, fused_adam,
                                       state_from_numpy)

# the module (the package exports its factory under the same name)
dfa_module = importlib.import_module(
    "apex_tpu_torch.contrib.optimizers.distributed_fused_adam")

RTOL = 1e-6
STEPS = 4
WD = 0.02
SPEC = {"a": ((37, 11), jnp.float32), "b": ((300,), jnp.bfloat16),
        "c": ((5, 129), jnp.float32)}


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo default group, unless one exists already (then it
    is used and left alone)."""
    if dist.is_initialized():
        yield
        return
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def _tree(rng, scale=1.0):
    return {k: jnp.asarray((rng.randn(*s) * scale).astype(np.float32))
            .astype(dt) for k, (s, dt) in SPEC.items()}


def _leaves(tree):
    """JAX's flattening order (sorted keys), as torch tensors."""
    return [torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)
        for x in jax.tree_util.tree_leaves(tree)]


def _close(got, want):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


def _jax_run(params, grads):
    """4 steps of JAX's sharded Adam inside shard_map over one device."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    tx = j_dist(1e-2, weight_decay=WD, use_pallas=True)
    state = jax.jit(shard_map(tx.init, mesh=mesh, in_specs=P(),
                              out_specs=P(), check_vma=False))(params)

    def body(p, s, g):
        u, s2 = tx.update(g, s, p)
        return optax.apply_updates(p, u), s2

    step = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P(), P()),
                             out_specs=(P(), P()), check_vma=False))
    for g in grads:
        params, state = step(params, state, g)
    return params, state


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return _tree(rng), [_tree(rng, 0.1) for _ in range(STEPS)]


def test_matches_jax(one_rank):
    params, grads = _inputs()
    jp, js = _jax_run(params, grads)
    tx = distributed_fused_adam(1e-2, weight_decay=WD)
    tp = _leaves(params)
    ts = tx.init(tp)
    for g in grads:
        u, ts = tx.update(_leaves(g), ts, tp)
        apply_updates(tp, u)
    for t, w in zip(tp, jax.tree_util.tree_leaves(jp)):
        assert t.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16
                           else torch.float32)
        _close(t, w)
    assert ts.count == int(js.count) == STEPS
    for ours, theirs in ((ts.m, js.m), (ts.v, js.v)):
        assert len(ours) == len(theirs) == 2      # one a dtype group
        for t, w in zip(ours, theirs):
            _close(t, w)


def test_resumes_from_jax_state(one_rank):
    """JAX's state after 4 steps carried into the port
    (``state_from_numpy``): its shapes are the port's own."""
    params, grads = _inputs(1)
    _, js = _jax_run(params, grads)
    ts = state_from_numpy("distributed_fused_adam",
                          jax.tree_util.tree_map(np.asarray, js._asdict()))
    fresh = distributed_fused_adam(1e-2).init(_leaves(params))
    assert ts.count == STEPS
    assert [t.shape for t in ts.m] == [t.shape for t in fresh.m]


def test_sharded_equals_dense_bitwise(one_rank):
    params, grads = _inputs(2)
    dense, sharded = fused_adam(1e-2, weight_decay=WD), \
        distributed_fused_adam(1e-2, weight_decay=WD)
    dp, sp = _leaves(params), _leaves(params)
    ds, ss = dense.init(dp), sharded.init(sp)
    for g in grads:
        u, ds = dense.update(_leaves(g), ds, dp)
        apply_updates(dp, u)
        u, ss = sharded.update(_leaves(g), ss, sp)
        apply_updates(sp, u)
    for a, b in zip(dp, sp):
        assert torch.equal(a, b)


def test_state_is_shard_sized(one_rank):
    params, _ = _inputs()
    tp = _leaves(params)
    ts = distributed_fused_adam(1e-2).init(tp)
    want = [j_shard_padded(m, 1) for m in jmt.compute_metas(params)]
    assert [t.numel() for t in ts.m] == [t.numel() for t in ts.v] == want
    assert all(t.dtype == torch.float32 for t in ts.m + ts.v)


def test_more_than_one_rank_raises(one_rank, monkeypatch):
    tx = distributed_fused_adam(1e-2)
    tp = _leaves(_inputs()[0])
    state = tx.init(tp)
    monkeypatch.setattr(dfa_module.dist, "get_world_size",
                        lambda group=None: 2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        tx.init(tp)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        tx.update(tp, state, tp)


def test_update_requires_params(one_rank):
    tx = distributed_fused_adam(1e-2)
    tp = _leaves(_inputs()[0])
    with pytest.raises(ValueError, match="requires params"):
        tx.update(tp, tx.init(tp))
