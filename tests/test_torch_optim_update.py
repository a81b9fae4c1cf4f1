"""Port parity: the optax-style ``update`` of ``fused_adam``, ``fused_sgd``,
``fused_adagrad`` and ``fused_novograd`` (``apex_tpu_torch.optimizers``),
with ``apply_updates``, against the JAX package's
``update(use_pallas=True)`` with ``optax.apply_updates`` over 4 steps, on
one seeded tree of fp32 and bf16 leaves (sizes not multiples of 128).

Twice: all-direct (``DIRECT_MIN_ELEMS`` 0, the default of both packages:
one group a leaf), and with ``DIRECT_MIN_ELEMS`` raised in both packages,
so every leaf packs and the packed groups run the bodies (NovoGrad's
kernel body runs only there, as in JAX).  The JAX tree is a dict, which
JAX flattens in sorted-key order; the port gets its leaves in that order.

Tolerance: parameters and every state buffer within 1e-6 of the
buffer's max |x| (the bodies' per-element agreement, see
``test_torch_fused_optim_update.py``; measured at most 2.1e-7 here, the
bf16 parameters equal).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from apex_tpu.ops import multi_tensor as jmt
from apex_tpu.optimizers import fused_adagrad as j_adagrad
from apex_tpu.optimizers import fused_adam as j_adam
from apex_tpu.optimizers import fused_novograd as j_novograd
from apex_tpu.optimizers import fused_sgd as j_sgd
from apex_tpu_torch.ops import multi_tensor as tmt
from apex_tpu_torch.optimizers import (apply_updates, fused_adagrad,
                                       fused_adam, fused_novograd, fused_sgd,
                                       state_from_numpy)

RTOL = 1e-6
STEPS = 4
SPEC = {"w1": ((37, 11), "fp32"), "b1": ((300,), "bf16"),
        "w0": ((5, 129), "fp32"), "emb": ((64, 3), "bf16"),
        "ln": ((7,), "fp32")}
DT = {"fp32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
# name -> (JAX factory, port factory, the port's state-conversion name)
OPTS = {
    "adamw": (lambda: j_adam(1e-2, weight_decay=0.01, use_pallas=True),
              lambda: fused_adam(1e-2, weight_decay=0.01), "fused_adam"),
    "adam_l2": (lambda: j_adam(1e-2, weight_decay=0.01, adam_w_mode=False,
                               use_pallas=True),
                lambda: fused_adam(1e-2, weight_decay=0.01,
                                   adam_w_mode=False), "fused_adam"),
    "sgd": (lambda: j_sgd(0.1, weight_decay=0.01, use_pallas=True),
            lambda: fused_sgd(0.1, weight_decay=0.01), "fused_sgd"),
    "sgd_momentum": (lambda: j_sgd(0.1, momentum=0.9, dampening=0.1,
                                   weight_decay=0.01, use_pallas=True),
                     lambda: fused_sgd(0.1, momentum=0.9, dampening=0.1,
                                       weight_decay=0.01), "fused_sgd"),
    "sgd_nesterov": (lambda: j_sgd(0.1, momentum=0.9, nesterov=True,
                                   weight_decay=0.01,
                                   wd_after_momentum=True, use_pallas=True),
                     lambda: fused_sgd(0.1, momentum=0.9, nesterov=True,
                                       weight_decay=0.01,
                                       wd_after_momentum=True), "fused_sgd"),
    "adagrad": (lambda: j_adagrad(1e-2, weight_decay=0.01, use_pallas=True),
                lambda: fused_adagrad(1e-2, weight_decay=0.01),
                "fused_adagrad"),
    "novograd": (lambda: j_novograd(1e-2, weight_decay=0.01,
                                    use_pallas=True),
                 lambda: fused_novograd(1e-2, weight_decay=0.01),
                 "fused_novograd"),
    "novograd_init_zero": (lambda: j_novograd(1e-2, weight_decay=0.01,
                                              init_zero=True,
                                              use_pallas=True),
                           lambda: fused_novograd(1e-2, weight_decay=0.01,
                                                  init_zero=True),
                           "fused_novograd"),
}


def _tree(rng, scale=1.0):
    return {k: jnp.asarray((rng.randn(*s) * scale).astype(np.float32))
            .astype(DT[d][0]) for k, (s, d) in SPEC.items()}


def _leaves(tree):
    """The tree's leaves in JAX's flattening (sorted-key) order."""
    return [torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        DT["bf16" if x.dtype == jnp.bfloat16 else "fp32"][1])
        for x in jax.tree_util.tree_leaves(tree)]


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * max(np.abs(want).max(), 1e-30)


def _hold(tp, ts, jp, js):
    for t, w in zip(tp, jax.tree_util.tree_leaves(jp)):
        assert t.dtype == DT["bf16" if w.dtype == jnp.bfloat16
                             else "fp32"][1]
        _close(t, w)
    assert ts.count == int(js.count)
    for field, bufs in js._asdict().items():
        if field != "count":
            assert len(getattr(ts, field)) == len(bufs)
            for t, w in zip(getattr(ts, field), bufs):
                _close(t, w)


def _steps(jtx, ttx, jp, js, tp, ts, grads):
    update = jax.jit(jtx.update)
    for g in grads:
        u, js = update(g, js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = ttx.update(_leaves(g), ts, tp)
        apply_updates(tp, tu)
    return jp, js, tp, ts


@pytest.fixture
def direct_min(monkeypatch):
    def set_(n):
        monkeypatch.setattr(jmt, "DIRECT_MIN_ELEMS", n)
        monkeypatch.setattr(tmt, "DIRECT_MIN_ELEMS", n)
    return set_


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", list(OPTS))
def test_update_matches_jax(name, packed, direct_min):
    direct_min(10 ** 6 if packed else 0)
    make_j, make_t, _ = OPTS[name]
    rng = np.random.RandomState(0)
    jp = _tree(rng)
    grads = [_tree(rng, 0.1) for _ in range(STEPS)]
    jtx, ttx = make_j(), make_t()
    tp = _leaves(jp)
    js, ts = jtx.init(jp), ttx.init(tp)
    jp, js, tp, ts = _steps(jtx, ttx, jp, js, tp, ts, grads)
    _hold(tp, ts, jp, js)
    # packed: one group a dtype; all-direct: one a leaf
    assert len(tmt.compute_metas(tp, split_direct=True)) == \
        (2 if packed else len(SPEC))


@pytest.mark.parametrize("name", list(OPTS))
def test_resume_from_jax_state(name):
    """Two JAX steps, then both packages on from JAX's state and
    parameters (``state_from_numpy``) for two more."""
    make_j, make_t, kind = OPTS[name]
    rng = np.random.RandomState(1)
    jp = _tree(rng)
    grads = [_tree(rng, 0.1) for _ in range(STEPS)]
    jtx, ttx = make_j(), make_t()
    js = jtx.init(jp)
    for g in grads[:2]:
        u, js = jtx.update(g, js, jp)
        jp = optax.apply_updates(jp, u)
    ts = state_from_numpy(kind, jax.tree_util.tree_map(np.asarray,
                                                       js._asdict()))
    assert ts.count == 2
    tp = _leaves(jp)
    jp, js, tp, ts = _steps(jtx, ttx, jp, js, tp, ts, grads[2:])
    _hold(tp, ts, jp, js)


@pytest.mark.parametrize("name", list(OPTS))
def test_update_requires_params(name):
    ttx = OPTS[name][1]()
    tp = _leaves(_tree(np.random.RandomState(2)))
    with pytest.raises(ValueError, match="requires params"):
        ttx.update(tp, ttx.init(tp))


def test_constructor_checks_match_jax():
    with pytest.raises(ValueError, match="norm_type"):
        fused_novograd(norm_type=1)
    with pytest.raises(ValueError, match="eps > 0"):
        fused_novograd(eps=0.0)
    with pytest.raises(ValueError, match="Nesterov"):
        fused_sgd(0.1, nesterov=True)
    # schedules are ported (tests/test_torch_optim_recipe.py holds them
    # against JAX): the constructors keep the callable
    for make in (fused_adagrad, fused_adam, fused_novograd):
        assert make(lambda count: 1e-3).learning_rate(1) == 1e-3


def test_state_from_numpy_refuses_unknown():
    with pytest.raises(ValueError, match="no state conversion"):
        state_from_numpy("fused_lamb", {"count": np.int32(0)})


@pytest.mark.parametrize("make", [fused_adam, fused_sgd])
def test_staged_state_is_per_leaf_whatever_the_grouping(make, monkeypatch):
    # amp's staged route steps one buffer a master: a raised
    # DIRECT_MIN_ELEMS packs init()'s state, never staged_init()'s
    monkeypatch.setattr(tmt, "DIRECT_MIN_ELEMS", 1 << 20)
    tp = _leaves(_tree(np.random.RandomState(3)))
    masters = [t.float() for t in tp]
    bufs = [t for f in ("m", "v", "momentum")
            for t in getattr(make(0.1).staged_init(masters), f, ())]
    assert bufs and all(b.shape == p.shape and b.dtype == torch.float32
                        and not b.any()
                        for b, p in zip(bufs, masters * 2))
    packed = make(0.1).init(tp)
    first = packed.m if hasattr(packed, "m") else packed.momentum
    assert len(first) < len(tp)
