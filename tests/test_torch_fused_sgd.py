"""Port parity: row 19's SGD-step, SGD-pipeline and Adam-step bodies
(``apex_tpu_torch.ops.sgd_step``, ``sgd_pipeline``, ``adam_step``, and
the steps over a list of leaves, ``sgd_step_leaves`` and
``adam_step_leaves``) against the JAX package's Pallas bodies in CPU
interpret mode, leaf by leaf
(``fused_optim.sgd_step(..., interpret=True)``,
``fused_pipeline.sgd_pipeline(use_pallas=True)``,
``fused_optim.adam_step``), and ``FusedSGD``'s staged and pipeline steps
against ``fused_sgd(use_pallas=True)``'s, on the same numpy inputs.

Tolerance: each fp32 element within two fp32 ulps of the element's
largest operand (its scaled gradient, its old and new master and
state).  The port's plain versions round after every operation (as the
CUDA kernels do, bit for bit); XLA's CPU compiler contracts the JAX
kernels' multiply-adds into FMAs, which moves a result by up to half an
ulp of its operands a contraction, and SGD's momentum chains two (``g +
wd * p`` into ``momentum * mom + (1 - dampening) * g``): measured, two
ulps of the largest operand and, where the terms cancel, up to ~4e4 ulps
of the result itself.  Over several steps the differences carry into
the next step's operands (through the momentum above all), so the
optimizer-step tests allow two ulps for each applied step (three
staged steps measured 2.5).  The model copy within one ulp
of its dtype of the JAX one (a cast of masters that agree to that
tolerance), and a skipped step bitwise.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.ops import fused_optim as jfo
from apex_tpu.ops import fused_pipeline as jfp
from apex_tpu.optimizers import fused_sgd as jax_fused_sgd
from apex_tpu_torch.ops import (adam_step, adam_step_leaves, sgd_pipeline,
                                sgd_step, sgd_step_leaves)
from apex_tpu_torch.optimizers import fused_adam, fused_sgd

N = 128 * 40 + 37            # an odd length: the kernels' scalar tail
TORCH = {None: None, "bf16": torch.bfloat16, "fp16": torch.float16}
JAXD = {None: None, "bf16": jnp.bfloat16, "fp16": jnp.float16}
LOWP_ULP = {"bf16": 2.0 ** -7, "fp16": 2.0 ** -10}
# (nesterov, dampening, wd_after_momentum, first_run)
FLAGS = [(False, 0.0, False, False), (True, 0.0, False, False),
         (False, 0.1, True, False), (False, 0.1, False, True),
         (True, 0.0, True, True)]
SGD = dict(lr=0.1, momentum=0.9, weight_decay=1e-2)


def _inputs(seed, n=N, gdt=None):
    rng = np.random.RandomState(seed)
    g = (rng.randn(n) * 3).astype(np.float32)
    if gdt is not None:        # the values a low-precision gradient holds
        g = np.asarray(jnp.asarray(g).astype(JAXD[gdt]).astype(jnp.float32))
    p = rng.randn(n).astype(np.float32)
    s1 = (rng.randn(n) * 0.5).astype(np.float32)
    s2 = np.abs(rng.randn(n) * 0.01).astype(np.float32)
    return g, p, s1, s2


def _ulps_close(got, want, *operands, ulps=2.0):
    """|got - want| <= ``ulps`` fp32 ulps of the element's largest
    operand."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.max(np.abs(np.stack([want, *operands])), axis=0)
    ratio = np.abs(got - want) / np.spacing(scale.astype(np.float32))
    assert ratio.max() <= ulps, f"{ratio.max()} ulps, beyond {ulps}"


def _lowp_close(got, want, dt):
    want = np.asarray(want, np.float32)
    tol = np.maximum(np.abs(want), 2.0 ** -14) * LOWP_ULP[dt]
    assert np.all(np.abs(got.float().numpy() - want) <= tol)


def _t(a, dt=None):
    t = torch.from_numpy(np.array(a, np.float32))
    return t if dt is None else t.to(TORCH[dt])


@pytest.mark.parametrize("lowp", [None, "bf16", "fp16"])
@pytest.mark.parametrize("nesterov,dampening,wd_after,first", FLAGS)
def test_sgd_step_matches_jax_pallas(nesterov, dampening, wd_after, first,
                                     lowp):
    g, p, mom, _ = _inputs(1, gdt=lowp)
    kw = dict(SGD, dampening=dampening, nesterov=nesterov,
              wd_after_momentum=wd_after)
    (gb, pb, mb), restore = jfo.flatten_for_kernel(
        jnp.asarray(g).astype(JAXD[lowp] or jnp.float32), jnp.asarray(p),
        jnp.asarray(mom))
    outs = jfo.sgd_step(gb, pb, mb, first_run=float(first),
                        lowp_dtype=JAXD[lowp], interpret=True, **kw)
    jp, jm = (np.asarray(restore(o)) for o in outs[:2])
    tp, tm = _t(p), _t(mom)
    tl = None if lowp is None else torch.empty(N, dtype=TORCH[lowp])
    sgd_step(_t(g, lowp), tp, tm, tl, first_run=first, **kw)
    for got, want in ((tp, jp), (tm, jm)):
        _ulps_close(got.numpy(), want, g, p, mom, jp, jm)
    if lowp is not None:
        _lowp_close(tl, restore(outs[2]).astype(jnp.float32), lowp)


@pytest.mark.parametrize("finite", [True, False])
@pytest.mark.parametrize("nesterov,dampening,wd_after,first", FLAGS)
def test_sgd_pipeline_matches_jax_pallas(nesterov, dampening, wd_after,
                                         first, finite):
    g, p, mom, _ = _inputs(2, gdt="bf16")
    kw = dict(SGD, dampening=dampening, nesterov=nesterov,
              wd_after_momentum=wd_after)
    # the JAX sweep takes LANE-padded packed buffers
    flats, restore = jfo.flatten_for_kernel(
        jnp.asarray(g).astype(jnp.bfloat16), jnp.asarray(p),
        jnp.asarray(mom))
    jp, jm, jl = (np.asarray(restore(o).astype(jnp.float32))
                  for o in jfp.sgd_pipeline(
                      *flats, grad_scale=0.5, first_run=float(first),
                      finite=finite, lowp_dtype=jnp.bfloat16,
                      use_pallas=True, **kw))
    tp, tm = _t(p), _t(mom)
    tl = torch.empty(N, dtype=torch.bfloat16)
    sgd_pipeline(_t(g, "bf16"), tp, tm, tl, grad_scale=0.5,
                 first_run=first, keep=finite, **kw)
    if finite:
        for got, want in ((tp, jp), (tm, jm)):
            _ulps_close(got.numpy(), want, 0.5 * g, p, mom, jp, jm)
    else:                             # skipped: bitwise unchanged
        for got, want, old in ((tp, jp, p), (tm, jm, mom)):
            assert np.array_equal(got.numpy(), old)
            assert np.array_equal(want, old)
    _lowp_close(tl, jl, "bf16")


def test_sgd_pipeline_takes_device_scalars():
    # the scale and the skip flag as 0-d tensors (a device-measured flag)
    g, p, mom, _ = _inputs(3, gdt="bf16")
    kw = dict(SGD, dampening=0.0, first_run=False)
    want_p, want_m = _t(p), _t(mom)
    sgd_pipeline(_t(g, "bf16"), want_p, want_m, grad_scale=0.25, keep=True,
                 **kw)
    tp, tm = _t(p), _t(mom)
    sgd_pipeline(_t(g, "bf16"), tp, tm, grad_scale=torch.tensor(0.25),
                 keep=torch.tensor(True), **kw)
    assert torch.equal(tp, want_p) and torch.equal(tm, want_m)
    sgd_pipeline(_t(g, "bf16"), tp, tm, grad_scale=torch.tensor(0.25),
                 keep=torch.tensor(False), **kw)
    assert torch.equal(tp, want_p) and torch.equal(tm, want_m)


@pytest.mark.parametrize("lowp", [None, "bf16", "fp16"])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_adam_step_matches_jax_pallas(adam_w_mode, lowp):
    g, p, m, v = _inputs(4, gdt=lowp)
    m = m * np.float32(0.2)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              bias_correction1=1 - 0.9 ** 3, bias_correction2=1 - 0.999 ** 3,
              adam_w_mode=adam_w_mode)
    flats, restore = jfo.flatten_for_kernel(
        jnp.asarray(g).astype(JAXD[lowp] or jnp.float32),
        *(jnp.asarray(a) for a in (p, m, v)))
    outs = jfo.adam_step(*flats, lowp_dtype=JAXD[lowp], interpret=True, **kw)
    jp, jm, jv = (np.asarray(restore(o)) for o in outs[:3])
    tp, tm, tv = _t(p), _t(m), _t(v)
    tl = None if lowp is None else torch.empty(N, dtype=TORCH[lowp])
    adam_step(_t(g, lowp), tp, tm, tv, tl, **kw)
    for got, want in ((tp, jp), (tm, jm), (tv, jv)):
        _ulps_close(got.numpy(), want, g, p, m, v, jp, jm, jv)
    if lowp is not None:
        _lowp_close(tl, restore(outs[3]).astype(jnp.float32), lowp)


# a mixed leaf list, as the staged route hands it over: (g dtype, lowp
# dtype, length), odd lengths
LEAF_MIX = [(None, None, 37), ("bf16", "bf16", 301), ("fp16", "fp16", 130),
            ("bf16", None, 65), (None, "fp16", 9)]


def _leaf_mix(seed, states):
    """Per leaf of ``LEAF_MIX``: (g, lowp dtype, [p, state...]) as numpy,
    g holding the values of its dtype."""
    out = []
    for i, (gdt, ldt, n) in enumerate(LEAF_MIX):
        g, p, s1, s2 = _inputs(seed + i, n, gdt)
        out.append((g, gdt, ldt, [p, s1, s2 * 5 + 0.01][:states + 1]))
    return out


def _jax_leaf(fn, g, gdt, ldt, bufs, **kw):
    """The JAX step on one leaf (LANE-padded by ``flatten_for_kernel``):
    the new p and state, and the copy (or None), as numpy."""
    flats, restore = jfo.flatten_for_kernel(
        jnp.asarray(g).astype(JAXD[gdt] or jnp.float32),
        *(jnp.asarray(b) for b in bufs))
    outs = fn(*flats, lowp_dtype=JAXD[ldt], interpret=True, **kw)
    new = [np.asarray(restore(o)) for o in outs[:len(bufs)]]
    low = None if ldt is None else \
        restore(outs[len(bufs)]).astype(jnp.float32)
    return new, low


def _hold_leaves(leaves, got, lows, jax_fn, **kw):
    for (g, gdt, ldt, bufs), tb, tl in zip(leaves, got, lows):
        want, low = _jax_leaf(jax_fn, g, gdt, ldt, bufs, **kw)
        for a, b in zip(tb, want):
            _ulps_close(a.numpy(), b, g, *bufs, *want)
        if ldt is not None:
            _lowp_close(tl, low, ldt)


@pytest.mark.parametrize("nesterov,dampening,wd_after,first", FLAGS)
def test_sgd_step_leaves_matches_jax_pallas(nesterov, dampening, wd_after,
                                            first):
    leaves = _leaf_mix(40, 1)
    kw = dict(SGD, dampening=dampening, nesterov=nesterov,
              wd_after_momentum=wd_after)
    got = [[_t(b) for b in bufs] for _, _, _, bufs in leaves]
    lows = [None if ldt is None else torch.empty(len(g), dtype=TORCH[ldt])
            for g, _, ldt, _ in leaves]
    sgd_step_leaves([_t(g, gdt) for g, gdt, _, _ in leaves],
                    [b[0] for b in got], [b[1] for b in got], lows,
                    first_run=first, **kw)
    _hold_leaves(leaves, got, lows, jfo.sgd_step, first_run=float(first),
                 **kw)


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_adam_step_leaves_matches_jax_pallas(adam_w_mode):
    leaves = _leaf_mix(50, 2)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              bias_correction1=1 - 0.9 ** 3, bias_correction2=1 - 0.999 ** 3,
              adam_w_mode=adam_w_mode)
    got = [[_t(b) for b in bufs] for _, _, _, bufs in leaves]
    lows = [None if ldt is None else torch.empty(len(g), dtype=TORCH[ldt])
            for g, _, ldt, _ in leaves]
    adam_step_leaves([_t(g, gdt) for g, gdt, _, _ in leaves],
                     *([b[k] for b in got] for k in range(3)), lows, **kw)
    _hold_leaves(leaves, got, lows, jfo.adam_step, **kw)


def _tree(seed):
    """A bf16-model leaf and an fp32 (batch-norm-like) leaf."""
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(64, 33).astype(np.float32),
            "bn": rng.randn(40).astype(np.float32)}


def _grads(seed, model):
    rng = np.random.RandomState(seed)
    return {k: jnp.asarray(rng.randn(*v.shape) * 0.3).astype(v.dtype)
            for k, v in model.items()}


@pytest.mark.parametrize("momentum,nesterov", [(0.9, False), (0.9, True),
                                               (0.0, False)])
def test_fused_sgd_staged_steps_match_jax(momentum, nesterov):
    # three single-pass steps: count, first run (buf <- g), the momentum
    # == 0 branch, the model copy from the kernel's lowp output
    tree = _tree(5)
    masters = {k: jnp.asarray(v) for k, v in tree.items()}
    model = {"w": masters["w"].astype(jnp.bfloat16), "bn": masters["bn"]}
    tx = jax_fused_sgd(0.1, momentum=momentum, weight_decay=1e-4,
                       nesterov=nesterov, use_pallas=True)
    state = tx.init(masters)
    ours = fused_sgd(0.1, momentum=momentum, weight_decay=1e-4,
                     nesterov=nesterov)
    pt = {k: _t(v) for k, v in tree.items()}
    model_t = {"w": pt["w"].bfloat16(), "bn": pt["bn"]}   # bn: its master
    ostate = ours.init([pt["w"], pt["bn"]])
    seen = {k: [np.abs(v)] for k, v in tree.items()}     # the operands
    for i in range(3):
        grads = _grads(10 + i, model)
        masters, state, model = tx.fused_step(grads, state, masters,
                                              model_params=model)
        gt = [_t(grads["w"].astype(jnp.float32), "bf16"),
              _t(grads["bn"])]
        ostate = ours.fused_step(gt, ostate, [pt["w"], pt["bn"]],
                                 [model_t["w"], None])
        for k, gk in zip(("w", "bn"), gt):
            seen[k].append(gk.float().abs().numpy())
    assert ostate.count == int(state.count) == 3
    for k in ("w", "bn"):
        _ulps_close(pt[k].numpy(), np.asarray(masters[k]), *seen[k],
                    ulps=2 * 3)
    mom_t = dict(zip(("w", "bn"), ostate.momentum))
    if momentum:
        # JAX's split_direct groups: one per leaf, in tree order
        for (k, mt), mj in zip(sorted(mom_t.items()), state.momentum):
            _ulps_close(mt.numpy(), np.asarray(mj).reshape(mt.shape),
                        *seen[k], ulps=2 * 3)
    _lowp_close(model_t["w"], model["w"].astype(jnp.float32), "bf16")
    assert model_t["bn"] is pt["bn"]


def test_fused_sgd_pipeline_steps_match_jax():
    # three pipeline steps, the middle one skipped: the count and the
    # first run follow the applied steps only; the skip holds master and
    # momentum bitwise
    n = 3000
    _, p, _, _ = _inputs(6, n)
    tree = {"w": jnp.asarray(p)}
    masters = jfp.pack_masters(tree, {"w": tree["w"].astype(jnp.bfloat16)})
    tx = jax_fused_sgd(0.1, momentum=0.9, weight_decay=1e-4,
                       use_pallas=True)
    state = tx.pipeline_init(masters.metas)
    bufs = masters.bufs
    ours = fused_sgd(0.1, momentum=0.9, weight_decay=1e-4)
    pt = _t(p)
    ostate = ours.pipeline_init([pt])
    lowp = torch.empty(n, dtype=torch.bfloat16)
    seen = [np.abs(p)]                                   # the operands
    for i, finite in enumerate((True, False, True)):
        gj = {"w": jnp.asarray(np.random.RandomState(20 + i).randn(n)
                               * 0.1).astype(jnp.bfloat16)}
        seen.append(0.5 * np.abs(np.asarray(gj["w"].astype(jnp.float32))))
        before = (pt.clone(), ostate.momentum[0].clone())
        bufs, state, lowps = tx.pipeline_step(
            jfp.pack_grads(gj, masters.metas), state, bufs, masters.metas,
            grad_scale=0.5, finite=finite)
        ostate = ours.pipeline_step(
            [_t(gj["w"].astype(jnp.float32), "bf16")], ostate, [pt], [lowp],
            grad_scale=0.5, finite=finite)
        if not finite:
            assert torch.equal(pt, before[0])
            assert torch.equal(ostate.momentum[0], before[1])
    assert ostate.count == int(state.count) == 2
    _ulps_close(pt.numpy(), np.asarray(bufs[0])[:n], *seen, ulps=2 * 2)
    _ulps_close(ostate.momentum[0].numpy(), np.asarray(state.momentum[0])[:n],
                *seen, ulps=2 * 2)
    _lowp_close(lowp, np.asarray(lowps[0].astype(jnp.float32))[:n], "bf16")


def test_fused_adam_staged_step_matches_jax():
    # bias corrections at count + 1 in fp32, one adam_step_leaves a step
    from apex_tpu.optimizers import fused_adam as jax_fused_adam

    tree = _tree(7)
    masters = {k: jnp.asarray(v) for k, v in tree.items()}
    model = {"w": masters["w"].astype(jnp.bfloat16), "bn": masters["bn"]}
    tx = jax_fused_adam(1e-2, weight_decay=0.01, use_pallas=True)
    state = tx.init(masters)
    ours = fused_adam(1e-2, weight_decay=0.01)
    pt = {k: _t(v) for k, v in tree.items()}
    lowp_w = pt["w"].bfloat16()
    ostate = ours.init([pt["w"], pt["bn"]])
    seen = {k: [np.abs(v)] for k, v in tree.items()}     # the operands
    for i in range(3):
        grads = _grads(30 + i, model)
        masters, state, model = tx.fused_step(grads, state, masters,
                                              model_params=model)
        gt = [_t(grads["w"].astype(jnp.float32), "bf16"), _t(grads["bn"])]
        ostate = ours.fused_step(gt, ostate, [pt["w"], pt["bn"]],
                                 [lowp_w, None])
        for k, gk in zip(("w", "bn"), gt):
            seen[k].append(gk.float().abs().numpy())
    assert ostate.count == int(state.count) == 3
    for k in ("w", "bn"):
        _ulps_close(pt[k].numpy(), np.asarray(masters[k]), *seen[k],
                    ulps=2 * 3)
    _lowp_close(lowp_w, model["w"].astype(jnp.float32), "bf16")


def test_unported_options_raise():
    with pytest.raises(ValueError, match="Nesterov"):
        fused_sgd(0.1, momentum=0.9, dampening=0.1, nesterov=True)
    with pytest.raises(ValueError, match="Nesterov"):
        fused_sgd(0.1, nesterov=True)
    # (the name is kept from when they raised) global-norm clipping and
    # schedules are ported: the constructors keep them, and a schedule
    # is read at count + 1
    assert fused_sgd(0.1, momentum=0.9, max_grad_norm=1.0).max_grad_norm \
        == 1.0
    tx = fused_sgd(lambda count: 0.1 * count, momentum=0.9)
    assert tx._hyp(0)["lr"] == pytest.approx(0.1)
    assert tx._hyp(2)["lr"] == pytest.approx(0.3)
    assert fused_adam(lambda count: 1e-3).learning_rate(1) == 1e-3
