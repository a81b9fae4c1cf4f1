"""Port parity for the training recipe's optimizer options: global-norm
clipping (``max_grad_norm``) and learning-rate schedules, on every route
of ``fused_adam`` and ``fused_sgd`` (``update``, the staged
``fused_step``, ``pipeline_step``), on ``fused_lamb`` (the staged
``fused_step`` and the pipeline) and the schedules of ``fused_adagrad``,
``fused_novograd`` and one-rank ``distributed_fused_adam``: the port
against the JAX package, side by side for several steps from the same
numpy inputs (JAX with ``use_pallas=True``: its Pallas bodies in CPU
interpret mode, whose fp32 hyperparameters the port's kernels share).

The cases: a schedule (a callable of the step count, read at ``count +
1`` by both: a schedule read at another count moves every step by a
third); ``max_grad_norm`` that clips (0.5 against norms of ~100), that
does not (1e6), and that is off (None and 0); and, on the pipelines, a
non-finite step, which holds the state bitwise and the count still while
the schedule is still read at ``count + 1``.  The count matches exactly.
State is held to each optimizer's tolerance in its existing
``test_torch_fused_*`` / ``test_torch_optim_update`` file: Adam 1e-6
relative plus 1e-7 absolute; SGD two fp32 ulps of the largest operand a
step; LAMB 1e-6 absolute (values of order 1); Adagrad, NovoGrad and
``distributed_fused_adam`` 1e-6 of the largest value.  The clip factor
comes from norms summed in other orders on the two sides (a relative
1e-7), well inside these.

``fused_lamb``'s staged step is also held against its own pipeline step
over the same tensors (1e-6 absolute: the global norm and the
trust-ratio norms are sums in other orders).
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from apex_tpu.ops import fused_pipeline as jfp
from apex_tpu.optimizers import fused_adagrad as jax_fused_adagrad
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu.optimizers import fused_lamb as jax_fused_lamb
from apex_tpu.optimizers import fused_novograd as jax_fused_novograd
from apex_tpu.optimizers import fused_sgd as jax_fused_sgd
from apex_tpu_torch.optimizers import (fused_adagrad, fused_adam, fused_lamb,
                                       fused_novograd, fused_sgd)

SHAPES = {"a": (40, 24), "b": (100,), "c": (7, 5)}
KEYS = sorted(SHAPES)                     # JAX's dict leaf order
STEPS = 3
CLIPS = {"clips": 0.5, "no_clip": 1e6, "none": None, "zero": 0.0}


def sched(count):
    """A schedule both packages call: on a JAX int32 count or a host
    int."""
    return 1e-2 / (1.0 + 0.5 * count)


def _tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*SHAPES[k]) * scale).astype(np.float32)
            for k in KEYS}


def _leaves(tree, dtype=torch.float32):
    return [torch.from_numpy(tree[k].copy()).to(dtype) for k in KEYS]


def _bf16(tree):
    """The values bf16 gradients hold, as fp32 numpy."""
    return {k: np.asarray(jnp.asarray(v).astype(jnp.bfloat16)
                          .astype(jnp.float32)) for k, v in tree.items()}


def _rel_close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _lamb_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-6)


def _adam_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-7)


def _ulps_close(got, want, *operands, ulps=2.0):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.max(np.abs(np.stack([want, *operands])), axis=0)
    ratio = np.abs(got - want) / np.spacing(scale.astype(np.float32))
    assert ratio.max() <= ulps, f"{ratio.max()} ulps, beyond {ulps}"


# --- update: fused_adam and fused_sgd --------------------------------------

@pytest.mark.parametrize("clip", sorted(CLIPS))
@pytest.mark.parametrize("name", ["adam", "sgd", "sgd_no_momentum"])
def test_update_clip_and_schedule_match_jax(name, clip):
    max_norm = CLIPS[clip]
    if name == "adam":
        jtx = jax_fused_adam(sched, weight_decay=0.01,
                             max_grad_norm=max_norm, use_pallas=True)
        ttx = fused_adam(sched, weight_decay=0.01, max_grad_norm=max_norm)
    else:
        mom = 0.9 if name == "sgd" else 0.0
        jtx = jax_fused_sgd(sched, momentum=mom, weight_decay=1e-3,
                            max_grad_norm=max_norm, use_pallas=True)
        ttx = fused_sgd(sched, momentum=mom, weight_decay=1e-3,
                        max_grad_norm=max_norm)
    params = _tree(0)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pt = _leaves(params)
    sj, st = jtx.init(pj), ttx.init(pt)
    seen = [np.abs(params[k]) for k in KEYS]
    for i in range(STEPS):
        grads = _tree(10 + i, 3.0)
        uj, sj = jtx.update({k: jnp.asarray(v) for k, v in grads.items()},
                            sj, pj)
        pj = jax.tree.map(lambda p, u: p + u, pj, uj)
        ut, st = ttx.update(_leaves(grads), st, pt)
        pt = [p + u for p, u in zip(pt, ut)]
        seen = [np.maximum(s, np.abs(grads[k])) for s, k in zip(seen, KEYS)]
    assert st.count == int(sj.count) == STEPS
    for k, t in zip(KEYS, pt):
        if name == "adam":
            _adam_close(t.numpy(), pj[k])
        else:
            _ulps_close(t.numpy(), pj[k], seen[KEYS.index(k)],
                        ulps=2 * STEPS)


def test_update_clip_really_clips():
    # the clipping case moves the parameters less than the unclipped one
    params, grads = _tree(0), _tree(10, 3.0)
    moved = {}
    for clip in ("clips", "none"):
        tx = fused_sgd(0.1, max_grad_norm=CLIPS[clip])
        pt = _leaves(params)
        u, _ = tx.update(_leaves(grads), tx.init(pt), pt)
        moved[clip] = float(torch.stack([x.norm() for x in u]).norm())
    assert moved["clips"] == pytest.approx(0.1 * 0.5, rel=1e-5)
    assert moved["none"] > 10 * moved["clips"]


# --- the staged fused_step: fused_adam, fused_sgd, fused_lamb ---------------

def _staged(jtx, ttx, steps=STEPS, lowp=True):
    """Run both staged steps over bf16 model copies of fp32 masters."""
    masters = _tree(1)
    mj = {k: jnp.asarray(v) for k, v in masters.items()}
    model = {k: v.astype(jnp.bfloat16) for k, v in mj.items()}
    sj = jtx.init(mj)
    mt = _leaves(masters)
    lowps = [m.bfloat16() for m in mt] if lowp else [None] * len(mt)
    st = ttx.staged_init(mt)
    seen = [np.abs(masters[k]) for k in KEYS]
    for i in range(steps):
        g = _bf16(_tree(20 + i, 3.0))
        mj, sj, model = jtx.fused_step(
            {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in g.items()},
            sj, mj, model_params=model)
        gt = _leaves(g, torch.bfloat16)
        st = ttx.fused_step(gt, st, mt, lowps)
        seen.extend(np.abs(g[k]) for k in KEYS)
    return (mj, sj, model), (mt, st, lowps)


@pytest.mark.parametrize("clip", sorted(CLIPS))
@pytest.mark.parametrize("name", ["adam", "sgd", "lamb"])
def test_staged_step_clip_and_schedule_match_jax(name, clip):
    max_norm = CLIPS[clip]
    if name == "adam":
        jtx = jax_fused_adam(sched, weight_decay=0.01,
                             max_grad_norm=max_norm, use_pallas=True)
        ttx = fused_adam(sched, weight_decay=0.01, max_grad_norm=max_norm)
    elif name == "sgd":
        jtx = jax_fused_sgd(sched, momentum=0.9, weight_decay=1e-3,
                            max_grad_norm=max_norm, use_pallas=True)
        ttx = fused_sgd(sched, momentum=0.9, weight_decay=1e-3,
                        max_grad_norm=max_norm)
    else:
        jtx = jax_fused_lamb(sched, max_grad_norm=max_norm,
                             use_pallas=True)
        ttx = fused_lamb(sched, max_grad_norm=max_norm)
    (mj, sj, model), (mt, st, lowps) = _staged(jtx, ttx)
    assert st.count == int(sj.count) == STEPS
    for k, t, lp in zip(KEYS, mt, lowps):
        want = np.asarray(mj[k])
        if name == "adam":
            _adam_close(t.numpy(), want)
        elif name == "sgd":
            _ulps_close(t.numpy(), want, np.abs(want) + 1.0,
                        ulps=2 * STEPS)
        else:
            _lamb_close(t.numpy(), want)
        # the model copy: the cast of the master, within a bf16 ulp
        m = np.asarray(model[k].astype(jnp.float32))
        assert np.all(np.abs(lp.float().numpy() - m)
                      <= np.maximum(np.abs(m), 2.0 ** -14) * 2.0 ** -7)
    if name == "lamb":
        for i, k in enumerate(KEYS):
            _lamb_close(st.m[i].numpy(), np.asarray(sj.m[i]).reshape(
                SHAPES[k]))
            _lamb_close(st.v[i].numpy(), np.asarray(sj.v[i]).reshape(
                SHAPES[k]))


def test_staged_lamb_without_model_copies():
    # fp32 parameters are their own masters: no lowp written
    jtx, ttx = jax_fused_lamb(1e-3, use_pallas=True), fused_lamb(1e-3)
    (mj, _, _), (mt, st, _) = _staged(jtx, ttx, lowp=False)
    for k, t in zip(KEYS, mt):
        _lamb_close(t.numpy(), np.asarray(mj[k]))


# --- the pipelines: fused_adam, fused_sgd, fused_lamb -----------------------

# (grad_scale, the measured norm handed over?, finite)
PIPE_PLAN = [(1.0, False, True), (2.0 ** -10, True, True),
             (2.0 ** -10, True, False), (1.0, False, True)]


def _unpack(buf, meta):
    buf = np.asarray(buf)
    return np.concatenate([buf[o:o + n]
                           for o, n in zip(meta.offsets, meta.sizes)])


def _pipeline(jtx, ttx):
    """Both pipelines over one bf16 flat group of the three tensors, on
    ``PIPE_PLAN``; returns the final flat masters, states and the
    per-step snapshots checks need."""
    masters = _tree(2)
    template = {k: jnp.asarray(v).astype(jnp.bfloat16)
                for k, v in masters.items()}
    metas = jfp.pipeline_metas(template)
    (meta,) = metas
    pm = jfp.pack_masters({k: jnp.asarray(v) for k, v in masters.items()},
                          template)
    sj, jbufs = jtx.pipeline_init(metas), pm.bufs
    p = torch.from_numpy(np.concatenate([masters[k].ravel() for k in KEYS]))
    lowp = p.bfloat16()
    sizes = tuple(int(np.prod(SHAPES[k])) for k in KEYS)
    st = ttx.pipeline_init([p], segments=[sizes])
    rng = np.random.RandomState(4)
    seen = [np.abs(p.numpy())]
    for inv, handoff, finite in PIPE_PLAN:
        g = {k: (rng.randn(*SHAPES[k]) * 3.0 / inv).astype(np.float32)
             for k in KEYS}
        gtree = {k: jnp.asarray(v).astype(jnp.bfloat16)
                 for k, v in g.items()}
        gbufs = jfp.pack_grads(gtree, metas)
        gflat = torch.from_numpy(np.array(_unpack(
            gbufs[0].astype(jnp.float32), meta))).bfloat16()
        seen.append(np.abs(gflat.float().numpy() * inv))
        norm = None
        if handoff:
            norm = float(np.sqrt(np.sum(np.square(
                gflat.double().numpy() * inv))))
        jbufs, sj, jlowp = jtx.pipeline_step(
            gbufs, sj, jbufs, metas, grad_scale=inv,
            grad_norm=None if norm is None else jnp.float32(norm),
            finite=finite)
        before = [t.clone() for t in (p, *_state_bufs(st))]
        count = st.count
        st = ttx.pipeline_step([gflat], st, [p], [lowp], grad_scale=inv,
                               grad_norm=None if norm is None
                               else torch.tensor(norm), finite=finite)
        if not finite:
            assert st.count == count
            assert all(torch.equal(a, b) for a, b in
                       zip(before, (p, *_state_bufs(st))))
        assert st.count == int(sj.count)
    return _unpack(jbufs[0], meta), sj, meta, p, st, seen


def _state_bufs(st):
    return [getattr(st, f)[0] for f in ("m", "v", "momentum")
            if hasattr(st, f)]


@pytest.mark.parametrize("clip", sorted(CLIPS))
@pytest.mark.parametrize("name", ["adam", "sgd", "lamb"])
def test_pipeline_clip_and_schedule_match_jax(name, clip):
    max_norm = CLIPS[clip]
    if name == "adam":
        jtx = jax_fused_adam(sched, weight_decay=0.01,
                             max_grad_norm=max_norm, use_pallas=True)
        ttx = fused_adam(sched, weight_decay=0.01, max_grad_norm=max_norm)
    elif name == "sgd":
        jtx = jax_fused_sgd(sched, momentum=0.9, weight_decay=1e-3,
                            max_grad_norm=max_norm, use_pallas=True)
        ttx = fused_sgd(sched, momentum=0.9, weight_decay=1e-3,
                        max_grad_norm=max_norm)
    else:
        jtx = jax_fused_lamb(sched, max_grad_norm=max_norm,
                             use_pallas=True)
        ttx = fused_lamb(sched, max_grad_norm=max_norm)
    want, sj, meta, p, st, seen = _pipeline(jtx, ttx)
    applied = sum(1 for _, _, f in PIPE_PLAN if f)
    assert st.count == int(sj.count) == applied
    if name == "adam":
        _adam_close(p.numpy(), want)
        _adam_close(st.m[0].numpy(), _unpack(sj.m[0], meta))
    elif name == "sgd":
        _ulps_close(p.numpy(), want, *seen, ulps=2 * applied)
        _ulps_close(st.momentum[0].numpy(), _unpack(sj.momentum[0], meta),
                    *seen, ulps=2 * applied)
    else:
        _lamb_close(p.numpy(), want)
        _lamb_close(st.m[0].numpy(), _unpack(sj.m[0], meta))
        _lamb_close(st.v[0].numpy(), _unpack(sj.v[0], meta))


@pytest.mark.parametrize("clip", ["clips", "no_clip"])
def test_lamb_staged_matches_its_pipeline(clip):
    # the same three tensors, the same unscaled bf16 grads, a schedule:
    # one master a tensor (staged) against one flat group (pipeline)
    masters = _tree(3)
    tx = fused_lamb(sched, max_grad_norm=CLIPS[clip])
    staged = _leaves(masters)
    s_state = tx.staged_init(staged)
    s_lowp = [m.bfloat16() for m in staged]
    flat = torch.cat([m.reshape(-1) for m in staged])
    f_lowp = flat.bfloat16()
    sizes = tuple(m.numel() for m in staged)
    f_state = tx.pipeline_init([flat], segments=[sizes])
    for i in range(STEPS):
        g = _leaves(_tree(30 + i, 3.0), torch.bfloat16)
        s_state = tx.fused_step(g, s_state, staged, s_lowp)
        f_state = tx.pipeline_step([torch.cat([x.reshape(-1) for x in g])],
                                   f_state, [flat], [f_lowp])
    assert s_state.count == f_state.count == STEPS
    got = torch.cat([m.reshape(-1) for m in staged])
    _lamb_close(got.numpy(), flat.numpy())
    _lamb_close(torch.cat([m.reshape(-1) for m in s_state.m]).numpy(),
                f_state.m[0].numpy())


# --- schedules of the update-only optimizers --------------------------------

@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo default group, unless one exists already."""
    if dist.is_initialized():
        yield
        return
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def _run_updates(jstep, jstate, ttx, params):
    """STEPS updates on both sides; ``jstep(params, state, grads)``."""
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pt = _leaves(params)
    st = ttx.init(pt)
    for i in range(STEPS):
        grads = _tree(40 + i, 3.0)
        pj, jstate = jstep(pj, jstate,
                           {k: jnp.asarray(v) for k, v in grads.items()})
        ut, st = ttx.update(_leaves(grads), st, pt)
        pt = [p + u for p, u in zip(pt, ut)]
    assert st.count == int(jstate.count) == STEPS
    for k, t in zip(KEYS, pt):
        _rel_close(t.numpy(), pj[k])


@pytest.mark.parametrize("name", ["adagrad", "novograd"])
def test_update_schedules_match_jax(name):
    jtx, ttx = {"adagrad": (jax_fused_adagrad(sched, use_pallas=True),
                            fused_adagrad(sched)),
                "novograd": (jax_fused_novograd(sched, use_pallas=True),
                             fused_novograd(sched))}[name]
    params = _tree(5)

    def jstep(p, s, g):
        u, s = jtx.update(g, s, p)
        return jax.tree.map(lambda a, b: a + b, p, u), s

    _run_updates(jstep, jtx.init({k: jnp.asarray(v)
                                  for k, v in params.items()}),
                 ttx, params)


def test_distributed_fused_adam_schedule_matches_jax(one_rank):
    # JAX's sharded Adam inside shard_map over one device; the port on a
    # one-rank gloo group
    from jax.sharding import Mesh, PartitionSpec as P

    from apex_tpu._compat import shard_map

    from apex_tpu.contrib.optimizers import distributed_fused_adam as jdfa
    from apex_tpu_torch.contrib.optimizers import distributed_fused_adam

    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jtx = jdfa(sched, weight_decay=0.01, use_pallas=True)
    params = _tree(6)
    jstate = jax.jit(shard_map(jtx.init, mesh=mesh, in_specs=P(),
                               out_specs=P(), check_vma=False))(
        {k: jnp.asarray(v) for k, v in params.items()})

    def body(p, s, g):
        u, s2 = jtx.update(g, s, p)
        return jax.tree.map(lambda a, b: a + b, p, u), s2

    jstep = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P(), P()),
                              out_specs=(P(), P()), check_vma=False))
    _run_updates(jstep, jstate,
                 distributed_fused_adam(sched, weight_decay=0.01), params)
