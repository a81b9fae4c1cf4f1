"""Port parity for ``FusedMixedPrecisionLamb``: ``apex_tpu_torch``'s
against ``apex_tpu``'s with ``use_pallas=False`` (its plain jnp
reference, as ``tests/test_optimizers.py`` runs it), from the same
numpy inputs.

Parameters: a (40, 24) and a (7, 5) tensor in bf16 or fp16 and a (100,)
fp32 one among them; a dynamic scaler from 2^16; five steps of
loss-scaled gradients, the third carrying an inf.  ``max_grad_norm``
0.1 clips (unscaled norms ~0.3, so the clip is on the scaled norm
against ``0.1 * scale``); 1.0 does not.  Held at every step: the finite
flag, the count and the scale exactly; the reported unscaled norm 1e-6
relative; the fp32 masters within 1e-6 absolute (values of order 1) and
``m`` within 1e-6 of its largest value; ``v`` within 3e-5 of its
largest value, since JAX's plain form takes ``1 - beta2`` in double and
rounds it once (1e-3) where the port's kernel, as JAX's own kernel,
forms it in fp32 (9.9998713e-4, 1.3e-5 apart); each parameter the cast
of its master (one ulp of its dtype of JAX's; an fp32 one as the
masters).  The overflow step
holds masters, ``m``, ``v``, the parameters and the count bitwise, and
halves the scale.  ``state_dict`` and ``load_state_dict`` round trip
bitwise, and a step from the restored state equals one from the
original.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.amp import scaler as jax_scaler
from apex_tpu.ops import multi_tensor as jmt
from apex_tpu.optimizers import FusedMixedPrecisionLamb as JaxMPLamb
from apex_tpu_torch.amp import scaler
from apex_tpu_torch.optimizers import FusedMixedPrecisionLamb

SHAPES = {"a": (40, 24), "b": (100,), "c": (7, 5)}
KEYS = sorted(SHAPES)
STEPS, INF_STEP = 5, 2
LR = 0.1
JAXD = {"bf16": jnp.bfloat16, "fp16": jnp.float16}
TORCHD = {"bf16": torch.bfloat16, "fp16": torch.float16}


def _dtypes(dt):
    return {k: (jnp.float32 if k == "b" else JAXD[dt]) for k in KEYS}


def _params(dt):
    rng = np.random.RandomState(0)
    return {k: jnp.asarray(rng.randn(*SHAPES[k]).astype(np.float32))
            .astype(d) for k, d in _dtypes(dt).items()}


def _grads(step, dt, scale):
    """Loss-scaled gradients in the parameters' dtypes; an inf in the
    fp32 tensor at ``INF_STEP``."""
    rng = np.random.RandomState(10 + step)
    g = {k: rng.randn(*SHAPES[k]).astype(np.float32) * 0.01 * scale
         for k in KEYS}
    if step == INF_STEP:
        g["b"][3] = np.inf
    return {k: jnp.asarray(v).astype(d)
            for (k, v), d in zip(g.items(), _dtypes(dt).values())}


def _torch(tree):
    """JAX leaves (sorted keys) as torch tensors in their dtypes."""
    out = []
    for k in KEYS:
        x = tree[k]
        t = torch.from_numpy(np.array(x.astype(jnp.float32)))
        out.append(t.to({jnp.dtype(jnp.bfloat16): torch.bfloat16,
                         jnp.dtype(jnp.float16): torch.float16}.get(
                             jnp.dtype(x.dtype), torch.float32)))
    return out


def _jax_leaves(bufs, metas):
    tree = jmt.unpack_groups(bufs, metas,
                             out_dtypes=[jnp.float32] * len(KEYS))
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _hold(ours, want, tol, rel):
    for t, w in zip(ours, want):
        t = t.float().numpy()
        bound = tol * (np.abs(w).max() if rel else 1.0)
        assert np.abs(t - w).max() <= bound, (np.abs(t - w).max(), bound)


def _lowp_close(t, w):
    """One ulp of a low-precision dtype; an fp32 parameter is its
    master, held as the masters are."""
    w = np.asarray(jnp.asarray(w).astype(jnp.float32))
    if t.dtype == torch.float32:
        assert np.abs(t.numpy() - w).max() <= 1e-6
        return
    ulp = 2.0 ** -7 if t.dtype == torch.bfloat16 else 2.0 ** -10
    assert np.all(np.abs(t.float().numpy() - w)
                  <= np.maximum(np.abs(w), 2.0 ** -14) * ulp)


@pytest.mark.parametrize("max_norm", [0.1, 1.0])
@pytest.mark.parametrize("dt", ["bf16", "fp16"])
def test_steps_match_jax(dt, max_norm):
    jopt = JaxMPLamb(LR, max_grad_norm=max_norm,
                     reduced_precision_dtype=JAXD[dt], use_pallas=False)
    opt = FusedMixedPrecisionLamb(LR, max_grad_norm=max_norm)
    pj = _params(dt)
    metas = jmt.compute_metas(pj, align=jmt.LANE)
    sj, scj = jopt.init(pj), jax_scaler.init("dynamic")
    pt = _torch(pj)
    st, sct = opt.init(pt), scaler.init("dynamic")
    assert all(b.dtype == torch.float32 for b in st.masters)
    clipped = False
    for step in range(STEPS):
        g = _grads(step, dt, sct.loss_scale)
        assert float(scj.loss_scale) == sct.loss_scale
        pj, sj, scj, ij = jopt.step(g, sj, pj, scaler_state=scj)
        before = [t.clone() for t in (*pt, *st.masters, *st.m, *st.v)]
        count = st.count
        pt, st, sct, it = opt.step(_torch(g), st, pt, sct)
        assert it.grads_finite == bool(ij.grads_finite) \
            == (step != INF_STEP)
        assert st.count == int(sj.count)
        assert sct.loss_scale == float(scj.loss_scale)
        if not it.grads_finite:
            after = (*pt, *st.masters, *st.m, *st.v)
            assert st.count == count
            assert all(torch.equal(a, b) for a, b in zip(before, after))
            assert sct.loss_scale == 2.0 ** 15
            continue
        norm = float(it.grad_norm)
        assert norm == pytest.approx(float(ij.grad_norm), rel=1e-6)
        clipped |= norm > max_norm
        _hold(st.masters, _jax_leaves(sj.masters, metas), 1e-6, False)
        _hold(st.m, _jax_leaves(sj.m, metas), 1e-6, True)
        _hold(st.v, _jax_leaves(sj.v, metas), 3e-5, True)
        for k, t, m in zip(KEYS, pt, st.masters):
            assert t.dtype == (torch.float32 if k == "b" else TORCHD[dt])
            assert torch.equal(t, m.to(t.dtype))      # cast of the master
            _lowp_close(t, pj[k])
    assert st.count == STEPS - 1
    assert clipped == (max_norm < 0.3)


def test_state_dict_round_trip():
    opt = FusedMixedPrecisionLamb(LR)
    pt = _torch(_params("bf16"))
    st = opt.init(pt)
    pt, st, _, _ = opt.step(_torch(_grads(0, "bf16", 1.0)), st, pt)
    d = opt.state_dict(st)
    restored = opt.load_state_dict(d)
    assert restored.count == st.count == 1
    for a, b in zip((*restored.masters, *restored.m, *restored.v),
                    (*st.masters, *st.m, *st.v)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    # the dict holds copies: a step from either state gives the same
    g = _torch(_grads(1, "bf16", 1.0))
    p1 = [t.clone() for t in pt]
    opt.step(g, st, pt)
    opt.step(g, restored, p1)
    assert all(torch.equal(a, b) for a, b in zip(pt, p1))
    assert all(torch.equal(a, b) for a, b in zip(st.masters,
                                                 restored.masters))
    # numpy buffers load as fp32 tensors
    again = opt.load_state_dict({k: ([b.numpy() for b in v] if k != "count"
                                     else v) for k, v in d.items()})
    assert all(torch.equal(a, b) for a, b in zip(again.v, d["v"]))


def test_eps_must_be_positive():
    with pytest.raises(ValueError, match="eps > 0"):
        FusedMixedPrecisionLamb(eps=0.0)
