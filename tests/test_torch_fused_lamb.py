"""Port parity for FusedLAMB: LAMB phase 1 (``apex_tpu_torch.ops.
lamb_phase1``, the kernel's plain version here) against the JAX
``lamb_phase1`` (its Pallas ``_lamb_phase1_kernel`` in CPU interpret
mode), and the whole pipeline step (``fused_lamb(...).pipeline_step``)
against the JAX ``fused_lamb(...).pipeline_step`` over the same
persistent buffers, on the same numpy inputs.

Phase 1 runs one flat buffer of 4,736 elements (bf16 g, fp32 p, m, v)
in both moment modes: u, m and v within 1e-6 relative to their largest
value (the same fp32 expression, contracted differently; measured
1.5e-7).

The pipeline step runs 4 steps over three tensors (40 x 24, 100 and a
16 x 8 table whose gradient is always zero, as a table the forward
never reads), bf16 model copy, fp32 masters.  JAX packs them at
128-aligned offsets with zero gaps; the port's flat buffers have no
gaps.  Step 1: a static scale, grads whose global norm is above
max_grad_norm (the clip is active; the port measures the norm itself,
as JAX's ``packed_norm``); step 2: the O2 handoff, amp's measured norm
given; step 3: ``finite=False``; step 4: an ordinary step.  Held each
step: masters and moments within 1e-6 absolute (the per-tensor and
global norms are fp32 sums in another order; measured 1.2e-7), the bf16
model copy within one bf16 ulp of the master, the count exact; after
``finite=False`` the port's state bitwise as before and the count held;
the zero-grad table moves by lr * p (trust ratio 1 / wd).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops import fused_pipeline as jax_pipeline
from apex_tpu.ops.fused_optim import lamb_phase1 as jax_lamb_phase1
from apex_tpu.optimizers import fused_lamb as jax_fused_lamb
from apex_tpu_torch.ops import lamb_phase1, lamb_phase1_reference
from apex_tpu_torch.optimizers import fused_lamb

HYP = dict(beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6, weight_decay=0.01,
           bias_correction1=1 - 0.9 ** 3, bias_correction2=1 - 0.999 ** 3)
LR = 1e-3
SHAPES = {"a": (40, 24), "b": (100,), "z": (16, 8)}
TOL = 1e-6


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_phase1_matches_jax(adam_w_mode):
    rng = np.random.RandomState(int(adam_w_mode))
    n = 37 * 128
    g = rng.randn(n).astype(np.float32)
    p, m = rng.randn(n).astype(np.float32), 0.01 * rng.randn(n)
    v = (1e-4 * rng.rand(n)).astype(np.float32)
    m = m.astype(np.float32)
    gj = jnp.asarray(g).astype(jnp.bfloat16)
    uj, mj, vj = jax_lamb_phase1(gj, jnp.asarray(p), jnp.asarray(m),
                                 jnp.asarray(v), grad_scale=0.5,
                                 adam_w_mode=adam_w_mode, interpret=True,
                                 **HYP)
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32))).bfloat16()
    mt, vt = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    ut, m2, v2 = lamb_phase1(gt, torch.from_numpy(p), mt, vt,
                             grad_scale=0.5, adam_w_mode=adam_w_mode, **HYP)
    assert m2 is mt and v2 is vt                  # in place
    for got, want in ((ut, uj), (mt, mj), (vt, vj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TOL * np.abs(want).max())
    # the plain version is what the CPU wrapper runs; a device scalar
    # scale gives the same as a Python one
    u2, _, _ = lamb_phase1_reference(
        gt, torch.from_numpy(p), torch.from_numpy(m.copy()),
        torch.from_numpy(v.copy()), grad_scale=torch.tensor(0.5),
        adam_w_mode=adam_w_mode, **HYP)
    assert torch.equal(u2, ut)


def _flat(tree):
    return np.concatenate([np.ravel(tree[k]) for k in SHAPES])


def _unpack(buf, meta):
    buf = np.asarray(buf)
    return np.concatenate([buf[o:o + n]
                           for o, n in zip(meta.offsets, meta.sizes)])


def test_pipeline_step_matches_jax():
    rng = np.random.RandomState(3)
    masters = {k: rng.randn(*s).astype(np.float32) for k, s in
               SHAPES.items()}
    template = {k: jnp.asarray(v).astype(jnp.bfloat16)
                for k, v in masters.items()}
    metas = jax_pipeline.pipeline_metas(template)
    (meta,) = metas
    pm = jax_pipeline.pack_masters(
        {k: jnp.asarray(v) for k, v in masters.items()}, template)
    jtx = jax_fused_lamb(LR, use_pallas=True)
    jstate = jtx.pipeline_init(metas)
    jbufs = pm.bufs

    tx = fused_lamb(LR)
    p = torch.from_numpy(_flat(masters))
    lowp = p.bfloat16()
    sizes = tuple(int(np.prod(s)) for s in SHAPES.values())
    state = tx.pipeline_init([p], segments=[sizes])

    scale = 2.0 ** 10
    # (grad_scale, measured norm handed over?, finite)
    plan = [(1.0, False, True), (1.0 / scale, True, True),
            (1.0 / scale, True, False), (1.0, False, True)]
    for step, (inv, handoff, finite) in enumerate(plan):
        grads = {k: (rng.randn(*s) * (3.0 / inv) * (0.0 if k == "z"
                                                    else 1.0))
                 .astype(np.float32) for k, s in SHAPES.items()}
        gtree = {k: jnp.asarray(v).astype(jnp.bfloat16)
                 for k, v in grads.items()}
        gbufs = jax_pipeline.pack_grads(gtree, metas)
        gflat = torch.from_numpy(np.array(_unpack(
            gbufs[0].astype(jnp.float32), meta))).bfloat16()
        norm = None
        if handoff:
            norm = float(np.sqrt(np.sum(np.square(
                gflat.double().numpy() * inv))))
            assert norm > 1.0                      # the clip is active
        with jax.default_matmul_precision("highest"):
            jbufs, jstate, jlowp = jtx.pipeline_step(
                gbufs, jstate, jbufs, metas, grad_scale=inv,
                grad_norm=None if norm is None else jnp.float32(norm),
                finite=finite)
        before = [t.clone() for t in (p, lowp, *state.m, *state.v)]
        count = state.count
        state = tx.pipeline_step([gflat], state, [p], [lowp],
                                 grad_scale=inv,
                                 grad_norm=None if norm is None
                                 else torch.tensor(norm), finite=finite)
        if not finite:
            after = (p, lowp, *state.m, *state.v)
            assert all(torch.equal(a, b) for a, b in zip(before, after))
            assert state.count == count
        assert state.count == int(jstate.count)
        for got, want in ((p, jbufs[0]), (state.m[0], jstate.m[0]),
                          (state.v[0], jstate.v[0])):
            np.testing.assert_allclose(got.numpy(), _unpack(want, meta),
                                       rtol=0, atol=TOL)
        np.testing.assert_allclose(
            lowp.float().numpy(),
            _unpack(jlowp[0].astype(jnp.float32), meta), rtol=2.0 ** -8,
            atol=0)
    # the zero-grad table: u = wd * p, ratio 1 / wd, so each applied
    # step took p to (1 - lr) p
    z0 = masters["z"].ravel()
    z = p[-sizes[-1]:].numpy()
    np.testing.assert_allclose(z, z0 * (1 - LR) ** 3, rtol=1e-6)
    assert state.count == 3


def test_eps_must_be_positive_and_no_weight_decay_leaves_ratio_one():
    with pytest.raises(ValueError, match="eps > 0"):
        fused_lamb(1e-3, eps=0.0)
    # weight decay 0 and no nvlamb: phase 2 leaves every tensor
    # un-adapted, so the step is lr * u
    tx = fused_lamb(1e-2, weight_decay=0.0, max_grad_norm=None)
    p = torch.ones(6)
    state = tx.pipeline_init([p], segments=[(2, 4)])
    g = torch.tensor([1.0, -1.0, 2.0, 0.0, 0.0, 0.0])
    tx.pipeline_step([g], state, [p], [None])
    want = 1.0 - 1e-2 * torch.sign(g) / (1 + 1e-6 / g.abs().clamp(1e-30))
    torch.testing.assert_close(p, want, rtol=0, atol=1e-6)
