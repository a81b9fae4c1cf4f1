"""Port parity for row 8: ``apex_tpu_torch.ops.flash_attention`` under
autograd (its ``FlashAttentionFunction``, whose backward on a CPU tensor
is ``flash_attention_backward_reference``, the row-8 kernel's plain
version) against ``jax.grad`` of the JAX package's ``flash_attention``
(its custom VJP: ``_flash_fwd`` and ``_flash_bwd``, Pallas in CPU
interpret mode, head-packed at d = 64 with even h), on the same numpy
inputs, fp32, with the JAX side's matmuls at HIGHEST precision.

Cases: (b, h, sq, sk, d) = (1, 2, 128, 128, 64) causal and full; sq !=
sk at (1, 2, 96, 160, 64) and (1, 2, 160, 96, 64), full and causal
(causal is top-left aligned: key j is visible to query i iff j <= i);
d = 128 at (1, 2, 128, 128, 128) causal.

Tolerances: o 1e-5 (``tests/test_torch_flash_attention.py``'s); dq,
dk, dv 5e-5 absolute on gradients up to ~4 in magnitude (fp32 products
summed in another order, the JAX kernels' exp2 of pre-scaled logits;
measured at most 2.7e-6).  JAX's backward rounds ``scale`` to v's dtype
before folding it into v; the port does not follow that rounding, it
uses the forward's fp32 scale.  In fp32 the rounding moves 1/sqrt(128)
by under 2^-24 relative, far inside these tolerances; in bf16 it would
move dq and dk by 1.07e-4 relative at d = 128 (at d = 64 the scale 1/8
is exact).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.flash_attention import flash_attention as jax_flash
from apex_tpu_torch.ops import (flash_attention, flash_attention_backward,
                                flash_attention_backward_reference,
                                flash_attention_with_lse, mha_reference)

O_TOL = 1e-5
GRAD_TOL = 5e-5


def _inputs(b, h, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32)
               for s in (sq, sk, sk))
    do = rng.randn(b, h, sq, d).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("sq,sk,d,causal", [
    (128, 128, 64, True), (128, 128, 64, False),
    (96, 160, 64, False), (96, 160, 64, True),
    (160, 96, 64, True), (128, 128, 128, True)])
def test_forward_and_grads_match_jax(sq, sk, d, causal):
    q, k, v, do = _inputs(1, 2, sq, sk, d, seed=sq + sk + d + causal)
    with jax.default_matmul_precision("highest"):
        o_j, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v,
                                                     causal=causal),
                           *map(jnp.asarray, (q, k, v)))
        grads_j = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = flash_attention(*ts, causal=causal)
    assert o.grad_fn is not None
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j),
                               rtol=O_TOL, atol=O_TOL)
    for t, g in zip(ts, grads_j):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_bench_loss_grads_equal_the_plain_backward():
    # bench.py's long-context substep: loss sum(o.float() ** 2) under
    # autograd; the gradients are the backward's plain version on the
    # forward's (o, lse) and do = 2 o, and autograd of the plain forward
    q, k, v, _ = _inputs(1, 2, 72, 72, 128, seed=4)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o, lse = flash_attention_with_lse(*ts, causal=True)
    (o.float() ** 2).sum().backward()
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    want = flash_attention_backward_reference(qt, kt, vt, o.detach(), lse,
                                              2 * o.detach(), causal=True)
    for t, w in zip(ts, want):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=1e-6)
    refs = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
    (mha_reference(*refs, causal=True) ** 2).sum().backward()
    # (fp32 sums in another order: 1e-5 of gradients up to ~8)
    for t, r in zip(ts, refs):
        torch.testing.assert_close(t.grad, r.grad, rtol=1e-5, atol=1e-5)


def test_cpu_backward_wrapper_is_the_plain_version():
    q, k, v, do = map(torch.from_numpy, _inputs(1, 2, 40, 56, 64, seed=9))
    o, lse = mha_reference(q, k, v, causal=True, return_lse=True)
    got = flash_attention_backward(q, k, v, o, lse, do, causal=True)
    want = flash_attention_backward_reference(q, k, v, o, lse, do,
                                              causal=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_lse_takes_no_gradient():
    # the lse cotangent (JAX's flash_attention_partial) is not ported:
    # a loss through lse raises rather than drop its gradient
    q, k, v, _ = _inputs(1, 2, 16, 16, 64, seed=5)
    qt = torch.from_numpy(q).requires_grad_(True)
    o, lse = flash_attention_with_lse(qt, *map(torch.from_numpy, (k, v)))
    with pytest.raises(NotImplementedError, match="lse"):
        lse.sum().backward()
