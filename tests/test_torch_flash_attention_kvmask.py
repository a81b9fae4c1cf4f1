"""Port parity for the kv_mask lane of rows 6 and 8 on the (b, h, s, d)
entry: ``apex_tpu_torch.ops.flash_attention(..., kv_mask=)`` under
autograd against the JAX package's ``flash_attention(..., kv_mask=)``
(its ``_flash_attention_masked`` custom VJP: ``_flash_fwd`` and
``_flash_bwd`` with ``kv_mask``, Pallas in CPU interpret mode), on the
same numpy inputs, fp32, the JAX side's matmuls at HIGHEST precision.

Cases: sq != sk (encoder-decoder attention: queries against a padded
source), full and causal, d 64 and 128, with one batch row all padding:
it attends nothing, so o = 0 there (as JAX's kernel gives) and its
gradients are 0.  Tolerances: o 2e-5, gradients 1e-4 (as
``test_torch_flash_attention_partial.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.flash_attention import flash_attention as jax_flash
from apex_tpu_torch.ops import (flash_attention, flash_attention_backward,
                                flash_attention_backward_reference,
                                flash_attention_with_lse, launch_counts,
                                mha_reference, reset_launch_counts)

O_TOL = 2e-5
GRAD_TOL = 1e-4


def _inputs(b, h, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k, v = (rng.randn(b, h, sk, d).astype(np.float32) for _ in range(2))
    do = rng.randn(b, h, sq, d).astype(np.float32)
    kv = np.zeros((b, sk), np.float32)
    kv[0] = 1.0                                   # no padding
    for r in range(1, b - 1):                     # padded past a length
        kv[r, :rng.randint(sk // 4, sk - 1)] = 1.0
    return q, k, v, do, kv                        # the last row all pad


@pytest.mark.parametrize("sq,sk,d,causal", [
    (96, 160, 64, False), (160, 96, 64, False), (128, 256, 64, True),
    (64, 192, 128, False)])
def test_kv_mask_matches_jax(sq, sk, d, causal):
    b, h = 3, 2
    q, k, v, do, kv = _inputs(b, h, sq, sk, d, seed=sq + sk + d)
    with jax.default_matmul_precision("highest"):
        o_j, vjp = jax.vjp(lambda q, k, v: jax_flash(
            q, k, v, causal=causal, kv_mask=jnp.asarray(kv)),
            *map(jnp.asarray, (q, k, v)))
        grads_j = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = flash_attention(*ts, causal=causal, kv_mask=torch.from_numpy(kv))
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j),
                               rtol=O_TOL, atol=O_TOL)
    for t, g in zip(ts, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
    # the all-pad row: exact zeros forward and back, as JAX's kernel
    assert (o[-1] == 0).all() and (np.asarray(o_j)[-1] == 0).all()
    for t in ts:
        assert torch.isfinite(t.grad).all() and (t.grad[-1] == 0).all()
    # a padded key of a live row takes no dk, dv
    pad = torch.from_numpy(kv[1] == 0)
    assert (ts[1].grad[1][:, pad] == 0).all()
    assert (ts[2].grad[1][:, pad] == 0).all()


def test_cpu_wrappers_are_the_plain_versions():
    q, k, v, do, kv = map(torch.from_numpy, _inputs(3, 2, 40, 56, 64, 9))
    reset_launch_counts()
    o, lse = flash_attention_with_lse(q, k, v, kv_mask=kv)
    o_r, lse_r = mha_reference(q, k, v, return_lse=True, kv_mask=kv)
    assert torch.equal(o, o_r) and torch.equal(lse, lse_r)
    assert lse[-1].eq(-float("inf")).all()      # the dead row, -inf here
    got = flash_attention_backward(q, k, v, o, lse, do, kv_mask=kv)
    want = flash_attention_backward_reference(q, k, v, o, lse, do,
                                              kv_mask=kv)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not any(launch_counts().values())


def test_all_ones_mask_is_the_unmasked_call():
    q, k, v, do, _ = map(torch.from_numpy, _inputs(2, 2, 48, 80, 64, 4))
    ones = torch.ones(2, 80)
    torch.testing.assert_close(flash_attention(q, k, v, kv_mask=ones),
                               flash_attention(q, k, v), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="kv_mask"):
        flash_attention(q, k, v, kv_mask=torch.ones(2, 79)).sum()
