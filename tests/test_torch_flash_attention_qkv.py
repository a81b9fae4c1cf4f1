"""Port parity for rows 7 and 9: ``apex_tpu_torch.ops.flash_attention_qkv``
(the row-6/8 kernels launched on the three views of a packed (3, b, h,
s, d) qkv, one dqkv written back) under autograd against the JAX
package's ``flash_attention_qkv`` (``_flash_fwd_packed`` and
``_flash_bwd_packed``, with and without ``kv_mask``, Pallas in CPU
interpret mode), on the same numpy inputs, fp32, the JAX side's matmuls
at HIGHEST precision; and against the port's own ``flash_attention`` on
``qkv[0]``, ``qkv[1]``, ``qkv[2]``, which must agree bitwise (the same
kernels, here their plain versions).

Cases: causal and full, with and without a (b, s) kv_mask holding an
all-pad row (o = 0 and zero gradients there), s 128 and 200 (not a
multiple of 128: JAX pads to its block grain), d 64 and 128.
Tolerances: o 2e-5, dqkv 1e-4 (as ``test_torch_flash_attention_e.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.flash_attention import flash_attention_qkv as jax_qkv
from apex_tpu_torch.ops import (flash_attention, flash_attention_qkv,
                                flash_attention_qkv_reference)

O_TOL = 2e-5
GRAD_TOL = 1e-4


def _inputs(b, h, s, d, seed, masked):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(3, b, h, s, d).astype(np.float32)
    do = rng.randn(b, h, s, d).astype(np.float32)
    kv = None
    if masked:
        kv = np.zeros((b, s), np.float32)
        kv[0] = 1.0
        kv[1, :s // 3] = 1.0
    return qkv, do, kv


@pytest.mark.parametrize("s,d,causal,masked", [
    (128, 64, True, False), (128, 64, False, False),
    (200, 64, True, True), (128, 64, False, True),
    (128, 128, True, False)])
def test_qkv_matches_jax_and_the_split_entry(s, d, causal, masked):
    b, h = 3, 2
    qkv, do, kv = _inputs(b, h, s, d, seed=s + d + causal, masked=masked)
    jm = None if kv is None else jnp.asarray(kv)
    tm = None if kv is None else torch.from_numpy(kv)
    with jax.default_matmul_precision("highest"):
        o_j, vjp = jax.vjp(lambda t: jax_qkv(t, causal=causal, kv_mask=jm),
                           jnp.asarray(qkv))
        dqkv_j, = vjp(jnp.asarray(do))
    qt = torch.from_numpy(qkv).requires_grad_(True)
    o = flash_attention_qkv(qt, causal=causal, kv_mask=tm)
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j),
                               rtol=O_TOL, atol=O_TOL)
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(dqkv_j),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    assert qt.grad.shape == qkv.shape
    # the split entry on the three views: bitwise the same
    parts = [torch.from_numpy(qkv[i].copy()).requires_grad_(True)
             for i in range(3)]
    o_s = flash_attention(*parts, causal=causal, kv_mask=tm)
    o_s.backward(torch.from_numpy(do))
    assert torch.equal(o.detach(), o_s.detach())
    for i, t in enumerate(parts):
        assert torch.equal(qt.grad[i], t.grad)
    if masked:
        assert (o[-1] == 0).all() and (qt.grad[:, -1] == 0).all()


def test_reference_and_shape_check():
    qkv, do, kv = _inputs(2, 2, 64, 64, seed=1, masked=True)
    qt = torch.from_numpy(qkv)
    torch.testing.assert_close(
        flash_attention_qkv(qt, causal=True, kv_mask=torch.from_numpy(kv)),
        flash_attention_qkv_reference(qt, causal=True,
                                      kv_mask=torch.from_numpy(kv)),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="3, b, h, s, d"):
        flash_attention_qkv(qt[:2])
