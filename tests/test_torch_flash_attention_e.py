"""Port parity: ``apex_tpu_torch.ops.flash_attention_e`` — forward and
backward over the projection-native (b, s, h, 3d) layout — against the
JAX package's ``flash_attention_e`` and its ``jax.grad`` (the Pallas
``_flash_fwd_e`` / ``_flash_bwd_e`` in CPU interpret mode), on the same
numpy inputs.  h = 2, d = 64: s = 64 pads to 128 in the JAX kernels
(the kpad case), s = 128 does not.

Tolerances: fp32 output 2e-5 and dqkv 1e-4 (fp32 softmax and products
in another order, and the JAX kernels' exp2 of pre-scaled logits);
bf16 output 2e-2 (the JAX kernel rounds p to bf16 before the PV
product, the port keeps it fp32: a few bf16 ulps of |o| < 1).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.flash_attention import \
    flash_attention_e as jax_flash_attention_e
from apex_tpu_torch.ops import (flash_attention_e,
                                flash_attention_e_backward_reference,
                                flash_attention_e_reference)

B, H, D = 2, 2, 64
F32_O_TOL = 2e-5
F32_GRAD_TOL = 1e-4
BF16_TOL = 2e-2


def _inputs(s, seed):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, s, H, 3 * D).astype(np.float32)
    do = rng.randn(B, s, H * D).astype(np.float32)
    return qkv, do


@pytest.mark.parametrize("s,causal", [(64, True), (128, True),
                                      (64, False)])
def test_forward_and_grad_match_jax(s, causal):
    qkv, do = _inputs(s, seed=s + int(causal))
    with jax.default_matmul_precision("highest"):
        o_j, vjp = jax.vjp(lambda t: jax_flash_attention_e(
            t, scale=D ** -0.5, causal=causal), jnp.asarray(qkv))
        dqkv_j, = vjp(jnp.asarray(do))
    qt = torch.from_numpy(qkv).requires_grad_(True)
    o_t = flash_attention_e(qt, causal=causal)
    o_t.backward(torch.from_numpy(do))
    assert o_t.shape == (B, s, H * D)
    assert qt.grad.shape == qkv.shape          # one dqkv, qkv's lanes
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j),
                               rtol=F32_O_TOL, atol=F32_O_TOL)
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(dqkv_j),
                               rtol=F32_GRAD_TOL, atol=F32_GRAD_TOL)


def test_bf16_forward_matches_jax():
    qkv, _ = _inputs(128, seed=3)
    qj = jnp.asarray(qkv).astype(jnp.bfloat16)
    want = np.asarray(jax_flash_attention_e(qj, causal=True)
                      .astype(jnp.float32))
    qt = torch.from_numpy(np.array(qj.astype(jnp.float32))).bfloat16()
    got = flash_attention_e(qt, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_backward_reference_equals_autograd_of_plain_version():
    # the explicit backward (p from lse, delta = rowsum(do * o)) is the
    # derivative of mha_reference on the split views (both compute in
    # fp32: 1e-5)
    from apex_tpu_torch.ops import flash_attention_with_lse

    qkv, do = (torch.from_numpy(a) for a in _inputs(40, seed=5))
    qr = qkv.clone().requires_grad_(True)
    flash_attention_e_reference(qr, causal=True).backward(do)
    q, k, v = (t.transpose(1, 2) for t in qkv.split(D, dim=-1))
    o, lse = flash_attention_with_lse(q, k, v, causal=True)
    got = flash_attention_e_backward_reference(
        qkv, o.transpose(1, 2), lse, do.reshape(B, 40, H, D), causal=True)
    np.testing.assert_allclose(got.numpy(), qr.grad.numpy(), rtol=1e-5,
                               atol=1e-5)
