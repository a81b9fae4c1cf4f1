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

The kv_mask lane (rows 10 and 12 with ``kv_mask``) takes a (3, s) mask:
batch row 0 full, row 1 padded past a seeded length, row 2 all pad, at
s = 64 and 128, causal and not, fp32, under the same tolerances
(measured 6.6e-7 on o and 9.5e-7 on dqkv).  The all-pad row gives o = 0
and dqkv = 0 exactly on both sides; a masked key gets dk = dv = 0.
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


def _masked_inputs(s, seed):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(3, s, H, 3 * D).astype(np.float32)
    do = rng.randn(3, s, H * D).astype(np.float32)
    kv = np.zeros((3, s), np.float32)
    kv[0] = 1.0
    kv[1, :rng.randint(s // 4, s - 1)] = 1.0      # row 2 stays all pad
    return qkv, do, kv


@pytest.mark.parametrize("s,causal", [(64, False), (64, True),
                                      (128, False), (128, True)])
def test_kv_mask_forward_and_grad_match_jax(s, causal):
    qkv, do, kv = _masked_inputs(s, seed=10 * s + int(causal))
    with jax.default_matmul_precision("highest"):
        o_j, vjp = jax.vjp(lambda t: jax_flash_attention_e(
            t, scale=D ** -0.5, causal=causal, kv_mask=jnp.asarray(kv)),
            jnp.asarray(qkv))
        dqkv_j, = vjp(jnp.asarray(do))
    qt = torch.from_numpy(qkv).requires_grad_(True)
    kvt = torch.from_numpy(kv)
    o_t = flash_attention_e(qt, causal=causal, kv_mask=kvt)
    o_t.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j),
                               rtol=F32_O_TOL, atol=F32_O_TOL)
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(dqkv_j),
                               rtol=F32_GRAD_TOL, atol=F32_GRAD_TOL)
    # the all-pad batch row attends nothing: exact zeros, no NaN
    assert (o_t[2] == 0).all() and (np.asarray(o_j)[2] == 0).all()
    assert (qt.grad[2] == 0).all()
    assert torch.isfinite(qt.grad).all()
    # a masked key of a live row gets no dk, dv
    pad = kv[1] == 0
    assert (qt.grad[1][torch.from_numpy(pad)][..., D:] == 0).all()
    # the mask takes no gradient and the plain version is the same math
    ref = flash_attention_e_reference(qt.detach(), causal=causal,
                                      kv_mask=kvt)
    np.testing.assert_allclose(ref.numpy(), o_t.detach().numpy(), rtol=0,
                               atol=1e-6)


def test_kv_mask_backward_reference_equals_autograd_of_plain_version():
    # p is masked before the exponential of the -inf lse of a dead row
    from apex_tpu_torch.ops import flash_attention_e_with_lse

    qkv, do, kv = (torch.from_numpy(a) for a in _masked_inputs(40, seed=6))
    for causal in (False, True):
        qr = qkv.clone().requires_grad_(True)
        flash_attention_e_reference(qr, causal=causal,
                                    kv_mask=kv).backward(do)
        o, lse = flash_attention_e_with_lse(qkv, causal=causal, kv_mask=kv)
        assert torch.isinf(lse[2]).all() and (lse[2] < 0).all()
        got = flash_attention_e_backward_reference(
            qkv, o.view(3, 40, H, D), lse, do.view(3, 40, H, D),
            causal=causal, kv_mask=kv)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), qr.grad.numpy(), rtol=1e-5,
                                   atol=1e-5)
