"""Port parity for ``apex_tpu_torch.ops.flash_attention_partial`` (the
offsets, lse-cotangent and coordinate-hash dropout lanes of rows 6 and
8) against the JAX package's ``flash_attention_partial`` (``_flash_fwd``
and ``_flash_bwd`` with ``offsets``, ``dlse`` and ``dsalt``, Pallas in
CPU interpret mode, head-packed at d = 64 with even h), on the same
numpy inputs, fp32, the JAX side's matmuls at HIGHEST precision.  On the
CPU the port runs the plain versions: ``mha_reference`` with the
offsets, and the backward's plain version with ``dlse``.

* o and lse, and dq, dk, dv under JAX's own test loss ``sum(o**2) +
  sum(sin(lse))`` (so the lse cotangent is nonzero), causal at offsets
  that cut inside a block, show every key, or hide every key (a wholly
  future block: o = 0 and lse JAX's finite -1e30 * scale, bitwise), at
  sq != sk and d = 128; full attention, where the offsets must not act.
* ``rand_keep_global`` bit for bit against JAX's at several batch,
  head, q and k offsets; the partial at dropout 0.3 with head_offset 4
  against JAX's o and gradients.
* ``bench_ring_flash``'s substep (the partial at q_offset = s, the
  logaddexp merge onto o = 0, lse = -1e30) at s = 128.
* Non-vacuity: dropping the lse cotangent moves the gradients far past
  the tolerance.

Tolerances: o and lse 2e-5, gradients 1e-4 (fp32 sums in another order,
the JAX kernels' exp2 of pre-scaled logits; as
``test_torch_flash_attention_e_dropout.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.flash_attention import \
    flash_attention_partial as jax_partial
from apex_tpu.ops.flash_attention import rand_keep_global as jax_keep_global
from apex_tpu_torch.ops import (flash_attention_backward_reference,
                                flash_attention_partial,
                                flash_attention_partial_reference,
                                launch_counts, mha_reference,
                                rand_keep_global, reset_launch_counts)

O_TOL = 2e-5
GRAD_TOL = 1e-4


def _inputs(b, h, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k, v = (rng.randn(b, h, sk, d).astype(np.float32) for _ in range(2))
    return q, k, v


def _loss_jax(o, lse):
    return jnp.sum(o ** 2) + jnp.sum(jnp.sin(lse))


def _loss_torch(o, lse):
    return (o ** 2).sum() + torch.sin(lse).sum()


def _run(q, k, v, **kw):
    """JAX's and the port's (o, lse) and (dq, dk, dv) under the loss."""
    with jax.default_matmul_precision("highest"):
        (o_j, lse_j), vjp = jax.vjp(
            lambda q, k, v: jax_partial(q, k, v, **kw),
            *map(jnp.asarray, (q, k, v)))
        ct = jax.grad(_loss_jax, argnums=(0, 1))(o_j, lse_j)
        grads_j = vjp(ct)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o, lse = flash_attention_partial(*ts, **kw)
    _loss_torch(o, lse).backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j),
                               rtol=O_TOL, atol=O_TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(lse_j),
                               rtol=O_TOL, atol=O_TOL)
    for t, g in zip(ts, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
    return o.detach(), lse.detach(), [t.grad for t in ts]


@pytest.mark.parametrize("sq,sk,d,q_off,k_off", [
    (128, 128, 64, 128, 0),      # every key visible (the ring's past block)
    (128, 128, 64, 64, 0),       # the mask cuts inside the block
    (128, 128, 64, 0, 64),       # the first 64 rows see no key
    (128, 256, 64, 200, 100),    # sq != sk, cut
    (192, 128, 128, 16, 80),     # d = 128, sq != sk, dead rows then cut
])
def test_causal_offsets_match_jax(sq, sk, d, q_off, k_off):
    q, k, v = _inputs(1, 2, sq, sk, d, seed=sq + sk + q_off)
    o, lse, grads = _run(q, k, v, causal=True, q_offset=q_off,
                         k_offset=k_off)
    dead = torch.arange(sq) + q_off < k_off
    assert (o[:, :, dead] == 0).all()
    assert torch.isfinite(lse).all()
    for g in grads:
        assert torch.isfinite(g).all()


def test_wholly_future_block_is_dead_as_in_jax():
    s, d = 128, 64
    q, k, v = _inputs(1, 2, s, s, d, seed=7)
    o, lse, grads = _run(q, k, v, causal=True, q_offset=0, k_offset=s)
    assert (o == 0).all()
    # JAX's finite -1e30 * scale, bitwise, not -inf
    dead = np.float32(-1e30) * np.float32(d ** -0.5)
    assert (lse == torch.tensor(dead)).all() and float(lse.max()) < -1e28
    for g in grads:
        assert (g == 0).all()


@pytest.mark.parametrize("q_off,k_off", [(0, 0), (37, 500)])
def test_full_attention_ignores_the_offsets(q_off, k_off):
    q, k, v = _inputs(1, 2, 96, 160, 64, seed=11)
    o, lse, _ = _run(q, k, v, causal=False, q_offset=q_off, k_offset=k_off)
    o_r, lse_r = mha_reference(*map(torch.from_numpy, (q, k, v)),
                               return_lse=True)
    torch.testing.assert_close(o, o_r, rtol=0, atol=1e-6)
    torch.testing.assert_close(lse, lse_r, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,seed,rate,offs", [
    ((2, 3, 64, 96), 1234, 0.3, (0, 0, 0, 0)),
    ((2, 3, 64, 96), 2 ** 31 - 2, 0.1, (1, 4, 128, 0)),
    ((1, 2, 48, 80), 77, 0.5, (3, 14, 8192, 4096)),
])
def test_rand_keep_global_matches_jax(shape, seed, rate, offs):
    bo, ho, qo, ko = offs
    want = np.asarray(jax_keep_global(shape, seed, rate, batch_offset=bo,
                                      head_offset=ho, q_offset=qo,
                                      k_offset=ko))
    got = rand_keep_global(shape, seed, rate, batch_offset=bo,
                           head_offset=ho, q_offset=qo, k_offset=ko)
    assert got.dtype == torch.bool and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert abs(float(got.float().mean()) - (1 - rate)) < 0.03


@pytest.mark.parametrize("causal,q_off,k_off", [(True, 128, 0),
                                                (True, 64, 0),
                                                (False, 256, 128)])
def test_dropout_with_head_offset_matches_jax(causal, q_off, k_off):
    s, rate, seed = 128, 0.3, 4321
    q, k, v = _inputs(1, 2, s, s, 64, seed=8)
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off,
              dropout_rate=rate, dropout_seed=seed, head_offset=4)
    o, lse, _ = _run(q, k, v, **kw)
    # dropout took effect on o, not on lse
    o0, lse0 = flash_attention_partial(*map(torch.from_numpy, (q, k, v)),
                                       causal=causal, q_offset=q_off,
                                       k_offset=k_off)
    assert float((o - o0).abs().max()) > 1e-2
    torch.testing.assert_close(lse, lse0, rtol=0, atol=0)


def _merge(o, lse, bo, blse):
    """bench_ring_flash's logaddexp merge of a partial onto (o, lse)."""
    lse_new = torch.logaddexp(lse, blse)
    return (o * torch.exp(lse - lse_new)[..., None]
            + bo.float() * torch.exp(blse - lse_new)[..., None]), lse_new


def test_ring_substep_merge_matches_jax():
    b, h, s, d = 1, 2, 128, 64
    q, k, v = _inputs(b, h, s, s, d, seed=3)
    o0 = np.zeros((b, h, s, d), np.float32)
    lse0 = np.full((b, h, s), -1e30, np.float32)

    def loss_j(q, k, v):
        bo, blse = jax_partial(q, k, v, causal=True, q_offset=s, k_offset=0)
        lse_new = jnp.logaddexp(lse0, blse)
        o = (o0 * jnp.exp(lse0 - lse_new)[..., None]
             + bo * jnp.exp(blse - lse_new)[..., None])
        return jnp.sum(o ** 2) + 0.0 * jnp.sum(lse_new)

    with jax.default_matmul_precision("highest"):
        val_j, grads_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    bo, blse = flash_attention_partial(*ts, causal=True, q_offset=s,
                                       k_offset=0)
    o2, lse2 = _merge(torch.from_numpy(o0), torch.from_numpy(lse0), bo,
                      blse)
    loss = (o2 ** 2).sum() + 0.0 * lse2.sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(val_j), rtol=1e-5)
    for t, g in zip(ts, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
    # the merge onto the empty carry returns the partial unchanged
    torch.testing.assert_close(o2.detach(), bo.detach(), rtol=0, atol=0)
    # a wholly future partial merged in changes nothing
    fo, flse = flash_attention_partial(*map(torch.from_numpy, (q, k, v)),
                                       causal=True, q_offset=0, k_offset=s)
    o3, lse3 = _merge(o2.detach(), lse2.detach(), fo, flse)
    assert torch.isfinite(o3).all() and torch.isfinite(lse3).all()
    torch.testing.assert_close(o3, o2.detach(), rtol=0, atol=0)
    torch.testing.assert_close(lse3, lse2.detach(), rtol=0, atol=0)


def test_lse_cotangent_matters():
    # non-vacuity: at these inputs the gradients without the lse
    # cotangent sit far outside the tolerance of the ones with it
    q, k, v = map(torch.from_numpy, _inputs(1, 2, 128, 128, 64, seed=5))
    o, lse = flash_attention_partial(q, k, v, causal=True, q_offset=64,
                                     k_offset=0)
    do, dlse = 2 * o, torch.cos(lse)
    with_dlse = flash_attention_backward_reference(
        q, k, v, o, lse, do, causal=True, q_offset=64, dlse=dlse)
    without = flash_attention_backward_reference(q, k, v, o, lse, do,
                                                 causal=True, q_offset=64)
    gap = max(float((a - b).abs().max()) for a, b in zip(with_dlse, without))
    assert gap > 100 * GRAD_TOL


def test_plain_version_is_autograd_of_the_partial_reference():
    # the backward's plain version (with dlse) equals autograd through
    # the plain forward, dead rows and dropout included
    q, k, v = _inputs(1, 2, 64, 96, 64, seed=12)
    kw = dict(causal=True, q_offset=10, k_offset=40, dropout_rate=0.2,
              dropout_seed=9, head_offset=2)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    refs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    _loss_torch(*flash_attention_partial(*ts, **kw)).backward()
    _loss_torch(*flash_attention_partial_reference(*refs, **kw)).backward()
    for t, r in zip(ts, refs):
        torch.testing.assert_close(t.grad, r.grad, rtol=1e-5, atol=1e-5)


def test_arguments_and_no_launch_on_cpu():
    q, k, v = map(torch.from_numpy, _inputs(1, 2, 32, 32, 64, seed=1))
    with pytest.raises(ValueError, match="requires dropout_seed"):
        flash_attention_partial(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError, match="head_offset"):
        flash_attention_partial(q, k, v, dropout_rate=0.1, dropout_seed=1,
                                head_offset=-1)
    reset_launch_counts()
    o, lse = flash_attention_partial(q, k, v, causal=True, q_offset=5)
    assert not any(launch_counts().values())
    # rate 0 is the dropout-free call, bitwise
    o1, lse1 = flash_attention_partial(q, k, v, causal=True, q_offset=5,
                                       dropout_rate=0.0, dropout_seed=3)
    assert torch.equal(o, o1) and torch.equal(lse, lse1)
