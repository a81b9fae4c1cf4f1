"""Port parity: ``apex_tpu_torch.ops.layer_norm`` against the JAX
package's ``layer_norm`` (its Pallas ``_ln_forward`` run in CPU
interpret mode), on the same numpy inputs.

Tolerances: fp32 1e-5 (the same two-pass fp32 statistics, summed in
another order); bf16 output 3e-2, one bf16 ulp at |y| ~ 4 (both sides
round the same fp32 value once, so they differ only where the fp32
values straddle a rounding boundary).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.ops.layer_norm import _ln_forward
from apex_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from apex_tpu_torch.ops import layer_norm, layer_norm_with_stats
from apex_tpu_torch.ops.layer_norm import layer_norm_reference

F32_TOL = 1e-5
BF16_TOL = 3e-2


def _inputs(rows, hidden, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, hidden) * 3 + 1).astype(np.float32)
    g = rng.randn(hidden).astype(np.float32)
    b = rng.randn(hidden).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("rows,hidden", [(6, 128), (37, 1024)])
def test_fp32_matches_jax(rows, hidden):
    x, g, b = _inputs(rows, hidden)
    want = np.asarray(jax_layer_norm(jnp.asarray(x), jnp.asarray(g),
                                     jnp.asarray(b)))
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                     torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_mixed_bf16_x_fp32_affine_matches_jax():
    x, g, b = _inputs(24, 256, seed=1)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = jax_layer_norm(xj, jnp.asarray(g), jnp.asarray(b))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    got = layer_norm(xt, torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_stats_match_jax_kernel_outputs():
    # the kernel's second and third outputs: fp32 per-row mean and rstd
    x, g, b = _inputs(19, 384, seed=2)
    yj, mj, rj = _ln_forward(jnp.asarray(x), jnp.asarray(g),
                             jnp.asarray(b), 1e-5)
    y, m, r = layer_norm_with_stats(torch.from_numpy(x),
                                    torch.from_numpy(g),
                                    torch.from_numpy(b), 1e-5)
    assert m.dtype == r.dtype == torch.float32 and m.shape == (19,)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(mj)[:, 0],
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(r.numpy(), np.asarray(rj)[:, 0],
                               rtol=F32_TOL, atol=F32_TOL)


def test_no_affine_and_3d_input():
    x, _, _ = _inputs(10, 128, seed=3)
    x3 = x.reshape(2, 5, 128)
    want = np.asarray(jax_layer_norm(jnp.asarray(x3), None, None))
    got = layer_norm(torch.from_numpy(x3), None, None).numpy()
    assert got.shape == (2, 5, 128)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_cpu_wrapper_is_the_plain_version():
    x, g, b = _inputs(4, 64, seed=4)
    args = [torch.from_numpy(a) for a in (x, g, b)]
    assert torch.equal(layer_norm(*args), layer_norm_reference(*args))


# --- backward: FusedLayerNormFunction against jax.grad -----------------
#
# Tolerances: fp32 dx 1e-5, dgamma/dbeta 1e-4 absolute (sums over up to
# 37 rows of O(1) terms, reassociated); bf16 (x, dy and gamma bf16, the
# O5 case) 3e-2 relative: each side rounds one fp32 value to bf16 once,
# so they differ by at most about one bf16 ulp (2^-8 relative) where the
# fp32 values straddle a rounding boundary.

def _grads_jax(x, g, b, dy):
    import jax

    _, vjp = jax.vjp(lambda x_, g_, b_: jax_layer_norm(x_, g_, b_),
                     x, g, b)
    return vjp(dy)


def _grads_port(x, g, b, dy):
    from apex_tpu_torch.ops import fused_layer_norm

    xt, gt, bt = (t.clone().requires_grad_(True) for t in (x, g, b))
    fused_layer_norm(xt, gt, bt).backward(dy)
    return xt.grad, gt.grad, bt.grad


@pytest.mark.parametrize("rows,hidden", [(6, 128), (37, 1024)])
def test_backward_fp32_matches_jax_grad(rows, hidden):
    x, g, b = _inputs(rows, hidden, seed=5)
    dy = np.random.RandomState(6).randn(rows, hidden).astype(np.float32)
    want = _grads_jax(*(jnp.asarray(a) for a in (x, g, b, dy)))
    got = _grads_port(*(torch.from_numpy(a) for a in (x, g, b, dy)))
    for w, t, tol in zip(want, got, (F32_TOL, 1e-4, 1e-4)):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("gamma_dtype", ["bfloat16", "float32"])
def test_backward_bf16_matches_jax_grad(gamma_dtype):
    # bf16 x and dy; gamma bf16 (O5 casts LayerNorm params too) or fp32
    # (the mixed variant); dgamma/dbeta come back in gamma's dtype
    x, g, b = _inputs(24, 256, seed=7)
    dy = np.random.RandomState(8).randn(24, 256).astype(np.float32)
    jx, jdy = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, dy))
    jg, jb = (jnp.asarray(a).astype(gamma_dtype) for a in (g, b))
    want = _grads_jax(jx, jg, jb, jdy)
    tdt = getattr(torch, gamma_dtype)

    def t(a, dt):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dt)

    got = _grads_port(t(jx, torch.bfloat16), t(jg, tdt), t(jb, tdt),
                      t(jdy, torch.bfloat16))
    for w, gt, dt in zip(want, got, (torch.bfloat16, tdt, tdt)):
        assert gt.dtype == dt
        wf = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(gt.float().numpy(), wf,
                                   rtol=BF16_TOL, atol=BF16_TOL
                                   * max(1.0, float(np.abs(wf).max())))


def test_backward_reference_equals_autograd_of_plain_version():
    # the backward's plain version is the derivative of the forward's
    from apex_tpu_torch.ops import (layer_norm_backward_reference,
                                    layer_norm_stats_reference)

    x, g, b = (torch.from_numpy(a).double()
               for a in _inputs(9, 64, seed=9))
    dy = torch.from_numpy(np.random.RandomState(10).randn(9, 64))
    xr, gr, br = (t.clone().requires_grad_(True) for t in (x, g, b))
    layer_norm_reference(xr, gr, br).backward(dy)
    _, mean, rstd = layer_norm_stats_reference(x, g, b)
    dx, dg, db = layer_norm_backward_reference(x, g, dy, mean, rstd)
    for got, want in ((dx, xr.grad), (dg, gr.grad), (db, br.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)


# --- the grad routing of `layer_norm` ----------------------------------
#
# `layer_norm` decides on the tensors' flags alone, before the device
# dispatch: with autograd recording and x, gamma or beta requiring grad
# it is `fused_layer_norm` (the backward kernel on CUDA); else the
# forward with no graph.  So the CPU shows the routing the card takes.

@pytest.mark.parametrize("which", ["x", "gamma", "x_gamma_beta"])
def test_grad_requiring_input_gets_the_plain_versions_gradient(which):
    x, g, b = (torch.from_numpy(a) for a in _inputs(11, 128, seed=11))
    dy = torch.from_numpy(np.random.RandomState(12).randn(11, 128)
                          .astype(np.float32))
    want = [t.clone().requires_grad_(True) for t in (x, g, b)]
    layer_norm_reference(*want).backward(dy)
    got = [t.clone().requires_grad_(name in which)
           for name, t in zip(("x", "gamma", "beta"), (x, g, b))]
    y = layer_norm(*got)
    assert y.grad_fn is not None
    y.backward(dy)
    for name, t, w in zip(("x", "gamma", "beta"), got, want):
        if name in which:
            np.testing.assert_allclose(t.grad.numpy(), w.grad.numpy(),
                                       rtol=1e-4, atol=1e-4)
        else:
            assert t.grad is None


def test_no_graph_without_grad():
    x, g, b = (torch.from_numpy(a) for a in _inputs(5, 64, seed=13))
    xg = x.clone().requires_grad_(True)
    with torch.no_grad():
        assert layer_norm(xg, g, b).grad_fn is None
    assert layer_norm(x, g, b).grad_fn is None
