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
