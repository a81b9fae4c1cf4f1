"""Port parity: the norm/finite sweep (``apex_tpu_torch.ops.
grad_norm_finite``) against the JAX package's ``grad_norm_finite(...,
use_pallas=True, interpret=True)`` (its Pallas ``_norm_finite_pallas``
in CPU interpret mode), on the same numpy gradient buffers.

Buffers are fp16, bf16 and fp32, of lengths that are multiples of 128
(the JAX kernel asserts it), one group or three, at inv = 2^-16 with
gradients scaled as a 2^16 loss scale leaves them.  Tolerances: the
norm within 2e-6 relative of JAX's (fp32 sums of the same squares in
another order: against a float64 sum the JAX kernel in interpret mode
is off by up to 1.04e-6 at 129k bf16 elements, the port by 4e-8), and
within 2e-7 relative of the float64 sum; the finite flag exact.  A
planted +inf, -inf or NaN at the first, middle or last element gives
finite False on both sides.  A ragged length, which the JAX kernel
refuses, is held against the port's own plain version.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.ops.fused_pipeline import grad_norm_finite as jax_norm_finite
from apex_tpu_torch.ops import grad_norm_finite, grad_norm_finite_reference

INV = 2.0 ** -16
RTOL = 2e-6
TRUTH_RTOL = 2e-7
TORCH = {"float16": torch.float16, "bfloat16": torch.bfloat16,
         "float32": torch.float32}


def _bufs(dtype, sizes, seed):
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        g = jnp.asarray((rng.randn(n) * 0.01 / INV).astype(np.float32),
                        dtype)
        out.append(g)
    return out


def _to_torch(bufs):
    return [torch.from_numpy(np.array(b.astype(jnp.float32)))
            .to(TORCH[str(b.dtype)]) for b in bufs]


@pytest.mark.parametrize("sizes", [(128 * 300,), (128 * 7, 128 * 1000, 128)])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32"])
def test_norm_and_flag_match_jax_pallas(dtype, sizes):
    bufs = _bufs(jnp.dtype(dtype), sizes, seed=len(sizes))
    jn, jf = jax_norm_finite(bufs, INV, use_pallas=True, interpret=True)
    tb = _to_torch(bufs)
    tn, tf = grad_norm_finite(tb, INV)
    assert tn.dtype == torch.float32 and tf.dtype == torch.bool
    assert bool(tf) is bool(jf) is True
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    truth = np.sqrt(sum(float(((b.double() * INV) ** 2).sum()) for b in tb))
    np.testing.assert_allclose(float(tn), truth, rtol=TRUTH_RTOL)


@pytest.mark.parametrize("bad", [np.inf, -np.inf, np.nan])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_planted_nonfinite_matches_jax(bad, where):
    n = 128 * 50
    g = (np.random.RandomState(7).randn(n) * 100).astype(np.float16)
    g[{"first": 0, "middle": n // 2, "last": n - 1}[where]] = bad
    jn, jf = jax_norm_finite([jnp.asarray(g)], INV, use_pallas=True,
                             interpret=True)
    tn, tf = grad_norm_finite([torch.from_numpy(g)], INV)
    assert not bool(jf) and not bool(tf)
    # the norm is not finite either: inf for an inf, NaN for a NaN
    assert np.isnan(float(tn)) == np.isnan(float(jn)) == np.isnan(bad)
    assert not np.isfinite(float(tn))


def test_ragged_length_matches_plain_version():
    # the port's flat buffers are not padded to 128
    g = torch.from_numpy((np.random.RandomState(9).randn(1001) * 30)
                         .astype(np.float16))
    tn, tf = grad_norm_finite([g, g[:3].float()], 0.5)
    want = float(np.sqrt(((g.double() * 0.5) ** 2).sum()
                         + ((g[:3].double() * 0.5) ** 2).sum()))
    np.testing.assert_allclose(float(tn), want, rtol=TRUTH_RTOL)
    rn, rf = grad_norm_finite_reference([g, g[:3].float()], 0.5)
    assert bool(tf) and bool(rf) and float(tn) == float(rn)
    # no buffers: norm 0, finite
    zn, zf = grad_norm_finite([], 1.0)
    assert float(zn) == 0.0 and bool(zf)
